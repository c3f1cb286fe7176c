"""Slabs over the blocked path: each rank runs the port's CUDA kernels on
its own x-slab (torch counterpart of the plain-scene parts of
``taichi_mpm_tpu.parallel.spatial_blocked``).

* A rank simulates its slab in a LOCAL block-id frame shifted by one
  ghost block: local cell x = global x - offset, with a local SimConfig
  (``local_config``, or ``balanced_params``'s for load-balanced slabs).
  Positions stay global in the state; only the sort keys, the page map
  and the block origins live in the local frame, and the origin rows
  get the offset back (``pack_with_origins``), so the kernels see the
  single-device coordinates.
* After the halo merge, the two overlapping block columns at each slab
  boundary are summed by one exchange with each neighbour
  (``exchange_boundary_records``): both copies then hold the same sums,
  the grid update runs on both, and the windows need no second exchange.
* The sort is lazy, as on one device: the drift predicate is a value
  every rank agrees on (reduced with ``comm.all_max``), so all ranks
  take the same branches and meet in the same collectives. Particles
  migrate to their new owner at each re-sort (``spatial.migrate``).
* Load-balanced slabs (``r`` not None): block-column bounds within +-r
  of the uniform split, moved at most DMAX columns per re-sort towards
  equal counts, from the ranks' summed column histogram of the previous
  re-sort.
* Rigid bodies (CPIC, the JAX package's ``build_spatial_cpic_frame``,
  ``build_spatial_cpic_packed_frame`` and its balanced form): the bodies
  are replicated, each rank runs the rigid prologue on its copy and
  rasterizes the CDF into its grid window (``world_off``, the slab's
  offset), un-scatters its own near particles from its own records
  before the exchange, and applies the impulses summed over the ranks
  (``cpic_slab_substep``); the rigid page map is rebuilt every substep,
  as in the JAX package's slab frames.

``slab_frame`` is one host loop for both routes, both kinds of bounds
and plain or CPIC scenes, on slabs or on the pencils of a 2-D mesh (the
layout, ``Slabs`` here or ``spatial_mesh2d.Pencils``, supplies the
migration, the offsets, the exchange and the rebalance), with each JAX
frame's event sequence: a re-sort at every frame
start (rebalance, migration, local keys, the sort, the page map), then
substeps while the drift stays under 0.45 cell, and a re-sort when it
reaches 0.45, after a frame's last substep too. The fused route (the
JAX package's ``build_spatial_packed_frame``) adds the reduced max |v|
of each substep to the drift; the unfused route
(``build_spatial_blocked_frame``, ``build_spatial_balanced_frame``)
keeps each rank's sum and compares its max over the ranks. The page map
grows at the sort where its occupancy exceeds K, as on one device; a
rank's particle set grows where its arrivals exceed its free lanes
(``spatial.migrate``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core import transfer
from taichi_mpm_torch.core.levelset import DirichletRegion
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.ops import blocked, g2p, p2g, packed
from taichi_mpm_torch.ops.blocked import sort_particles_by_keys
from taichi_mpm_torch.ops.rows import NCH, RORG, RX
from taichi_mpm_torch.ops.substep import build_page_map_full, grid_update_flat, prep_p2g
from taichi_mpm_torch.parallel import comm
from taichi_mpm_torch.parallel.spatial import migrate, split_host
from taichi_mpm_torch.rigid.cpic_blocked import cpic_blocked_substep_presorted
from taichi_mpm_torch.rigid.cpic_packed import cpic_packed_substep_presorted
from taichi_mpm_torch.utils import const, host_read

GHOST_CELLS = 4  # one ghost block each side of a slab
MINW = 2  # least owned block columns of a balanced slab
DMAX = 2  # largest move of a bound per rebalance; <= MINW keeps migration one hop


# -- uniform slabs ---------------------------------------------------------------


def slab_cells(cfg: SimConfig, n_shards: int) -> int:
    if cfg.res[0] % (4 * n_shards):
        raise ValueError(f"res[0]={cfg.res[0]} must divide into whole blocks per slab "
                         f"(4*{n_shards}); pick a res[0] multiple of {4 * n_shards} or "
                         "balanced slabs")
    return cfg.res[0] // n_shards


def local_config(cfg: SimConfig, n_shards: int) -> SimConfig:
    """A uniform slab's config: the slab plus one ghost block each side."""
    Wc = slab_cells(cfg, n_shards)
    return dataclasses.replace(cfg, res=(Wc + 2 * GHOST_CELLS,) + cfg.res[1:], dx=cfg.dx)


def shard_offset_cells(s: int, cfg: SimConfig, n_shards: int) -> np.float32:
    """Global cell coordinate of local cell 0 of uniform slab s."""
    return np.float32(s * slab_cells(cfg, n_shards) - GHOST_CELLS)


def world_offset(off_cells, cfg: SimConfig) -> tuple:
    """The world position of a local frame's cell 0, three floats:
    `off_cells` (a slab's x offset, or a pencil's (x, y) pair, in cells)
    times dx in float32, 0 on the axes it leaves out."""
    offs = off_cells if isinstance(off_cells, tuple) else (off_cells,)
    w = tuple(float(np.float32(o) * np.float32(cfg.dx)) for o in offs)
    return w + (0.0,) * (3 - len(w))


def local_keys(p: Particles, off_cells, cfg: SimConfig, lcfg: SimConfig):
    """Local-frame block ids of global positions (the JAX package's
    ``_local_keys``, of slabs and of pencils), the sentinel for inactive
    lanes; `off_cells` as in ``world_offset``."""
    x_loc = p.x - const(world_offset(off_cells, cfg), torch.float32, p.device)
    total = blocked.total_blocks_padded(lcfg)
    return torch.where(p.active, blocked.block_id_of(x_loc, lcfg), total)


def _column_slots(pm, lcfg: SimConfig, col: int, dim: int = 0):
    """The slots of one local block plane across axis `dim` (K where
    inactive): of block column `col` along x, (nby, nbz), or of block row
    `col` along y over every x column, ghosts too, (nbx, nbz) (the JAX
    package's ``spatial_mesh2d._axis_planes``)."""
    nbx, nby, nbz = blocked.num_blocks_padded(lcfg)
    dev = pm["slot_map"].device
    bz = torch.arange(nbz, dtype=torch.int64, device=dev)[None, :]
    if dim == 0:
        by = torch.arange(nby, dtype=torch.int64, device=dev)[:, None]
        return pm["slot_map"][(col * nby + by) * nbz + bz].long()
    bx = torch.arange(nbx, dtype=torch.int64, device=dev)[:, None]
    return pm["slot_map"][(bx * nby + col) * nbz + bz].long()


def _boundary_planes(rec, pm, lcfg: SimConfig, cols, dim: int = 0):
    """The records of the local block planes `cols` across axis `dim` as
    dense planes (len(cols), ..., 256), zeros where a block is inactive."""
    K = pm["ids"].shape[0]
    planes = []
    for col in cols:
        slot = _column_slots(pm, lcfg, col, dim)
        ok = slot < K
        planes.append(torch.where(ok[..., None], rec[torch.clamp(slot, max=K - 1)], 0.0))
    return torch.stack(planes, 0)


def _add_to_column(rec, pm, lcfg: SimConfig, col: int, values, dim: int = 0):
    """rec[slot] += values at the live blocks of local plane `col` across
    axis `dim`, in place and without a host sync: an inactive block adds
    0 to slot K - 1 (each live block holds one slot, so no two nonzero
    adds meet)."""
    K = pm["ids"].shape[0]
    slot = _column_slots(pm, lcfg, col, dim)
    ok = (slot < K)[..., None]
    rec.index_add_(0, torch.clamp(slot, max=K - 1).flatten(),
                   torch.where(ok, values, 0.0).reshape(-1, rec.shape[1]))
    return rec


def _add_planes(rec, pm, lcfg: SimConfig, cols, planes, dim: int = 0):
    """Add incoming planes into the live blocks of planes `cols` across
    axis `dim`, in place."""
    for i, col in enumerate(cols):
        rec = _add_to_column(rec, pm, lcfg, col, planes[i], dim)
    return rec


def exchange_boundary_records(rec, pm, lcfg: SimConfig, Wb: int):
    """Symmetric sum of the two overlapping block columns of each slab
    boundary: local columns {Wb, Wb + 1} of a rank are columns {0, 1} of
    its right neighbour. Both copies get the same sum a + b."""
    lo_cols, hi_cols = (0, 1), (Wb, Wb + 1)
    lo = _boundary_planes(rec, pm, lcfg, lo_cols)
    hi = _boundary_planes(rec, pm, lcfg, hi_cols)
    from_left, from_right = comm.neighbour_exchange(lo, hi)
    rec = _add_planes(rec, pm, lcfg, lo_cols, from_left)
    return _add_planes(rec, pm, lcfg, hi_cols, from_right)


def exchange_nothing(lcfg: SimConfig, device):
    """The record exchange of a rank that has no records this time (a
    bucket advance whose context is empty on this rank): zero planes sent
    both ways and what arrives dropped, so the neighbours' exchanges pair
    up and add zeros, as the JAX package's empty mini-state sends."""
    _, nby, nbz = blocked.num_blocks_padded(lcfg)
    zeros = torch.zeros((2, nby, nbz, 4 * blocked.BLOCK ** 3), dtype=torch.float32,
                        device=device)
    comm.neighbour_exchange(zeros, zeros)


def zero_domain_edge_ghosts(rec, pm, lcfg: SimConfig, s: int, dim: int = 0):
    """Rank 0's low ghost column lies outside the domain, where one device
    has no nodes: its records become 0 (NaN where not finite, as the JAX
    package's product with 0 gives), in place, by adding their negation.
    On a pencil mesh, the low ghost plane across axis `dim` of a pencil
    at index `s` = 0 along it (``_zero_edge_ghosts``)."""
    if s != 0:
        return rec
    return _add_to_column(rec, pm, lcfg, 0, -_boundary_planes(rec, pm, lcfg, (0,), dim)[0], dim)


def shifted_colliders(colliders, xoff):
    """Colliders evaluated at x + (xoff, 0, 0), or x + xoff where `xoff`
    is a 3-tuple (a pencil's offset): the grid update runs in local node
    coordinates. Level-set colliders only, as in the JAX package (whose
    ``shifted_colliders`` fails on a DirichletRegion)."""
    off = xoff if isinstance(xoff, tuple) else (xoff, 0.0, 0.0)
    out = []
    for c in colliders:
        if isinstance(c, DirichletRegion):
            raise ValueError("a DirichletRegion is not supported on slabs")

        def shift(fn):
            if fn is None:
                return None
            return lambda x, t: fn(x + const(off, x.dtype, x.device), t)

        out.append(dataclasses.replace(c, sdf=shift(c.sdf), normal_fn=shift(c.normal_fn),
                                       velocity=shift(c.velocity)))
    return tuple(out)


# -- load-balanced slabs -------------------------------------------------------------


def uniform_bounds(cfg: SimConfig, n_shards: int, dim: int = 0):
    """The uniform split of the block columns along axis `dim`."""
    return np.round(np.linspace(0.0, cfg.res[dim] // 4, n_shards + 1)).astype(np.int32)


def max_radius(cfg: SimConfig, n_shards: int, dim: int = 0) -> int:
    """The largest balance radius the grid allows along axis `dim` (< 1:
    none, uniform slabs only): each slab or pencil keeps MINW block
    columns."""
    if cfg.res[dim] % 4:
        return 0
    gaps = np.diff(uniform_bounds(cfg, n_shards, dim))
    return (int(gaps.min()) - MINW) // 2


def balanced_params(cfg: SimConfig, n_shards: int, r: int):
    """(CB, uniform bounds, local config) of balanced slabs with
    largest shift r: the local frame holds the widest slab, 2r wider
    than the widest uniform one, plus a ghost block each side."""
    r_max = max_radius(cfg, n_shards)
    if not 0 < r <= r_max:
        raise ValueError(f"balance radius r={r} must be in [1, {r_max}] for "
                         f"res[0]={cfg.res[0]}, n_shards={n_shards}")
    u = uniform_bounds(cfg, n_shards)
    maxw = int(np.diff(u).max()) + 2 * r
    lcfg = dataclasses.replace(cfg, res=((maxw + 2) * 4,) + cfg.res[1:])
    return cfg.res[0] // 4, u, lcfg


def rebalance_bounds(hist, bounds, uniform, r: int, n_shards: int):
    """New bounds (host int32) from the global column histogram: the equal
    count split, moved at most DMAX from the old bounds and kept within r
    of the uniform ones; the old bounds where the histogram is empty. The
    JAX package's float32 arithmetic (cumulative counts are exact below
    2^24 particles)."""
    c = np.cumsum(np.asarray(hist, np.float32), dtype=np.float32)
    total = c[-1]
    q = np.arange(1, n_shards, dtype=np.float32) * total / np.float32(n_shards)
    ideal = np.searchsorted(c, q, side="left").astype(np.int32) + 1
    bounds = np.asarray(bounds, np.int32)
    uniform = np.asarray(uniform, np.int32)
    old = bounds[1:-1]
    new = np.clip(ideal, old - DMAX, old + DMAX)
    new = np.clip(new, uniform[1:-1] - r, uniform[1:-1] + r)
    new = np.where(total > 0, new, old)
    return np.concatenate([bounds[:1], new, bounds[-1:]]).astype(np.int32)


def col_hist_from_pm(pm, b0: int, lcfg: SimConfig, CB: int):
    """Particles per global block column, summed over the ranks, from the
    page map's slot ranges (K-sized, not P-sized); `b0` is the rank's
    first owned column."""
    _, nby, nbz = blocked.num_blocks_padded(lcfg)
    counts = (pm["e_arr"] - pm["s_arr"]).to(torch.int32)
    gcol = torch.div(pm["ids"], nby * nbz, rounding_mode="floor") - 1 + int(b0)
    hist = torch.zeros((CB,), dtype=torch.int32, device=counts.device)
    hist.index_add_(0, torch.clamp(gcol, 0, CB - 1).long(), counts)
    return comm.all_sum(hist)


def dest_from_bounds(x, bounds, cfg: SimConfig, n_shards: int, dim: int = 0):
    """The owner of each position's block column under `bounds` (block
    columns along axis `dim`)."""
    cx = torch.clamp(torch.floor(x[:, dim] * cfg.inv_dx).to(torch.int64), 0, cfg.res[dim] - 1)
    b = torch.as_tensor(np.asarray(bounds, np.int64), device=x.device)
    col = torch.div(cx, 4, rounding_mode="floor")
    return torch.clamp(torch.searchsorted(b, col, right=True) - 1, 0, n_shards - 1)


def _host_columns(p: Particles, cfg: SimConfig):
    x = p.x[:, 0].cpu().numpy()
    return np.clip((x / cfg.dx).astype(np.int64), 0, cfg.res[0] - 1) // 4


def balanced_bounds_host(p: Particles, cfg: SimConfig, n_shards: int, r: int):
    """Initial bounds on the host: the equal-count split of the rebalance,
    without its DMAX rate limit (float64, as the JAX package's)."""
    CB, u, _ = balanced_params(cfg, n_shards, r)
    col = _host_columns(p, cfg)[p.active.cpu().numpy()]
    c = np.cumsum(np.bincount(col, minlength=CB).astype(np.float64))
    q = np.arange(1, n_shards) * c[-1] / n_shards
    ideal = np.searchsorted(c, q, side="left").astype(np.int32) + 1
    new = np.clip(ideal, u[1:-1] - r, u[1:-1] + r)
    if c[-1] <= 0:
        new = u[1:-1]
    return np.concatenate([u[:1], new, u[-1:]]).astype(np.int32)


def shard_spatially_bounds(p: Particles, cfg: SimConfig, n_shards: int, rank: int, bounds,
                           slack: float = 1.0):
    """This rank's slab under block-column `bounds` (the JAX package's
    ``shard_spatially_bounds``). Returns (Particles, local capacity)."""
    slab = np.clip(np.searchsorted(np.asarray(bounds, np.int64), _host_columns(p, cfg),
                                   side="right") - 1, 0, n_shards - 1)
    return split_host(p, slab, n_shards, rank, slack)


# -- one rank's slab ----------------------------------------------------------------


class Slabs:
    """The static layout of one rank's slab: uniform (r None) or balanced
    with radius r; ``lcfg`` the local config, ``CB`` the block columns,
    ``uniform`` the uniform bounds. The frame loop (``slab_frame``) asks
    it, or a ``spatial_mesh2d.Pencils``, for the migration, the offsets,
    the exchange and the rebalance; `bounds` is the host int32 bounds, or
    None on uniform slabs."""

    def __init__(self, cfg: SimConfig, n_shards: int, rank: int, r: Optional[int] = None):
        self.cfg, self.n_shards, self.rank, self.r = cfg, n_shards, rank, r
        if r is None:
            self.lcfg = local_config(cfg, n_shards)
            self.CB = self.uniform = None
        else:
            self.CB, self.uniform, self.lcfg = balanced_params(cfg, n_shards, r)

    @property
    def balanced(self) -> bool:
        return self.r is not None

    def off_cells(self, bounds) -> np.float32:
        """Global cell coordinate of the slab's local cell 0."""
        if self.balanced:
            return np.float32((int(bounds[self.rank]) - 1) * 4)
        return shard_offset_cells(self.rank, self.cfg, self.n_shards)

    def width(self, bounds) -> int:
        """Block columns the rank owns."""
        if self.balanced:
            return int(bounds[self.rank + 1]) - int(bounds[self.rank])
        return slab_cells(self.cfg, self.n_shards) // 4

    def xoff(self, bounds) -> float:
        return float(self.off_cells(bounds) * np.float32(self.cfg.dx))

    def world_off(self, bounds) -> tuple:
        """The world position of local cell 0 (the CPIC hooks' `world_off`)."""
        return (self.xoff(bounds), 0.0, 0.0)

    def origin_shift(self, bounds) -> tuple:
        """What the local block origins get to be global, in cells."""
        return (float(self.off_cells(bounds)), 0.0, 0.0)

    def grid_colliders(self, colliders, bounds):
        return shifted_colliders(colliders, self.xoff(bounds))

    def rebalance(self, hist, bounds):
        """The bounds of the next re-sort (balanced slabs), from the
        histogram of the last."""
        if not self.balanced:
            return bounds
        return rebalance_bounds(host_read(hist), bounds, self.uniform, self.r, self.n_shards)

    def migrate(self, p: Particles, bounds, stats: "SlabStats") -> Particles:
        """Each particle to its slab's rank (``spatial.migrate``), counted
        in `stats`."""
        dest = dest_from_bounds(p.x, bounds, self.cfg, self.n_shards) if self.balanced else None
        t0 = stats.clock(p.device)
        p, mig = migrate(p, self.cfg, self.n_shards, dest)
        stats.migrate_s += stats.clock(p.device) - t0
        stats.sent_left += mig.sent_left
        stats.sent_right += mig.sent_right
        stats.arrived += mig.arrived
        stats.grown += mig.grown
        return p

    def hist(self, pm, bounds):
        """The column histogram summed over the ranks (balanced slabs)."""
        return col_hist_from_pm(pm, bounds[self.rank], self.lcfg, self.CB)

    def bounds_record(self, bounds) -> tuple:
        return tuple(int(b) for b in bounds)

    def exchange(self, rec, pm, bounds):
        """The record exchange, then rank 0's out-of-domain ghosts zeroed."""
        rec = exchange_boundary_records(rec, pm, self.lcfg, self.width(bounds))
        return zero_domain_edge_ghosts(rec, pm, self.lcfg, self.rank)


@dataclasses.dataclass
class SlabStats:
    """What slab frames did on this rank: substeps, re-sorts (and the
    substep count each one followed), migrants sent and received, lanes
    added, the bounds after each re-sort, on CPIC scenes the largest near
    sets (exact and coarse) and rigid page map of this rank's slab, and,
    where ``timed`` (a device sync around each exchange, migration and
    impulse sum), the seconds spent in them. On a pencil mesh
    ``sent_left`` and ``sent_right`` count the x round of each re-sort,
    ``sent_low_y`` and ``sent_high_y`` its y round, ``arrived`` and
    ``grown`` both, and ``diagonal`` (a 0-d device tensor, read when
    asked) the particles sent that moved on both axes."""

    timed: bool = False
    substeps: int = 0
    resorts: int = 0
    resort_after: List[int] = dataclasses.field(default_factory=list)
    sent_left: int = 0
    sent_right: int = 0
    sent_low_y: int = 0
    sent_high_y: int = 0
    diagonal: object = 0
    arrived: int = 0
    grown: int = 0
    bounds: List[tuple] = dataclasses.field(default_factory=list)
    n_near: int = 0
    n_coarse: int = 0
    n_r: int = 0
    exchange_s: float = 0.0
    migrate_s: float = 0.0
    impulse_sum_s: float = 0.0

    def clock(self, device) -> float:
        if self.timed and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()


@dataclasses.dataclass
class SlabCarry:
    """A rank's state between frames: its particles (the packed state on
    the fused route, a Particles set on the unfused one), the bounds
    (host int32, a pair of them on pencils; None where uniform), the
    column histogram of the last re-sort (balanced), the page-map
    capacity K, and on a CPIC scene the rigid bodies, replicated: every
    rank holds them whole, in the same bits."""

    state: object
    bounds: Optional[np.ndarray]
    hist: Optional[torch.Tensor]
    K: int
    bodies: object = None


def _page_map(build, keys, lcfg: SimConfig, K: int):
    pm = build(keys, lcfg, K)
    n_act = int(pm["n_act"])
    if n_act > K:
        pm = build(keys, lcfg, packed.grown_capacity(n_act, lcfg))
    return pm


def pack_with_origins(p: Particles, keys, off_cells, lcfg: SimConfig, K: int):
    """The packed state of a locally sorted set with its origin rows in
    global grid units (local block origin + the slab's offset, or a
    pencil's (x, y) pair), and its local page map (the JAX package's
    ``_pack_with_origins``)."""
    st = packed.pack_particles(p)
    org = packed.origin_rows(keys, lcfg)
    for d, off in enumerate(off_cells if isinstance(off_cells, tuple) else (off_cells,)):
        org[d] += float(off)
    st[RORG: RORG + 3] = org
    return st, _page_map(packed.build_page_map_packed, keys, lcfg, K)


def resort(carry: SlabCarry, slabs, fused: bool, stats: SlabStats):
    """Rebalance (balanced bounds), migrate, local keys, sort, page map,
    on the layout `slabs` (``Slabs`` or ``spatial_mesh2d.Pencils``).
    Returns (state, local keys, pm, bounds, hist)."""
    cfg, lcfg = slabs.cfg, slabs.lcfg
    state, bounds, hist = carry.state, carry.bounds, carry.hist
    p = packed.unpack_particles(state, state.shape[1]) if fused else state
    bounds = slabs.rebalance(hist, bounds)
    p = slabs.migrate(p, bounds, stats)
    off = slabs.off_cells(bounds)
    keys = local_keys(p, off, cfg, lcfg)
    p, keys, _ = sort_particles_by_keys(p, keys)
    if fused:
        state, pm = pack_with_origins(p, keys, off, lcfg, carry.K)
    else:
        state, pm = p, _page_map(build_page_map_full, keys, lcfg, carry.K)
    if slabs.balanced:
        hist = slabs.hist(pm, bounds)
        stats.bounds.append(slabs.bounds_record(bounds))
    stats.resorts += 1
    stats.resort_after.append(stats.substeps)
    return state, keys, pm, bounds, hist


def record_exchange(pm, slabs, bounds, stats: SlabStats):
    """The substep's boundary hook: the layout's record exchange and the
    out-of-domain ghosts zeroed (``Slabs.exchange``), timed in `stats`."""

    def exchange(rec):
        t0 = stats.clock(rec.device)
        rec = slabs.exchange(rec, pm, bounds)
        stats.exchange_s += stats.clock(rec.device) - t0
        return rec

    return exchange


def spatial_blocked_substep_presorted(p: Particles, pm, t, slabs, bounds, colliders, dt,
                                      stats: SlabStats):
    """One unfused substep of a locally sorted slab against its frozen page
    map (the JAX package's ``spatial_blocked_substep_presorted``): the
    operand prep (``ops.substep.prep_p2g``, origins + the slab offset),
    ``p2g_blocked``, the merge, the exchange, the grid update in the local
    frame, the windows, ``g2p_blocked`` and ``transfer.g2p_finish`` with
    the global clamp. Like the JAX package's, it runs neither the
    per-particle collision nor the boundary clean-up. Returns (p, t + dt,
    vmax, plast) with vmax and plast 0-d device tensors."""
    cfg, lcfg = slabs.cfg, slabs.lcfg
    n = p.capacity
    origin = pm["origin"] + const(slabs.origin_shift(bounds), torch.float32, p.device)
    pdata = prep_p2g(p, None, cfg, dt, origin=origin)
    tiles = p2g.p2g_blocked(pm["s_arr"], pm["e_arr"], pdata)
    del pdata
    rec = blocked.merge_tiles(tiles, pm["nbr"])
    del tiles
    rec = record_exchange(pm, slabs, bounds, stats)(rec)
    vrec = grid_update_flat(rec, pm["ids"], lcfg, slabs.grid_colliders(colliders, bounds), t, dt)
    win = blocked.windows(vrec, pm["nbr"])
    rows = torch.zeros((NCH, n), dtype=torch.float32, device=p.device)
    rows[RX: RX + 3] = p.x.t()
    rows[RORG: RORG + 3] = origin.t()
    pout = g2p.g2p_blocked(pm["slot_keys"], rows, win, cfg)
    act = p.active
    v_new = torch.where(act[:, None], pout[0:3].t(), 0.0)
    b_new = torch.where(act[:, None, None], pout[3:12].t().reshape(n, 3, 3), 0.0)
    p, plast = transfer.g2p_finish(p, v_new, b_new, cfg, dt, return_count=True)
    vmax = torch.amax(torch.where(p.active[:, None], torch.abs(p.v), 0.0))
    return p, np.float32(t) + np.float32(dt), vmax, plast


def _impulse_sum(stats: SlabStats):
    """The CPIC substep's ``sum_fn``: the ranks' impulses summed by one
    all-reduce (``comm.all_sum``). The backends' all-reduce hands every
    rank the same sum (each element is reduced once and the result sent
    to all), so the replicated bodies stay equal in bits on every rank;
    with two ranks the sum a + b is also the same whichever way it is
    taken. With more ranks its order is the backend's, fixed for a given
    group, so a rerun on the same group gives the same bits."""

    def total(x):
        t0 = stats.clock(x.device)
        out = comm.all_sum(x)
        stats.impulse_sum_s += stats.clock(x.device) - t0
        return out

    return total


def cpic_slab_substep(carry: SlabCarry, state, pm, t, slabs, dt, fused: bool, scene, caps,
                      stats: SlabStats):
    """One coupled substep of this rank's slab (the substeps of the JAX
    package's ``build_spatial_cpic_packed_frame``, its balanced form and
    ``build_spatial_cpic_frame``): the packed CPIC substep on the fused
    route, the pytree one on the unfused, with the slab's hooks. The
    bodies in `carry` are replaced by the advanced ones. Returns (state,
    t + dt, vmax, plast)."""
    bounds = carry.bounds
    hooks = dict(lcfg=slabs.lcfg,
                 world_off=const(slabs.world_off(bounds), torch.float32, pm["ids"].device),
                 grid_colliders=slabs.grid_colliders(scene.colliders, bounds),
                 exchange_fn=record_exchange(pm, slabs, bounds, stats), sum_fn=_impulse_sum(stats))
    if fused:
        out = cpic_packed_substep_presorted(state, pm, carry.bodies, t, slabs.cfg, scene, dt, caps,
                                            **hooks)
    else:
        origin = pm["origin"] + const(slabs.origin_shift(bounds), torch.float32, state.device)
        out = cpic_blocked_substep_presorted(state, pm, carry.bodies, t, slabs.cfg, scene, dt,
                                             caps, origin=origin, **hooks)
    (state, carry.bodies, t), n_near, n_coarse, n_r, vmax, plast = out
    stats.n_near = max(stats.n_near, n_near)
    stats.n_coarse = max(stats.n_coarse, n_coarse)
    stats.n_r = max(stats.n_r, n_r)
    return state, t, vmax, plast


def slab_frame(carry: SlabCarry, t, slabs, colliders, dt, n_substeps: int,
               fused: bool = True, stats: Optional[SlabStats] = None, scene=None, caps=None):
    """One fixed-dt frame of this rank's slab (module docstring): a
    re-sort, then n_substeps substeps with the lazy re-sort. Every rank
    calls it together. One host read per substep: the drift reduced over
    the ranks. Returns (carry, t, plast) with plast this rank's plastic
    events as a 0-d tensor; `stats` (a SlabStats) gathers the frame's
    events.

    With a rigid scene (`scene`, the ``rigid.scene.RigidScene``, and
    `caps`, its ``cpic_packed.Capacities``) it is a CPIC frame
    (``cpic_slab_substep``), the bodies in ``carry.bodies``: the JAX
    package's packed CPIC frame on the fused route, on uniform or
    balanced bounds, and its pytree CPIC frame on the unfused route,
    where the driver keeps the bounds uniform. Each substep adds two
    impulse all-reduces; the CPIC substep's own host reads (the near
    set's sizes, the rigid map's occupancy, the bodies for the host's
    solves) are per rank and decide no collective."""
    stats = SlabStats() if stats is None else stats
    state, _, pm, bounds, hist = resort(carry, slabs, fused, stats)
    carry = SlabCarry(state, bounds, hist, pm["ids"].shape[0], carry.bodies)
    dev = state.device
    step = np.float32(dt * slabs.cfg.inv_dx)
    step_t = torch.tensor(step, device=dev)
    drift = np.float32(0.0)
    local = torch.zeros((), dtype=torch.float32, device=dev)  # this rank's sum (unfused)
    plast = torch.zeros((), dtype=torch.int64, device=dev)
    n = 0
    while n < n_substeps or drift >= packed.DRIFT_BOUND:
        while n < n_substeps and drift < packed.DRIFT_BOUND:
            if scene is not None:
                state, t, vmax, dplast = cpic_slab_substep(carry, state, pm, t, slabs, dt, fused,
                                                           scene, caps, stats)
            elif fused:
                gcolls = slabs.grid_colliders(colliders, bounds)
                (state, t), _, vmax, dplast = packed.fused_substep_presorted(
                    state, pm, t, slabs.cfg, colliders, dt, gcfg=slabs.lcfg,
                    grid_colliders=gcolls, exchange_fn=record_exchange(pm, slabs, bounds, stats))
            else:
                state, t, vmax, dplast = spatial_blocked_substep_presorted(
                    state, pm, t, slabs, bounds, colliders, dt, stats)
            if fused:
                drift = drift + step * np.float32(host_read(comm.all_max(vmax)))
            else:
                local = local + step_t * vmax
                drift = np.float32(host_read(comm.all_max(local)))
            plast += dplast
            n += 1
            stats.substeps += 1
        if drift >= packed.DRIFT_BOUND:
            carry.state = state
            state, _, pm, bounds, hist = resort(carry, slabs, fused, stats)
            carry = SlabCarry(state, bounds, hist, pm["ids"].shape[0], carry.bodies)
            drift = np.float32(0.0)
            local = torch.zeros_like(local)
    carry.state = state
    return carry, t, plast
