"""Packed channel-major particle pipeline: the blocked frames at fixed
and at global adaptive dt (torch counterpart of
``taichi_mpm_tpu.ops.packed``).

The particle state is one ``(NCH, Pw)`` float32 tensor (row map in
``ops/rows.py``), sorted by grid block. One substep on the fused route
(the default) is

    p2g_fused (kernel) -> merge_tiles -> grid_update_flat -> windows
    -> g2p_fused (kernel, in place) [-> particle collision, clean boundary]

and on the unfused route (``fused=False``, the JAX package's
``TMT_FUSED=0``)

    prep_packed -> p2g_blocked (kernel) -> merge_tiles -> grid_update_flat
    -> windows -> g2p_blocked (kernel) -> finish_packed [-> ...]

A frame repeats it, re-sorting lazily: the sort and page map are kept
while the accumulated drift ``sum(dt * inv_dx * max|v|)`` stays below
0.45 cell, so every particle stays within half a cell of its sort-time
block (whose origin is in rows 43-45) and inside its slot's halo tile.
The drift check reads max |v| on the host: one device-to-host sync per
substep. An adaptive frame (``AdaptiveDt``) reads the next dt limit in
the same sync; its dt is a float32 scalar on the host, passed to the
kernels by value.

The JAX package carries the state in two forms (flat and 2-D) for its
TPU layouts; the port has one, so ``pack_carry`` takes no form.

The specifications the kernels follow, ``prep_packed`` and
``finish_packed``, live beside them in ``ops/p2g.py`` and ``ops/g2p.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.levelset import DirichletRegion
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.materials import cforms
from taichi_mpm_torch.ops import blocked, g2p, p2g
from taichi_mpm_torch.ops.blocked import BLOCK
from taichi_mpm_torch.ops.substep import grid_update_flat
from taichi_mpm_torch.ops.rows import (
    RACT, RAUX, RBDIST, RBN, RC, RF, RMASS, RMAT, RMATF, RNEARB, RORG, RPAR,
    RSTATES, RV, RVOL, RX,
)
from taichi_mpm_torch.utils import host_read

DRIFT_BOUND = np.float32(0.45)  # cells of drift allowed between sorts


# -- conversions ------------------------------------------------------------


def pack_particles(p: Particles) -> torch.Tensor:
    """Particles -> (NCH, P) channel-major state (int rows bitcast)."""
    P = p.capacity
    zero = torch.zeros((P,), dtype=torch.float32, device=p.device)
    rows = [p.x[:, k] for k in range(3)]
    rows += [p.v[:, k] for k in range(3)]
    rows += [p.F[:, i, j] for i in range(3) for j in range(3)]
    rows += [p.C[:, i, j] for i in range(3) for j in range(3)]
    rows += [p.aux, p.mass, p.vol, p.mat.view(torch.float32)]
    rows += [p.params[:, k] for k in range(8)]
    rows += [p.active.to(torch.float32), p.states.view(torch.float32), p.bdist]
    rows += [p.bnormal[:, k] for k in range(3)]
    rows += [p.near_b.to(torch.float32)]
    rows += [zero] * (RMATF - len(rows))
    rows += [p.mat.to(torch.float32)]  # row 47: material id as a value
    return torch.stack(rows)


def unpack_particles(st: torch.Tensor, capacity: int) -> Particles:
    """Packed state -> Particles (lanes in the state's order)."""

    def s(r):
        return st[r, :capacity].clone()

    def ints(r):
        return st[r, :capacity].view(torch.int32).clone()

    def m33(r0):
        return st[r0 : r0 + 9, :capacity].t().reshape(capacity, 3, 3).clone()

    return Particles(
        x=st[RX : RX + 3, :capacity].t().clone(),
        v=st[RV : RV + 3, :capacity].t().clone(),
        F=m33(RF),
        C=m33(RC),
        aux=s(RAUX),
        mass=s(RMASS),
        vol=s(RVOL),
        mat=ints(RMAT),
        params=st[RPAR : RPAR + 8, :capacity].t().clone(),
        active=st[RACT, :capacity] > 0.5,
        states=ints(RSTATES),
        bdist=s(RBDIST),
        bnormal=st[RBN : RBN + 3, :capacity].t().clone(),
        near_b=st[RNEARB, :capacity] > 0.5,
    )


# -- sort + page map --------------------------------------------------------


def _keys_of(st, cfg: SimConfig):
    """Padded block id per lane (sentinel = total for inactive lanes)."""
    nbp = blocked.num_blocks_padded(cfg)
    total = blocked.total_blocks_padded(cfg)
    act = st[RACT] > 0.5
    bid = torch.zeros(st.shape[1], dtype=torch.int32, device=st.device)
    for k, n in enumerate(nbp):
        cell = torch.clamp(torch.floor(st[RX + k] * cfg.inv_dx), 0, cfg.res[k] - 1)
        bid = bid * n + cell.to(torch.int32) // BLOCK
    return torch.where(act, bid, total)


def sort_packed(st, cfg: SimConfig):
    """Stable sort of the lanes by block id: a column gather of the whole
    (NCH, Pw) state. Returns (sorted state, sorted keys)."""
    keys = _keys_of(st, cfg)
    keys_sorted, order = torch.sort(keys, stable=True)
    return st[:, order], keys_sorted


def origin_rows(keys, cfg: SimConfig):
    """Padded block id -> block origin (grid units) per lane, (3, Pw)."""
    nbx, nby, nbz = blocked.num_blocks_padded(cfg)
    safe = torch.clamp(keys, max=nbx * nby * nbz - 1)
    bz = safe % nbz
    by = (safe // nbz) % nby
    bx = safe // (nbz * nby)
    return torch.stack([bx, by, bz]).to(torch.float32) * float(BLOCK)


def annotate_origins(st, keys, cfg: SimConfig):
    """Write rows 43-45 = each lane's sort-time block origin, in place."""
    st[RORG : RORG + 3] = origin_rows(keys, cfg)
    return st


def build_page_map_packed(keys, cfg: SimConfig, K: int):
    """Page map, neighbour table and per-lane slot keys."""
    total = blocked.total_blocks_padded(cfg)
    ids, n_act, slot_map, s_arr, e_arr = blocked.build_page_map(keys, cfg, K)
    nbr = blocked.neighbor_slots(ids, slot_map, cfg)
    slot_keys = slot_map[torch.clamp(keys, max=total).long()]
    return dict(ids=ids, n_act=n_act, s_arr=s_arr, e_arr=e_arr, nbr=nbr,
                slot_keys=slot_keys, slot_map=slot_map)


def grown_capacity(n_act: int, cfg: SimConfig) -> int:
    """Page-map capacity after an overflow: 2x the occupancy, rounded up
    to a multiple of 64, at most the whole padded block space."""
    return int(min(blocked.total_blocks_padded(cfg), -(-2 * n_act // 64) * 64))


def sort_and_map(st, cfg: SimConfig, K: int):
    """Sort + origin annotation + page map: the one (re)sort entry.

    Growth on overflow happens here, where the occupancy is known: if
    the dilated occupancy exceeds K, the page map is rebuilt at once with
    a larger K. (The JAX driver instead re-runs the whole frame with a
    larger K. The G2P kernel here updates the state in place, so a re-run
    would need a saved copy of the state; growing at the sort gives the
    same frame without one, because K only sizes the map: the live slots,
    ranges and neighbours do not depend on it.) The capacity in use is
    pm["ids"].shape[0]."""
    st, keys = sort_packed(st, cfg)
    st = annotate_origins(st, keys, cfg)
    pm = build_page_map_packed(keys, cfg, K)
    n_act = int(pm["n_act"])
    if n_act > K:
        pm = build_page_map_packed(keys, cfg, grown_capacity(n_act, cfg))
    return st, keys, pm


# -- per-particle boundary passes ---------------------------------------------


def clean_boundary_packed(st, cfg: SimConfig):
    """Deactivate lanes within 7 cells of the domain edge, in place."""
    act = st[RACT] > 0.5
    near = torch.zeros_like(act)
    for k in range(3):
        pos = st[RX + k] * cfg.inv_dx
        near = near | (pos < 7.0) | (pos > cfg.res[k] - 7.0)
    st[RACT] = (act & ~near).to(torch.float32)
    return st


def particle_collision_packed(st, cfg: SimConfig, colliders, t):
    """Per-particle levelset projection on rows, in place."""
    act = st[RACT] > 0.5
    x = [st[RX + k] for k in range(3)]
    v = [st[RV + k] for k in range(3)]
    xg = torch.stack(x, -1)
    for c in colliders:
        if isinstance(c, DirichletRegion):
            continue
        phi = c.sdf(xg, t)
        grad = c.normal(xg, t, eps=0.5 * cfg.dx)
        hit = act & (phi < 0.0)
        g = [grad[..., k] for k in range(3)]
        x = [torch.where(hit, xi - gi * phi, xi) for xi, gi in zip(x, g)]
        vn = sum(gi * vi for gi, vi in zip(g, v))
        v = [torch.where(hit, vi - vn * gi, vi) for vi, gi in zip(v, g)]
        xg = torch.stack(x, -1)
    st[RX : RX + 3] = torch.stack(x)
    st[RV : RV + 3] = torch.stack(v)
    return st


# -- the substep / frame ------------------------------------------------------


def fused_substep_presorted(st, pm, t, cfg: SimConfig, colliders, dt, gcfg: SimConfig = None,
                            grid_colliders=None, exchange_fn=None):
    """One substep on a sorted state (origins annotated by sort_and_map);
    `st` is updated in place. Returns ((st, t + dt), n_act, vmax, plast)
    with vmax and plast as 0-d device tensors.

    The slab frames' hooks (``parallel.spatial_blocked``): `gcfg` is the
    slab's local grid config, which the grid update decodes block ids
    with (positions and the origin rows stay global, so the kernels need
    no hook); `grid_colliders` are the colliders shifted into that local
    frame; `exchange_fn(rec)` sums the slab-boundary records between the
    merge and the grid update."""
    tiles = p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg)
    rec = blocked.merge_tiles(tiles, pm["nbr"])
    if exchange_fn is not None:
        rec = exchange_fn(rec)
    vrec = grid_update_flat(rec, pm["ids"], gcfg or cfg,
                            colliders if grid_colliders is None else grid_colliders, t, dt)
    win = blocked.windows(vrec, pm["nbr"])
    vmax, plast = g2p.g2p_fused(pm["slot_keys"], st, win, dt, cfg)
    if cfg.particle_collision:
        particle_collision_packed(st, cfg, colliders, t)
    if cfg.clean_boundary:
        clean_boundary_packed(st, cfg)
    return (st, np.float32(t) + np.float32(dt)), pm["n_act"], vmax, plast


def packed_substep_presorted(st, pm, t, cfg: SimConfig, colliders, dt, fused: bool = True):
    """One substep against a frozen sort and page map. fused=True is
    ``fused_substep_presorted``; fused=False the unfused pipeline of the
    JAX package's ``TMT_FUSED=0`` route: prep_packed -> p2g_blocked
    (kernel) -> merge -> grid update -> windows -> g2p_blocked (kernel)
    -> finish_packed [-> particle collision, clean boundary], which
    returns a new state. Returns ((st, t + dt), n_act, vmax, plast)."""
    if fused:
        return fused_substep_presorted(st, pm, t, cfg, colliders, dt)
    pdata = p2g.prep_packed(st, cfg, dt)
    tiles = p2g.p2g_blocked(pm["s_arr"], pm["e_arr"], pdata)
    del pdata
    rec = blocked.merge_tiles(tiles, pm["nbr"])
    del tiles
    vrec = grid_update_flat(rec, pm["ids"], cfg, colliders, t, dt)
    win = blocked.windows(vrec, pm["nbr"])
    pout = g2p.g2p_blocked(pm["slot_keys"], st, win, cfg)
    st, vmax, plast = g2p.finish_packed(st, pout, cfg, dt)
    if cfg.particle_collision:
        particle_collision_packed(st, cfg, colliders, t)
    if cfg.clean_boundary:
        clean_boundary_packed(st, cfg)
    return (st, np.float32(t) + np.float32(dt)), pm["n_act"], vmax, plast


def dt_limit_packed(st, cfg: SimConfig, strength_dt_mul=1.0, cfl_dt_mul=1.0):
    """Global allowed dt on packed rows, a 0-d device tensor: the
    material sound-speed limit x strength_dt_mul and the advection CFL
    dx / max|v| x cfl_dt_mul, min-reduced over active lanes (the JAX
    package's ``dt_limit_packed``, same formulas and order)."""
    act = st[RACT] > 0.5
    v = [st[RV + k] for k in range(3)]
    speed = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    F = tuple(st[RF + k] for k in range(9))
    params = tuple(st[RPAR + k] for k in range(8))
    a_dt = cforms.dispatch_allowed_dt(
        cfg.active_materials, st[RMAT].view(torch.int32), F, st[RAUX], params, st[RVOL],
        st[RMASS], speed, cfg.dx)
    strength = torch.min(torch.where(act, a_dt, 1e30)) * strength_dt_mul
    vmax = torch.max(torch.where(act, speed, 0.0))
    cfl = torch.full_like(vmax, cfl_dt_mul * cfg.dx) / torch.clamp(vmax, min=1e-30)
    return torch.minimum(strength, cfl)


class FixedDt:
    """The schedule of a fixed-dt frame: n_substeps substeps of dt."""

    def __init__(self, dt, n_substeps: int, cfg: SimConfig):
        self.dt = dt
        self.n_substeps = n_substeps
        self.step_drift = np.float32(dt * cfg.inv_dx)

    def limit(self, st):
        """No dt limit to read."""
        return None

    def more(self, t, n: int) -> bool:
        return n < self.n_substeps

    def next_dt(self, t, lim):
        return self.dt

    def drift(self, dt, vmax):
        return self.step_drift * np.float32(vmax)


class AdaptiveDt:
    """The schedule of a global adaptive-dt frame (the JAX package's
    ``packed_adaptive_frame``): substeps run until t reaches t + frame_dt
    (``t < t_end - 1e-9``) or max_substeps, each with dt =
    min(snap_pot(dt limit), t_end - t). t, dt and the drift are float32
    scalars summed in the reference's order, so the substep count is the
    reference's. ``dts`` lists the substeps' dt."""

    def __init__(self, t, cfg: SimConfig, frame_dt, unit_dt, max_dt,
                 strength_dt_mul=1.0, cfl_dt_mul=1.0, max_substeps: int = 100000):
        self.cfg = cfg
        self.t_end = np.float32(t) + np.float32(frame_dt)
        self.stop = self.t_end - np.float32(1e-9)
        self.unit_dt, self.max_dt = unit_dt, max_dt
        self.muls = (strength_dt_mul, cfl_dt_mul)
        self.max_substeps = max_substeps
        self.inv_dx = np.float32(cfg.inv_dx)
        self.dts = []

    def limit(self, st):
        """The dt limit of the state, a 0-d device tensor read with the
        substep's other values."""
        return dt_limit_packed(st, self.cfg, *self.muls)

    def more(self, t, n: int) -> bool:
        return bool(np.float32(t) < self.stop) and n < self.max_substeps

    def next_dt(self, t, lim):
        from taichi_mpm_torch.core.adaptive import snap_pot

        dt = np.minimum(snap_pot(lim, self.unit_dt, self.max_dt), self.t_end - np.float32(t))
        self.dts.append(dt)
        return dt

    def drift(self, dt, vmax):
        return np.float32(dt) * self.inv_dx * np.float32(vmax)


def read_substep(vmax, *more):
    """One host read of a substep's scalars: max|v|, then `more` (0-d
    tensors; None entries are skipped and read back as None)."""
    vals = host_read(torch.stack([vmax.to(torch.float32)]
                                 + [m.to(torch.float32) for m in more if m is not None]))
    it = iter(vals[1:])
    return vals[0], [None if m is None else next(it) for m in more]


def frame_loop(carry, t, cfg: SimConfig, colliders, sched, fused: bool = True):
    """A frame over a persistent packed carry (st, keys, pm, drift) on the
    schedule `sched` (FixedDt or AdaptiveDt): the lazy re-sort discipline
    continues across frames. Two-level loop: substeps run while the
    schedule has more and the drift stays below 0.45 cell; then the
    state is re-sorted (also after the last substep, so the next frame
    starts sorted), exactly the (substep, resort) sequence of the
    reference. One host read per substep: max|v| for the drift bound,
    with the next dt limit of an adaptive schedule. Returns (carry, t,
    max n_act, n_sorts, plast_count, n_substeps)."""
    st, keys, pm, drift = carry
    drift = np.float32(drift)
    n = nsorts = 0
    nmax = int(pm["n_act"])
    plast = torch.zeros((), dtype=torch.int32, device=st.device)
    lim = sched.limit(st)
    if lim is not None:
        lim = np.float32(host_read(lim))
    while sched.more(t, n) or drift >= DRIFT_BOUND:
        while sched.more(t, n) and drift < DRIFT_BOUND:
            dt = sched.next_dt(t, lim)
            (st, t), _, vmax, dplast = packed_substep_presorted(
                st, pm, t, cfg, colliders, dt, fused=fused)
            vmax_h, (lim,) = read_substep(vmax, sched.limit(st))
            drift = drift + sched.drift(dt, vmax_h)
            plast += dplast
            n += 1
        if drift >= DRIFT_BOUND:
            st, keys, pm = sort_and_map(st, cfg, pm["ids"].shape[0])
            drift = np.float32(0.0)
            nsorts += 1
            nmax = max(nmax, int(pm["n_act"]))
    return (st, keys, pm, drift), t, nmax, nsorts, plast, n


def packed_frame_carry(carry, t, cfg: SimConfig, colliders, dt, n_substeps: int,
                       fused: bool = True):
    """A fixed-dt frame over a persistent packed carry (``frame_loop``).
    Returns (carry, t, max n_act, n_sorts, plast_count)."""
    return frame_loop(carry, t, cfg, colliders, FixedDt(dt, n_substeps, cfg), fused)[:5]


def pack_carry(p: Particles, cfg: SimConfig, K: int):
    """The persistent packed carry of a Particles set: packed, sorted,
    page-mapped, zero drift."""
    st, keys, pm = sort_and_map(pack_particles(p), cfg, K)
    return (st, keys, pm, np.float32(0.0))


def packed_frame(p: Particles, t, cfg: SimConfig, colliders, dt, n_substeps: int, K: int,
                 fused: bool = True):
    """A frame from and to a Particles set (pack, sort and unpack at the
    frame edges). Returns (p, t, max n_act, n_sorts, plast_count); the
    sort count includes the initial sort."""
    carry = pack_carry(p, cfg, K)
    carry, t, nmax, nsorts, plast = packed_frame_carry(
        carry, t, cfg, colliders, dt, n_substeps, fused=fused)
    return unpack_particles(carry[0], p.capacity), t, nmax, nsorts + 1, plast


def packed_adaptive_frame_carry(carry, t, cfg: SimConfig, colliders, frame_dt, unit_dt,
                                max_dt, strength_dt_mul=1.0, cfl_dt_mul=1.0,
                                max_substeps: int = 100000, fused: bool = True, dts=None):
    """A global adaptive-dt frame over a persistent packed carry
    (``frame_loop`` on ``AdaptiveDt``); `dts`, where given, is a list
    the substeps' dt are appended to. Returns (carry, t, max n_act,
    n_sorts, plast_count, n_substeps)."""
    sched = AdaptiveDt(t, cfg, frame_dt, unit_dt, max_dt, strength_dt_mul, cfl_dt_mul,
                       max_substeps)
    out = frame_loop(carry, t, cfg, colliders, sched, fused)
    if dts is not None:
        dts.extend(sched.dts)
    return out


def packed_adaptive_frame(p: Particles, t, cfg: SimConfig, colliders, frame_dt, unit_dt,
                          max_dt, K: int, strength_dt_mul=1.0, cfl_dt_mul=1.0,
                          max_substeps: int = 100000, fused: bool = True):
    """A global adaptive-dt frame from and to a Particles set (the JAX
    package's ``packed_adaptive_frame``: pack and sort at the start,
    unpack at the end). Returns (p, t, n_substeps, max n_act)."""
    carry = pack_carry(p, cfg, K)
    carry, t, nmax, _, _, n = packed_adaptive_frame_carry(
        carry, t, cfg, colliders, frame_dt, unit_dt, max_dt, strength_dt_mul, cfl_dt_mul,
        max_substeps, fused)
    return unpack_particles(carry[0], p.capacity), t, n, nmax
