"""Pencils: the blocked path on a 2-D (x, y) mesh of ranks (torch
counterpart of ``taichi_mpm_tpu.parallel.spatial_mesh2d``).

Each rank owns a (Wcx, Wcy, res_z) column of the domain, a pencil, with
one ghost block each side in x and in y. Pencil (sx, sy) is rank
sx * Sy + sy, as the JAX package's ``devices.reshape(Sx, Sy)`` sharded
over ("x", "y") places it, so the global layout (the ranks' lanes in
rank order) is JAX's.

``Pencils`` is a layout that ``spatial_blocked.slab_frame`` runs, the
same host loop as the slabs' (where the JAX package has seven jitted
frames and three grow-and-re-run loops):

* a re-sort migrates in two rounds, along x and then along y
  (``spatial.migrate`` over each axis's neighbours), so a diagonal
  migrant is forwarded by the pencil between within the same re-sort;
* the record exchange runs along x, then along y, whose planes span the
  whole local x extent with its ghost columns, so that a corner node
  gets the sums of all four pencils that share it, as (a + b) + (c + d);
  then the low ghost plane outside the domain is zeroed on sx = 0 and on
  sy = 0. Where a pencil between two diagonal ones does not hold a
  corner block, its y plane still passes on what arrived for it along x
  (the JAX package's exchange drops that part; ``Pencils.exchange``);
* the origin rows, the colliders and the CPIC hooks' ``world_off`` take
  the offset on both axes;
* balanced pencils keep a rectilinear split, bounds per axis within r of
  the uniform ones, each moved toward equal counts of its marginal
  histogram (both histograms summed over the ranks by one all-reduce),
  with the JAX package's one re-sort of lag.

Sizes follow the counts, as on slabs: no migration budget, and no frame
is re-run. The route table is the driver's (``parallel.driver``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.ops import blocked
from taichi_mpm_torch.parallel import comm
from taichi_mpm_torch.parallel import spatial_blocked as sb
from taichi_mpm_torch.parallel.spatial import migrate, split_host
from taichi_mpm_torch.utils import host_read

GHOST_CELLS = sb.GHOST_CELLS


# -- uniform pencils ---------------------------------------------------------------


def pencil_cells(cfg: SimConfig, shards, axis_i: int) -> int:
    """Cells of a uniform pencil along axis `axis_i` of an (Sx, Sy) mesh."""
    n = shards[axis_i]
    if cfg.res[axis_i] % (4 * n):
        raise ValueError(f"res[{axis_i}]={cfg.res[axis_i]} must divide into whole blocks per "
                         f"pencil (4*{n})")
    return cfg.res[axis_i] // n


def local_config(cfg: SimConfig, shards) -> SimConfig:
    """A uniform pencil's config: the pencil plus one ghost block each side
    in x and y."""
    Wx, Wy = pencil_cells(cfg, shards, 0), pencil_cells(cfg, shards, 1)
    return dataclasses.replace(cfg, res=(Wx + 2 * GHOST_CELLS, Wy + 2 * GHOST_CELLS, cfg.res[2]),
                               dx=cfg.dx)


def shard_offsets_cells(sx: int, sy: int, cfg: SimConfig, shards):
    """Global cell coordinates (x, y) of local cell 0 of uniform pencil
    (sx, sy)."""
    return (np.float32(sx * pencil_cells(cfg, shards, 0) - GHOST_CELLS),
            np.float32(sy * pencil_cells(cfg, shards, 1) - GHOST_CELLS))


def shifted_colliders_xy(colliders, xoff: float, yoff: float):
    """Colliders evaluated at x + (xoff, yoff, 0): the grid update runs in
    the pencil's local node coordinates."""
    return sb.shifted_colliders(colliders, (xoff, yoff, 0.0))


# -- balanced pencils ---------------------------------------------------------------


def balanced_params2d(cfg: SimConfig, shards, rx: int, ry: int):
    """(CBx, CBy, uniform bounds x, uniform bounds y, local config) of
    balanced pencils with radii rx, ry: the local frame holds the widest
    pencil each axis allows, plus a ghost block each side."""
    outs = []
    for axis_i, (n, r) in enumerate(zip(shards, (rx, ry))):
        if cfg.res[axis_i] % 4:
            raise ValueError(f"res[{axis_i}]={cfg.res[axis_i]} is not a whole number of blocks")
        r_max = sb.max_radius(cfg, n, axis_i)
        if not 0 < r <= r_max:
            raise ValueError(f"balance radius r={r} on axis {axis_i} must be in [1, {r_max}] "
                             f"for res={cfg.res[axis_i]}, shards={n}")
        u = sb.uniform_bounds(cfg, n, axis_i)
        outs.append((cfg.res[axis_i] // 4, u, int(np.diff(u).max()) + 2 * r))
    (CBx, ux, wx), (CBy, uy, wy) = outs
    lcfg = dataclasses.replace(cfg, res=((wx + 2) * 4, (wy + 2) * 4, cfg.res[2]))
    return CBx, CBy, ux, uy, lcfg


def col_hists2d_from_pm(pm, bx0: int, by0: int, lcfg: SimConfig, CBx: int, CBy: int):
    """The global x and y marginal block-column histograms from the page
    map (K-sized), concatenated, (CBx + CBy,), and summed over the ranks
    by one all-reduce; `bx0`, `by0` the pencil's first owned columns."""
    _, nby, nbz = blocked.num_blocks_padded(lcfg)
    counts = (pm["e_arr"] - pm["s_arr"]).to(torch.int32)
    ids = pm["ids"]
    gx = torch.div(ids, nby * nbz, rounding_mode="floor") - 1 + int(bx0)
    gy = torch.div(ids, nbz, rounding_mode="floor") % nby - 1 + int(by0)
    hist = torch.zeros((CBx + CBy,), dtype=torch.int32, device=counts.device)
    hist.index_add_(0, torch.clamp(gx, 0, CBx - 1).long(), counts)
    hist.index_add_(0, CBx + torch.clamp(gy, 0, CBy - 1).long(), counts)
    return comm.all_sum(hist)


def balanced_bounds2d_host(p: Particles, cfg: SimConfig, shards, rx: int, ry: int):
    """Initial bounds on the host, per axis: the equal-count split of the
    marginal histogram within r of the uniform one (no rate limit;
    float64, as the JAX package's)."""
    CBx, CBy, ux, uy, _ = balanced_params2d(cfg, shards, rx, ry)
    x = p.x.cpu().numpy()
    act = p.active.cpu().numpy()
    outs = []
    for axis_i, (CB, u, n, r) in enumerate(((CBx, ux, shards[0], rx), (CBy, uy, shards[1], ry))):
        col = np.clip((x[act, axis_i] / cfg.dx).astype(np.int64), 0, cfg.res[axis_i] - 1) // 4
        c = np.cumsum(np.bincount(col, minlength=CB).astype(np.float64))
        q = np.arange(1, n) * c[-1] / n
        ideal = np.searchsorted(c, q, side="left").astype(np.int32) + 1
        new = np.clip(ideal, u[1:-1] - r, u[1:-1] + r)
        if c[-1] <= 0:
            new = u[1:-1]
        outs.append(np.concatenate([u[:1], new, u[-1:]]).astype(np.int32))
    return outs[0], outs[1]


def _host_pencils(p: Particles, cfg: SimConfig, shards, bx, by):
    """Each lane's pencil index px * Sy + py under block-column bounds."""
    x = p.x.cpu().numpy()
    cols = [np.clip((x[:, a] / cfg.dx).astype(np.int64), 0, cfg.res[a] - 1) // 4 for a in (0, 1)]
    px, py = (np.clip(np.searchsorted(np.asarray(b, np.int64), c, side="right") - 1, 0, n - 1)
              for b, c, n in zip((bx, by), cols, shards))
    return px * shards[1] + py


def shard_pencils(p: Particles, cfg: SimConfig, shards, rank: int, slack: float = 1.5):
    """This rank's uniform pencil of the particle set `p` (the JAX
    package's ``shard_pencils``: each pencil gets the local capacity
    max(8, ceil(slack x the largest pencil's count)), its active
    particles first, in their order). Returns (Particles, local
    capacity)."""
    Wx, Wy = pencil_cells(cfg, shards, 0), pencil_cells(cfg, shards, 1)
    x = p.x.cpu().numpy()
    cx = np.clip((x[:, 0] / cfg.dx).astype(np.int64), 0, cfg.res[0] - 1)
    cy = np.clip((x[:, 1] / cfg.dx).astype(np.int64), 0, cfg.res[1] - 1)
    pencil = np.clip(cx // Wx, 0, shards[0] - 1) * shards[1] + np.clip(cy // Wy, 0, shards[1] - 1)
    return split_host(p, pencil, shards[0] * shards[1], rank, slack)


def shard_pencils_bounds(p: Particles, cfg: SimConfig, shards, rank: int, bounds_x, bounds_y,
                         slack: float = 1.5):
    """``shard_pencils`` under per-axis block-column bounds (the JAX
    package's ``shard_pencils_bounds``)."""
    return split_host(p, _host_pencils(p, cfg, shards, bounds_x, bounds_y),
                      shards[0] * shards[1], rank, slack)


# -- one rank's pencil ---------------------------------------------------------------


class Pencils:
    """The layout of one rank's pencil of an (Sx, Sy) mesh, the two-axis
    counterpart of ``spatial_blocked.Slabs`` (its methods, for
    ``slab_frame``): uniform (r None) or balanced with radii r = (rx, ry);
    ``lcfg`` the local config, ``CB`` and ``uniform`` each axis's block
    columns and uniform bounds. `bounds` is the pair (bounds_x, bounds_y)
    of host int32 arrays, or None on uniform pencils, which are the
    uniform bounds."""

    def __init__(self, cfg: SimConfig, shards, rank: int, r: Optional[tuple] = None):
        Sx, Sy = (int(n) for n in shards)
        self.cfg, self.shards, self.rank, self.r = cfg, (Sx, Sy), rank, r
        self.n_shards = Sx * Sy
        self.sx, self.sy = divmod(rank, Sy)
        # along x the pencils of one y column, Sy ranks apart; along y those of one x row
        self.axes = (comm.Axis(Sy, self.sx, Sx), comm.Axis(1, self.sy, Sy))
        if r is None:
            self.lcfg = local_config(cfg, self.shards)
            self.CB = (cfg.res[0] // 4, cfg.res[1] // 4)
            self.uniform = (sb.uniform_bounds(cfg, Sx, 0), sb.uniform_bounds(cfg, Sy, 1))
        else:
            CBx, CBy, ux, uy, self.lcfg = balanced_params2d(cfg, self.shards, *r)
            self.CB, self.uniform = (CBx, CBy), (ux, uy)

    @property
    def balanced(self) -> bool:
        return self.r is not None

    def _bounds(self, bounds):
        return self.uniform if bounds is None else bounds

    def off_cells(self, bounds) -> tuple:
        """Global cell coordinates (x, y) of the pencil's local cell 0."""
        if bounds is None:
            return shard_offsets_cells(self.sx, self.sy, self.cfg, self.shards)
        bx, by = bounds
        return (np.float32((int(bx[self.sx]) - 1) * 4), np.float32((int(by[self.sy]) - 1) * 4))

    def width(self, bounds) -> tuple:
        """Block columns the rank owns along x and along y."""
        bx, by = self._bounds(bounds)
        return (int(bx[self.sx + 1]) - int(bx[self.sx]), int(by[self.sy + 1]) - int(by[self.sy]))

    def world_off(self, bounds) -> tuple:
        return sb.world_offset(self.off_cells(bounds), self.cfg)

    def origin_shift(self, bounds) -> tuple:
        offx, offy = self.off_cells(bounds)
        return (float(offx), float(offy), 0.0)

    def grid_colliders(self, colliders, bounds):
        xoff, yoff, _ = self.world_off(bounds)
        return shifted_colliders_xy(colliders, xoff, yoff)

    def rebalance(self, hist, bounds):
        """Each axis's bounds moved toward equal counts of its marginal
        histogram (one host read for both)."""
        if not self.balanced:
            return bounds
        h = host_read(hist)
        CBx = self.CB[0]
        return tuple(sb.rebalance_bounds(hh, b, u, r, n) for hh, b, u, r, n in zip(
            (h[:CBx], h[CBx:]), bounds, self.uniform, self.r, self.shards))

    def migrate(self, p: Particles, bounds, stats: sb.SlabStats) -> Particles:
        """Each particle to its pencil's rank, along x and then along y (the
        owners along y taken after the x round, whose arrivals take free
        lanes), counted in `stats`: the x round as sent left and right,
        the y round as sent low and high, and the particles that move on
        both axes."""
        bx, by = self._bounds(bounds)
        cfg, (Sx, Sy) = self.cfg, self.shards
        dest_x = sb.dest_from_bounds(p.x, bx, cfg, Sx, 0)
        dest_y = sb.dest_from_bounds(p.x, by, cfg, Sy, 1)
        stats.diagonal = stats.diagonal + (p.active & (dest_x != self.sx)
                                           & (dest_y != self.sy)).sum()
        t0 = stats.clock(p.device)
        p, mx = migrate(p, cfg, Sx, dest_x, axis=self.axes[0])
        p, my = migrate(p, cfg, Sy, sb.dest_from_bounds(p.x, by, cfg, Sy, 1), axis=self.axes[1])
        stats.migrate_s += stats.clock(p.device) - t0
        stats.sent_left += mx.sent_left
        stats.sent_right += mx.sent_right
        stats.sent_low_y += my.sent_left
        stats.sent_high_y += my.sent_right
        stats.arrived += mx.arrived + my.arrived
        stats.grown += mx.grown + my.grown
        return p

    def hist(self, pm, bounds):
        """Both marginal histograms, concatenated, summed over the ranks."""
        bx, by = bounds
        return col_hists2d_from_pm(pm, bx[self.sx], by[self.sy], self.lcfg, *self.CB)

    def bounds_record(self, bounds) -> tuple:
        return tuple(tuple(int(b) for b in bb) for bb in bounds)

    def exchange(self, rec, pm, bounds):
        """The record exchange in the JAX package's order (``_exchange_axis``
        along x, then along y over every x column, ghosts too; then
        ``_zero_edge_ghosts`` on sx = 0 and on sy = 0). A block of the x
        boundary columns that this rank does not hold passes on, in its y
        plane, what its x neighbour sent for it: a corner block held by
        two diagonal pencils alone then gets both parts. (JAX's y planes
        carry only the blocks a rank holds, so there the part of the
        diagonal pencil is lost.) An axis of one pencil exchanges
        nothing."""
        Wbx, Wby = self.width(bounds)
        lcfg, K = self.lcfg, pm["ids"].shape[0]
        xcols = ((0, 1), (Wbx, Wbx + 1))
        got = []
        if self.shards[0] > 1:
            lo, hi = (sb._boundary_planes(rec, pm, lcfg, c, 0) for c in xcols)
            got = comm.neighbour_exchange(lo, hi, axis=self.axes[0])
            for cols, planes in zip(xcols, got):
                rec = sb._add_planes(rec, pm, lcfg, cols, planes, 0)
        if self.shards[1] > 1:
            ycols = ((0, 1), (Wby, Wby + 1))
            out = []
            for rows in ycols:
                planes = sb._boundary_planes(rec, pm, lcfg, rows, 1)  # (2, nbx, nbz, 256)
                y = slice(rows[0], rows[0] + 2)  # basic slices: no index copied to the card
                for cols, arrived in zip(xcols, got):
                    for i, a in enumerate(cols):
                        held = sb._column_slots(pm, lcfg, a, 0)[y] < K  # (2, nbz)
                        planes[:, a] = torch.where(held[..., None], planes[:, a], arrived[i][y])
                out.append(planes)
            got_y = comm.neighbour_exchange(out[0], out[1], axis=self.axes[1])
            for rows, planes in zip(ycols, got_y):
                rec = sb._add_planes(rec, pm, lcfg, rows, planes, 1)
        rec = sb.zero_domain_edge_ghosts(rec, pm, lcfg, self.sx, 0)
        return sb.zero_domain_edge_ghosts(rec, pm, lcfg, self.sy, 1)
