"""Per-block bucketed time stepping on x-slabs (torch counterpart of
``taichi_mpm_tpu.parallel.async_spatial``): the scheduler of
``ops.async_bucketed`` over uniform 1-D slabs, one rank each, the fused
substep on every rank's mini-states.

* Lockstep. The frame is the one-device tick loop
  (``async_bucketed.tick_loop``) on every rank, and every branch it takes
  comes from a value reduced over the ranks: at each sort one all-reduce
  (``comm.all_max``) carries the levels present, the largest occupied
  level and the smallest level (as its negation); each advance's max |v|
  waits on the device and the pending ones are reduced together at the
  next aligned tick, then added to the drifts in advance order, as the
  JAX frame adds its ``pmax`` per advance. A level present on any rank
  advances on every rank: a rank whose context is empty still makes the
  advance's record exchange, with zero planes
  (``spatial_blocked.exchange_nothing``).
* Levels across the slab boundaries (``slot_levels_sharded``): each of
  the MAXLEV Jacobi sweeps first exchanges the level planes of block
  columns 1 and Wb with the neighbours (the domain-edge ranks take
  MAXLEV in place of a plane), so the sweeps read what the one-device
  sweeps read.
* Contexts across the boundaries: a level's context adds the local edge
  blocks next to a neighbour's in-bucket edge blocks (``ctx_extend``).
  The plans are built once per sort, so those planes cross once per
  sort, every level's in one exchange. The mini-substep's records are
  summed over the boundary columns (``spatial_blocked.record_exchange``),
  and G2P stays local.
* Re-sorts happen at time-synchronous ticks only, where backup := state
  is exact; particles migrate there (``spatial_blocked.resort``).

As in the port's other slab frames, sizes follow the counts: no
per-level budgets, no ``K_ctx``, no migration budget and no re-run of an
overflowing frame. Uniform slabs and the fused route only, as the JAX
module.
"""

from __future__ import annotations

import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.ops import async_bucketed as ab
from taichi_mpm_torch.ops import blocked
from taichi_mpm_torch.ops.async_bucketed import MAXLEV
from taichi_mpm_torch.parallel import comm
from taichi_mpm_torch.parallel import spatial_blocked as sb
from taichi_mpm_torch.utils import host_read


def _col_plane(vec, pm, lcfg: SimConfig, col: int, fill):
    """The (nby, nbz) plane of a per-slot vector at one local block column,
    `fill` where the block has no slot."""
    K = pm["ids"].shape[0]
    slot = sb._column_slots(pm, lcfg, col)
    return torch.where(slot < K, vec[torch.clamp(slot, max=K - 1)], fill)


def _pool9(plane, fill, op):
    """3x3 min or max pool over the last two axes (by, bz), `fill` beyond
    the edges: the cross-boundary 9-neighbourhood of an edge block."""
    H, W = plane.shape[-2:]
    p = torch.full(plane.shape[:-2] + (H + 2, W + 2), fill, dtype=plane.dtype,
                   device=plane.device)
    p[..., 1:H + 1, 1:W + 1] = plane
    out = torch.full_like(plane, fill)
    for dy in range(3):
        for dz in range(3):
            out = op(out, p[..., dy:dy + H, dz:dz + W])
    return out


def _edge_columns(pm, lcfg: SimConfig):
    """(bx, by, bz) of each slot's block, bx = -1 for a slot without one."""
    bx, by, bz, valid = blocked._decode_ids(pm["ids"], lcfg)
    return torch.where(valid, bx, -1), by.long(), bz.long()


def slot_levels_sharded(st, pm, cfg: SimConfig, lcfg: SimConfig, unit_dt: float, Wb: int,
                        strength_dt_mul=1.0, cfl_dt_mul=1.0):
    """``async_bucketed.slot_levels`` across the slab boundaries: each
    Jacobi sweep first exchanges the current level planes of local block
    columns 1 and Wb (local column 0 is the left neighbour's column Wb),
    then applies the local sweep and, on the edge columns, the
    neighbour's 9-pooled levels + 1. Every rank calls it together."""
    lev = ab.slot_level_base(st, pm, cfg, unit_dt, strength_dt_mul, cfl_dt_mul)
    bx, by, bz = _edge_columns(pm, lcfg)
    s, n = comm.rank(), comm.world()
    for _ in range(MAXLEV):
        from_left, from_right = comm.neighbour_exchange(_col_plane(lev, pm, lcfg, 1, MAXLEV),
                                                        _col_plane(lev, pm, lcfg, Wb, MAXLEV))
        if s == 0:  # no neighbour: the zeros of the exchange read as missing blocks
            from_left.fill_(MAXLEV)
        if s == n - 1:
            from_right.fill_(MAXLEV)
        m = ab.monotonic_sweep(lev, pm)
        cl = _pool9(from_left, MAXLEV, torch.minimum)[by, bz] + 1
        cr = _pool9(from_right, MAXLEV, torch.minimum)[by, bz] + 1
        m = torch.where(bx == 1, torch.minimum(m, cl), m)
        lev = torch.where(bx == Wb, torch.minimum(m, cr), m)
    return lev


def context_extension(pm, lcfg: SimConfig, Wb: int):
    """The plans' context extension on this rank's page map (the JAX
    module's ``ctx_extend``, all levels at once): in_buckets (n, K) bool
    -> the local edge blocks (columns 1 and Wb) next to the neighbours'
    in-bucket edge blocks, (n, K) bool. One exchange of the stacked
    planes."""
    bx, by, bz = _edge_columns(pm, lcfg)

    def extend(in_buckets):
        ib = in_buckets.to(torch.int32)
        lo = torch.stack([_col_plane(b, pm, lcfg, 1, 0) for b in ib])
        hi = torch.stack([_col_plane(b, pm, lcfg, Wb, 0) for b in ib])
        from_left, from_right = comm.neighbour_exchange(lo, hi)
        ml = _pool9(from_left, 0, torch.maximum)[:, by, bz]
        mr = _pool9(from_right, 0, torch.maximum)[:, by, bz]
        return ((bx == 1) & (ml > 0)) | ((bx == Wb) & (mr > 0))

    return extend


class SlabSteps(ab.OneDevice):
    """The device steps of the slab bucketed frame on this rank (uniform
    slabs, fused): the sort migrates and levels across the boundaries,
    the advance exchanges the mini-state's boundary records (zeros where
    its context is empty), and the reductions go over the ranks."""

    def __init__(self, slabs: sb.Slabs, colliders, unit_dt: float, strength_dt_mul=1.0,
                 cfl_dt_mul=1.0, stats: sb.SlabStats = None):
        if slabs.balanced:
            raise ValueError("the slab bucketed frame runs on uniform slabs")
        super().__init__(slabs.cfg, colliders, None, True)
        self.slabs, self.unit_dt = slabs, unit_dt
        self.mul = (strength_dt_mul, cfl_dt_mul)
        self.stats = sb.SlabStats() if stats is None else stats
        self.Wb = slabs.width(None)
        self.grid_colliders = sb.shifted_colliders(colliders, slabs.xoff(None))

    def sort(self, st, K: int, tz: int, stats: ab.FrameStats) -> ab.Sorted:
        slabs, lcfg = self.slabs, self.slabs.lcfg
        st, keys, pm, _, _ = sb.resort(sb.SlabCarry(st, None, None, K), slabs, True, self.stats)
        lev = slot_levels_sharded(st, pm, self.cfg, lcfg, self.unit_dt, self.Wb, *self.mul)
        lev = torch.clamp(lev, max=tz).to(torch.int32)
        return ab.Sorted(st, keys, pm, lev, lcfg, stats, all_max=comm.all_max,
                         ctx_extend=context_extension(pm, lcfg, self.Wb))

    def advance(self, st, backup, plan: ab.BucketPlan, t, dt):
        if plan.pm is None:
            sb.exchange_nothing(self.slabs.lcfg, st.device)
            return None
        return ab.advance_bucket(
            st, backup, plan, t, self.cfg, self.colliders, dt, True, lcfg=self.slabs.lcfg,
            grid_colliders=self.grid_colliders,
            exchange_fn=lambda rec, mpm: sb.record_exchange(mpm, self.slabs, None, self.stats)(rec))

    def all_max(self, x):
        return comm.all_max(x)

    def all_sum(self, x):
        return comm.all_sum(x)


def bucketed_slab_frame(st, t, slabs: sb.Slabs, colliders, frame_dt, unit_dt, K: int,
                        strength_dt_mul=1.0, cfl_dt_mul=1.0, stats: sb.SlabStats = None):
    """One bucketed frame of this rank's slab (the JAX module's
    ``build_bucketed_spatial_frame``; every rank calls it together): the
    packed state `st` (any lane order) is migrated, sorted and levelled,
    then the tick loop runs in lockstep. frame_dt must be an integer
    multiple of unit_dt * 2^MAXLEV. `stats` (a ``SlabStats``) gathers the
    migrations and the exchanges. Returns (state, K, t, n_updates summed
    over the ranks, FrameStats of this rank: its level histograms, the
    schedule and the advances, the same on every rank)."""
    steps = SlabSteps(slabs, colliders, unit_dt, strength_dt_mul, cfl_dt_mul, stats)
    cur, st, t, n_up, _, fstats = ab.tick_loop(st, t, slabs.cfg, frame_dt, unit_dt, K, steps)
    fstats.host_reads += 1
    fstats.n_updates = int(host_read(n_up))
    return st, cur.pm["ids"].shape[0], t, fstats.n_updates, fstats

