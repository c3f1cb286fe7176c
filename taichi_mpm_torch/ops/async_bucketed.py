"""Per-block (bucketed) adaptive time stepping on the packed path (torch
counterpart of ``taichi_mpm_tpu.ops.async_bucketed``): the regional time
stepping of the reference's ``async_mpm`` scheduler.

* Every page-map slot (a 4^3-cell block) carries a power-of-two dt
  LEVEL: dt_slot = unit * 2^lev, lev = floor(log2(limit / unit)) of the
  smallest per-particle limit in the slot (the material sound-speed
  limit x ``strength_dt_mul`` and the advection CFL dx / |v| x
  ``cfl_dt_mul``), clipped to [0, MAXLEV]; then MAXLEV sweeps make it
  monotonic (a block exceeds its neighbours by at most one level).
* The frame runs on integer unit ticks; at tick T every level L with
  2^L | T advances, the largest level first.
* One bucket advance is the packed substep at dt = unit * 2^L over a
  mini-state: the level-L slots and their 27-neighbourhoods, read off
  the block sort as contiguous sorted ranges. Slower (higher-level)
  neighbours enter through their BACKUP, the state at their own last
  advance; equal and faster ones are live. Only the bucket's own lanes
  commit, and only they refresh their backup (with the pre-advance
  state).
* A drift accumulator per level; a re-sort (sort, page map, levels,
  backup := state) happens only at a tick where every occupied block is
  time-synchronous (2^(max occupied level) divides the tick), with the
  new levels clamped to the tick's trailing zeros.
* ``update_counter`` counts committed active advances.

What differs from the JAX module, and why nothing it computes changes:

* The context of a level, its lanes, its mini page map and its commit
  lanes depend only on the sort and the levels, so they are built once
  per sort (``plan_buckets``), not at every advance. Each mini-state holds
  exactly its context's lanes (the count is read on the host when the
  plan is built) and its page map exactly its dilated occupancy (read
  there too): there are no per-level budgets, no ``K_ctx`` and no
  re-run of an overflowing frame, and no invalid lanes. The JAX module
  routes its invalid lanes to lane pw - 1 and scatters with duplicate
  indices there; this module writes the committed lanes only.
* The JAX frame is a ``while_loop`` with a ``cond`` per level. Here it
  is a host loop: which levels exist and which ticks are aligned are
  known on the host from the levels read at the sort. The drift
  accumulators and the update count stay on the device; the host reads
  the drifts at aligned ticks only (the one place a re-sort can happen)
  and the count at the frame's end.
* The arithmetic of the tick time, dt and the drift is the JAX frame's
  as XLA compiles it: dt_L = unit * 2^L and dt_L * inv_dx are formed in
  float64 and rounded to float32 where they meet float32 values; the
  time advances by float32(unit) * step in float32; floor(log2) is
  log(x) * 1.44269502 in float32 with the division by the unit a product
  with its float32 reciprocal.

Both routes: ``fused=True`` runs ``p2g_fused`` and ``g2p_fused`` on the
mini-state, ``fused=False`` (``TMT_FUSED=0``) ``p2g_blocked`` and
``g2p_blocked``; each bucket advance with a non-empty context launches
its route's two kernels once.

The slab hooks (``parallel.async_spatial``, the JAX module's ``lcfg``,
``grid_colliders``, ``exchange_fn`` and ``ctx_extend_fn``): the plans
take the slab's local grid config as their `cfg` and a context
extension (the local edge blocks next to a neighbour rank's in-bucket
blocks, all levels in one exchange per sort); ``advance_bucket`` takes
the local config, the shifted colliders and the record exchange of the
fused substep; ``tick_loop`` runs the frame with the sort, the advance
and the two reductions of a ``OneDevice`` or of the slab frame's steps.
Without them the frame is the one-device frame it was.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.materials import cforms
from taichi_mpm_torch.ops import blocked, packed
from taichi_mpm_torch.ops.blocked import nbr_at
from taichi_mpm_torch.ops.rows import (
    RACT, RAUX, RF, RMASS, RMAT, RPAR, RV, RVOL,
)
from taichi_mpm_torch.utils import host_read

MAXLEV = 6  # levels 0..MAXLEV (dt spans a 64x range)

# The constant XLA compiles jnp.log2 with: log2(x) is log(x) * 1.44269502
# in float32 (and exp2(k) is exp(k * 0.693147182)).
LOG2_E = np.float32(1.44269502)
LN_2 = np.float32(0.693147182)


def reciprocal_f32(unit_dt: float) -> np.float32:
    """The float32 reciprocal of float32(unit_dt): XLA turns a division
    by the constant unit into a product with it."""
    return np.float32(1.0 / np.float64(np.float32(unit_dt)))


def slot_level_base(st, pm, cfg: SimConfig, unit_dt: float, strength_dt_mul=1.0,
                    cfl_dt_mul=1.0):
    """Per-slot level before the monotonicity sweeps, (K,) int32: floor(
    log2(smallest limit / unit)) of the slot's active lanes, clipped to
    [0, MAXLEV]; an empty slot takes MAXLEV."""
    K = pm["ids"].shape[0]
    act = st[RACT] > 0.5
    v = [st[RV + k] for k in range(3)]
    speed = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    F = tuple(st[RF + k] for k in range(9))
    params = tuple(st[RPAR + k] for k in range(8))
    a_dt = cforms.dispatch_allowed_dt(
        cfg.active_materials, st[RMAT].view(torch.int32), F, st[RAUX], params, st[RVOL],
        st[RMASS], speed, cfg.dx) * float(np.float32(strength_dt_mul))
    # a true division (a Python number over a tensor is a reciprocal times it)
    cfl = torch.full_like(speed, cfl_dt_mul * cfg.dx) / torch.clamp(speed, min=1e-30)
    lim = torch.where(act, torch.minimum(a_dt, cfl), float("inf"))
    seg = torch.clamp(pm["slot_keys"], max=K).long()
    slot_lim = torch.full((K + 1,), float("inf"), dtype=torch.float32, device=st.device)
    slot_lim = slot_lim.scatter_reduce(0, seg, lim, "amin")[:K]
    slot_lim = torch.where(torch.isfinite(slot_lim), slot_lim, float("inf"))
    ratio = torch.clamp(slot_lim * float(reciprocal_f32(unit_dt)), min=1.0)
    # XLA's float32 log2; the float32 log rounded from float64 (see
    # core.adaptive.snap_pot)
    lg = torch.log(ratio.double()).float() * float(LOG2_E)
    # clip before the conversion: an empty slot's inf goes to MAXLEV, as
    # XLA's saturating conversion and the clip take it
    return torch.clamp(torch.floor(lg), 0, MAXLEV).to(torch.int32)


def monotonic_sweep(lev, pm):
    """One Jacobi sweep of neighbour monotonicity: every slot's level
    drops to the smallest of its 26 neighbours' + 1 (a missing neighbour
    counts as MAXLEV)."""
    K = lev.shape[0]
    ext = torch.cat([lev, lev.new_full((1,), MAXLEV)])
    nb = ext[torch.clamp(pm["nbr"], max=K).long()]  # (27, K)
    nb = torch.cat([nb[:13], nb[14:]])  # the 26 neighbours, not the slot itself
    return torch.minimum(lev, nb.amin(0) + 1)


def slot_levels(st, pm, cfg: SimConfig, unit_dt: float, strength_dt_mul=1.0,
                cfl_dt_mul=1.0):
    """Per-slot power-of-two dt level (K,) int32: ``slot_level_base``,
    then MAXLEV monotonicity sweeps."""
    lev = slot_level_base(st, pm, cfg, unit_dt, strength_dt_mul, cfl_dt_mul)
    for _ in range(MAXLEV):
        lev = monotonic_sweep(lev, pm)
    return lev


def snapped_unit(frame_dt: float, unit_delta_t: float) -> float:
    """The scheduler's unit: unit_delta_t snapped so that frame_dt = m *
    unit * 2^MAXLEV (m >= 1), as the JAX drivers snap it."""
    m = max(1, round(frame_dt / (unit_delta_t * (1 << MAXLEV))))
    return frame_dt / (m * (1 << MAXLEV))


def context_slots(lev, pm, L: int, cfg: SimConfig, extend=None):
    """The level-L bucket (lev == L) dilated by its 27-neighbourhood, or
    by `extend` (a (K,) bool of slots to add: the slab hook), live slots
    only: (in_bucket, ctx), both (K,) bool."""
    K = lev.shape[0]
    in_bucket = lev == L
    ext = torch.cat([in_bucket, in_bucket.new_zeros(1)])
    ctx = in_bucket.clone()
    for ox in range(3):
        for oy in range(3):
            for oz in range(3):
                if (ox, oy, oz) != (1, 1, 1):
                    ctx |= ext[torch.clamp(nbr_at(pm["nbr"], ox, oy, oz), max=K).long()]
    if extend is not None:
        ctx |= extend
    return in_bucket, ctx & (pm["ids"] < blocked.total_blocks_padded(cfg))


def bucket_ranges(pm, slot_sel, n_sel=None):
    """The sorted lanes of the selected slots, concatenated in slot order
    (the shared-sort compaction): (idx (n_sel,) int64, n_sel); the count,
    where not given, is read on the host."""
    s = pm["s_arr"]
    e = torch.where(slot_sel, pm["e_arr"], s)
    if n_sel is None:
        n_sel = int((e - s).sum())
    return blocked.range_lanes(s, e, n_sel)[1], n_sel


@dataclasses.dataclass
class BucketPlan:
    """What a level-L advance needs between two sorts: the context lanes
    `idx` of the full state; the positions `bpos` among them read from
    the backup (their slot's level is above L) and those lanes `bidx`;
    the positions `cpos` that commit (the bucket's own lanes, `commit`)
    and those lanes `cidx`; the mini page map (None for an empty
    context)."""

    L: int
    idx: torch.Tensor
    bpos: torch.Tensor
    bidx: torch.Tensor
    cpos: torch.Tensor
    cidx: torch.Tensor
    commit: torch.Tensor  # (n_sel,) bool
    pm: dict

    @property
    def n_sel(self) -> int:
        return self.idx.shape[0]


def plan_buckets(keys, pm, lev, levels, cfg: SimConfig, ctx_extend=None):
    """The plans of the given levels: each bucket's context, lanes and
    mini page map (sized to its dilated occupancy). `cfg` is the grid
    config of the keys and the page map (a slab's local one on slabs);
    `ctx_extend(in_buckets)`, where given, maps the levels' in-bucket
    masks (n_levels, K) to the slots each context adds (the JAX module's
    ``ctx_extend_fn``, for all levels at once). Two host reads for all
    levels together: the context sizes, then the mini page maps'
    occupancies."""
    K = lev.shape[0]
    levels = sorted(levels)
    extend = dict.fromkeys(levels)
    if ctx_extend is not None and levels:
        ext = ctx_extend(torch.stack([lev == L for L in levels]))
        extend = {L: ext[i] for i, L in enumerate(levels)}
    sel = {L: context_slots(lev, pm, L, cfg, extend[L]) for L in levels}
    sizes = torch.stack([torch.where(sel[L][1], pm["e_arr"] - pm["s_arr"], 0).sum()
                         for L in levels]).tolist()
    plans, mini = {}, {}
    for L, n_sel in zip(levels, sizes):
        in_bucket, ctx = sel[L]
        idx, _ = bucket_ranges(pm, ctx, n_sel)
        sk = pm["slot_keys"][idx]
        live = sk < K
        skc = torch.clamp(sk, max=K - 1).long()
        commit = live & in_bucket[skc]
        bpos = torch.nonzero(live & (lev[skc] > L)).flatten()
        cpos = torch.nonzero(commit).flatten()
        plans[L] = BucketPlan(L=L, idx=idx, bpos=bpos, bidx=idx[bpos], cpos=cpos,
                              cidx=idx[cpos], commit=commit, pm=None)
        if n_sel:
            mini[L] = packed.build_page_map_packed(keys[idx], cfg, 1)
    if mini:
        occ = torch.stack([m["n_act"] for m in mini.values()]).tolist()
        for (L, m), n_act in zip(mini.items(), occ):
            plans[L].pm = packed.build_page_map_packed(keys[plans[L].idx], cfg, n_act) \
                if n_act > 1 else m
    return plans


def plan_bucket(keys, pm, lev, L: int, cfg: SimConfig) -> BucketPlan:
    """The plan of the level-L bucket alone (``plan_buckets``)."""
    return plan_buckets(keys, pm, lev, [L], cfg)[L]


def advance_bucket(st, backup, plan: BucketPlan, t, cfg: SimConfig, colliders, dt,
                   fused: bool = True, lcfg: SimConfig = None, grid_colliders=None,
                   exchange_fn=None):
    """One advance of the planned bucket by dt, in place on `st` and
    `backup`: gather the mini-state (slower neighbours from the backup),
    write the committing lanes' pre-advance state to the backup, run the
    packed substep on the mini-state and commit the bucket's lanes.
    Returns (n_updates, vmax) as 0-d device tensors: the committed active
    lanes, and max |v| over the committed lanes active after it.

    The slab hooks of ``packed.fused_substep_presorted``: `lcfg` the
    slab's local config, `grid_colliders` the colliders shifted into it,
    `exchange_fn(rec, mini page map)` the boundary record exchange. Slabs
    run the fused route only, as the JAX module asserts."""
    mini = st[:, plan.idx]
    if plan.bpos.numel():
        mini[:, plan.bpos] = backup[:, plan.bidx]
    n_up = ((mini[RACT] > 0.5) & plan.commit).sum()
    backup[:, plan.cidx] = mini[:, plan.cpos]
    if exchange_fn is None:
        (mini, _), _, _, _ = packed.packed_substep_presorted(mini, plan.pm, t, cfg, colliders,
                                                             dt, fused=fused)
    else:
        if not fused:
            raise ValueError("the slab bucketed frame runs the fused substep only")
        (mini, _), _, _, _ = packed.fused_substep_presorted(
            mini, plan.pm, t, cfg, colliders, dt, gcfg=lcfg, grid_colliders=grid_colliders,
            exchange_fn=lambda rec: exchange_fn(rec, plan.pm))
    st[:, plan.cidx] = mini[:, plan.cpos]
    done = (mini[RACT] > 0.5) & plan.commit
    vmax = torch.amax(torch.where(done, torch.abs(mini[RV:RV + 3]), 0.0))
    return n_up, vmax


def bucket_substep(st, backup, keys, pm, lev, L: int, t, cfg: SimConfig, colliders, dt,
                   fused: bool = True):
    """Advance the level-L bucket by dt (the JAX module's form: plan and
    advance in one call), in place on `st` and `backup`. Returns (st,
    backup, n_sel, mini n_act, n_updates, vmax)."""
    plan = plan_bucket(keys, pm, lev, L, cfg)
    if plan.pm is None:
        zero = torch.zeros((), dtype=torch.float32, device=st.device)
        return st, backup, 0, 0, zero.to(torch.int64), zero
    n_up, vmax = advance_bucket(st, backup, plan, t, cfg, colliders, dt, fused)
    return st, backup, plan.n_sel, plan.pm["ids"].shape[0], n_up, vmax


def _trailing_zeros(tick: int) -> int:
    return (tick & -tick).bit_length() - 1


@dataclasses.dataclass
class FrameStats:
    """What a bucketed frame did: advances per level (``advances``, the
    JAX frame's n_substeps is their sum), those with an empty context
    (no kernel launched), the sorts (the frame's first and the mid-frame
    re-sorts), the level histogram of the occupied slots at each sort, the
    largest mini-state (lanes, slots), the host reads of the frame's loop
    (``host_reads``: the drifts at aligned ticks, the count at the end)
    and those of its sorts (``sort_reads``, besides the page map's own
    occupancy read), and the schedule: (tick, level) of every advance."""

    advances: list
    schedule: list = dataclasses.field(default_factory=list)
    empty_advances: int = 0
    sorts: int = 0
    sort_reads: int = 0
    level_hist: list = dataclasses.field(default_factory=list)
    max_lanes: int = 0
    max_slots: int = 0
    host_reads: int = 0
    n_updates: int = 0

    @property
    def n_substeps(self) -> int:
        return sum(self.advances)

    @property
    def n_resorts(self) -> int:
        return self.sorts - 1


class Sorted:
    """The state at a sort: the sorted state, keys, page map and levels,
    what the tick loop takes its branches from (the levels that exist,
    the largest occupied level, the smallest level) and the plans of the
    levels that exist. `gcfg` is the grid config of the keys (a slab's
    local one on slabs); `all_max`, where given, reduces the branch
    values over the ranks, one all-reduce, so that every rank takes the
    same branches; `ctx_extend` is ``plan_buckets``'s. Three host reads:
    the branch values with this sort's level histogram, then two in
    ``plan_buckets``."""

    def __init__(self, st, keys, pm, lev, gcfg: SimConfig, stats: FrameStats, all_max=None,
                 ctx_extend=None):
        self.st, self.keys, self.pm, self.lev = st, keys, pm, lev
        total = blocked.total_blocks_padded(gcfg)
        occ = ((pm["e_arr"] > pm["s_arr"]) & (pm["ids"] < total)).long()
        lev64 = lev.long()
        n = MAXLEV + 1
        has = torch.zeros((n,), dtype=torch.int64, device=lev.device).index_add_(
            0, lev64, torch.ones_like(lev64)).clamp(max=1)
        hist = torch.zeros_like(has).index_add_(0, lev64, occ)
        branch = torch.cat([has, torch.where(occ > 0, lev64, 0).amax()[None],
                            -lev64.amin()[None]])
        if all_max is not None:
            branch = all_max(branch)
        got = host_read(torch.cat([branch, hist]))
        self.levels = {L for L in range(n) if got[L]}
        self.lmax_occ, self.min_lev = got[n], -got[n + 1]
        stats.level_hist.append(got[n + 2:])
        self.plans = plan_buckets(keys, pm, lev, self.levels, gcfg, ctx_extend)
        stats.sorts += 1
        stats.sort_reads += 3
        for plan in self.plans.values():
            stats.max_lanes = max(stats.max_lanes, plan.n_sel)
            if plan.pm is not None:
                stats.max_slots = max(stats.max_slots, plan.pm["ids"].shape[0])


class OneDevice:
    """The device steps of a bucketed frame on one device: the sort (with
    the levels of `level_fn(st, pm)`), the advance, and the reductions
    over the ranks, which one device does not need. The slab frame's
    steps (``parallel.async_spatial.SlabSteps``) replace them."""

    def __init__(self, cfg: SimConfig, colliders, level_fn, fused: bool = True):
        self.cfg, self.colliders, self.level_fn, self.fused = cfg, colliders, level_fn, fused

    def sort(self, st, K: int, tz: int, stats: FrameStats) -> Sorted:
        """Sort, page map (capacity K or more) and levels clamped to tz."""
        st, keys, pm = packed.sort_and_map(st, self.cfg, K)
        lev = torch.clamp(self.level_fn(st, pm), max=tz).to(torch.int32)
        return Sorted(st, keys, pm, lev, self.cfg, stats)

    def advance(self, st, backup, plan: BucketPlan, t, dt):
        """``advance_bucket``; None where the bucket's context is empty."""
        if plan.pm is None:
            return None
        return advance_bucket(st, backup, plan, t, self.cfg, self.colliders, dt, self.fused)

    def all_max(self, x):
        return x

    def all_sum(self, x):
        return x


def tick_loop(st, t, cfg: SimConfig, frame_dt, unit_dt, K: int, steps):
    """The tick loop of one bucketed frame on the packed state `st`, with
    the device steps `steps` (``OneDevice``, or the slab frame's). Each
    advance's max |v| waits on the device until the next aligned tick,
    where they are reduced together (``steps.all_max``) and added to the
    drifts in advance order, as the JAX frame adds them one by one.
    Returns (Sorted of the last sort, state, t, n_updates (a 0-d tensor,
    reduced by ``steps.all_sum``), drift (host), FrameStats)."""
    stats = FrameStats(advances=[0] * (MAXLEV + 1))
    n_units = int(round(frame_dt / unit_dt))
    if n_units % (1 << MAXLEV):
        raise ValueError(f"frame_dt must be a multiple of unit_dt * 2^{MAXLEV}")
    cur = steps.sort(st, K, MAXLEV, stats)
    st = cur.st
    backup = st.clone()
    dev = st.device
    drifts = torch.zeros((MAXLEV + 1,), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n_up = torch.zeros((), dtype=torch.int64, device=dev)
    pending = []  # (level, vmax) of the advances since the last aligned tick

    def add_drifts():
        if pending:
            vmax = steps.all_max(torch.stack([v for _, v in pending]))
            for i, (L, _) in enumerate(pending):
                drifts[L] += vmax[i] * float(np.float32(unit_dt * (1 << L) * cfg.inv_dx))
            pending.clear()

    unit32 = np.float32(unit_dt)
    t = np.float32(t)
    tick = 0
    while tick < n_units:
        if tick > 0 and tick % (1 << cur.lmax_occ) == 0:
            stats.host_reads += 1
            add_drifts()
            if float(host_read(drifts.max())) >= packed.DRIFT_BOUND:
                cur = steps.sort(st, cur.pm["ids"].shape[0], _trailing_zeros(tick), stats)
                st = cur.st
                backup = st.clone()
                drifts.zero_()
        for L in range(MAXLEV, -1, -1):
            if tick % (1 << L) or L not in cur.levels:
                continue
            stats.advances[L] += 1
            stats.schedule.append((tick, L))
            out = steps.advance(st, backup, cur.plans[L], t, unit_dt * (1 << L))
            if out is None:
                stats.empty_advances += 1
                pending.append((L, zero))
                continue
            n_up += out[0]
            pending.append((L, out[1]))
        step = 1 << cur.min_lev
        tick += step
        t = np.float32(t + unit32 * np.float32(step))
    add_drifts()
    return cur, st, t, steps.all_sum(n_up), drifts.max(), stats


def bucketed_frame_carry(st, t, cfg: SimConfig, colliders, frame_dt, unit_dt, K: int,
                         strength_dt_mul=1.0, cfl_dt_mul=1.0, lev_fn=None, fused: bool = True):
    """One frame of per-block bucketed time stepping on the packed state
    `st` (any lane order; it is sorted first, as the JAX frame packs and
    sorts its particles). frame_dt must be an integer multiple of
    unit_dt * 2^MAXLEV. `lev_fn(pm)`, where given, replaces the levels
    (a testing hook). Returns (carry (st, keys, pm, drift), t, n_updates,
    FrameStats): keys and page map of the last sort (capacity K or more,
    grown at a sort that overflows it), the largest level drift since.
    Every frame starts with a sort, whatever the carry's drift."""

    def level_fn(st_s, pm):
        if lev_fn is not None:
            return lev_fn(pm)
        return slot_levels(st_s, pm, cfg, unit_dt, strength_dt_mul, cfl_dt_mul)

    cur, st, t, n_up, drift, stats = tick_loop(st, t, cfg, frame_dt, unit_dt, K,
                                               OneDevice(cfg, colliders, level_fn, fused))
    stats.host_reads += 1
    drift, n = host_read(torch.stack([drift.double(), n_up.double()]))
    stats.n_updates = int(n)
    return (st, cur.keys, cur.pm, np.float32(drift)), t, stats.n_updates, stats


def bucketed_frame(p: Particles, t, cfg: SimConfig, colliders, frame_dt, unit_dt, K: int,
                   strength_dt_mul=1.0, cfl_dt_mul=1.0, lev_fn=None, fused: bool = True):
    """``bucketed_frame_carry`` from and to a Particles set (the JAX
    module's form: pack at the start, unpack in sorted lane order at the
    end). Returns (p, t, n_updates, FrameStats)."""
    carry, t, n_up, stats = bucketed_frame_carry(
        packed.pack_particles(p), t, cfg, colliders, frame_dt, unit_dt, K, strength_dt_mul,
        cfl_dt_mul, lev_fn, fused)
    return packed.unpack_particles(carry[0], p.capacity), t, n_up, stats
