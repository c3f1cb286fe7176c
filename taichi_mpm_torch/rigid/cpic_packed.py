"""CPIC on the packed path (torch counterpart of
``taichi_mpm_tpu.rigid.cpic_packed``, single device, fixed or global
adaptive dt, the fused route).

The coupled substep runs compute-then-correct CPIC over the (48, Pw)
packed state (row map in ``ops/rows.py``):

* rigid prologue: rigidify, articulate, rasterize the CDF;
* the near-rigid compaction: lanes of tagged blocks read off the page
  map, then the exact stencil test;
* the CDF gather on that near set; the affinity rows 37-42 are rebuilt
  from zero and written back;
* bulk P2G: the fused prep + P2G kernel (``ops/p2g.p2g_fused``), merged
  into node records; the P2G correction on the near set; the rigid
  impulses; the grid update and the windows;
* bulk G2P: the gather-only kernel (``ops/g2p.g2p_blocked``), the G2P
  correction added into its rows between gather and finish (the F update
  must see the corrected B), then ``finish_packed``;
* the boundary penetration penalty on the near set and the body advance.

Where the JAX package keeps control flow on the device (``lax.cond``,
``while_loop``), this frame reads a value on the host, which waits for
the card. Per substep: the bodies, for the host-side rigid-rigid solve
(``rigid/host.py``); the use-time check of the lazy rigid page map; the
near set's two sizes (coarse and exact: the set is sized to them); and
one read of max|v| together with the map's staleness (and, at adaptive
dt, the next dt limit) after the advance. ``HostSyncs.count`` counts
them.

Capacities: where the JAX package's MPM re-runs a frame that overflowed
its near budget, coarse budget b1, rigid page map Kr or page map K, this
frame has no near budgets (the near set is sized to its exact counts)
and grows Kr where the rigid map is built, K at the sort. Neither
changes a value: they only size maps, and the corrections and sums run
over the valid lanes only.

Determinism: the only float sums whose order a scatter decides are the
P2G correction's record updates and the penalty impulses; they go
through ``utils.index_add_ordered``, which keeps a fixed order on the
card, so the frame gives the same bits on every run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.ops import blocked, g2p, p2g, packed
from taichi_mpm_torch.ops.rows import (
    RACT, RMASS, RNEARB, RSTATES, RV, RX,
)
from taichi_mpm_torch.ops.substep import grid_update_flat
from taichi_mpm_torch.rigid import cdf
from taichi_mpm_torch.rigid.body import (
    accumulate_impulses,
    advance,
    apply_impulses,
    boundary_particle_world,
)
from taichi_mpm_torch.rigid.collision import rigid_levelset_collision
from taichi_mpm_torch.rigid.cpic_blocked import (
    g2p_correction,
    local_x,
    near_rigid_lanes,
    p2g_correction,
    rigid_map,
    rigid_prologue,
    summed,
)
from taichi_mpm_torch.utils import host_read

DRIFT_BOUND = packed.DRIFT_BOUND


@dataclasses.dataclass
class Capacities:
    """The rigid page map's capacity Kr (0 = dense CDF), grown on
    overflow (``grown``) and kept across frames."""

    Kr: int


def gather_mini(st, idx):
    """The (48, B) packed rows of the lanes idx."""
    return st[:, idx]


def compact_near_rigid_packed(st, pm, node_states, cfg: SimConfig,
                              fast_stage2: bool = False, world_off=None):
    """The near-rigid set on packed rows (``cpic_blocked.near_rigid_lanes``
    over the state's position and affinity rows); on a slab `cfg` is the
    local grid config and the (global) positions are shifted by
    -world_off. Returns (idx (n_near,), n_near, n_coarse), both counts
    read on the host."""
    return near_rigid_lanes(pm, node_states, cfg,
                            lambda i: local_x(st[RX:RX + 3, i].t(), world_off),
                            lambda i: st[RSTATES, i].view(torch.int32), fast_stage2)


def _write_rows(st, r0, idx, values):
    """st[r0 + k, idx] = values[k] for the rows of `values` (k, B)."""
    st[r0:r0 + values.shape[0], idx] = values


def cpic_packed_substep_presorted(st, pm, bodies, t, cfg: SimConfig, scene, dt,
                                  caps: Capacities, rmap=None, marks=None,
                                  lcfg: SimConfig = None, world_off=None, grid_colliders=None,
                                  exchange_fn=None, sum_fn=None):
    """One coupled substep on a sorted packed state (origins annotated by
    the sort) against its frozen page map; `st` is replaced, not updated
    in place. rmap: the lazily kept rigid page map (Kr > 0). marks, where
    given, is a callable called with the name of each stage as it ends
    (timing). Returns ((st, bodies, t + dt), n_near, n_coarse, n_r, vmax,
    plast) with vmax and plast as 0-d device tensors.

    The slab frames' hooks are those of
    ``cpic_blocked.cpic_blocked_substep_presorted`` (`lcfg`, `world_off`,
    `grid_colliders`, `exchange_fn`, `sum_fn`); the origin rows of `st`
    already hold the slab's offset."""
    mark = marks or (lambda name: None)
    gcfg = cfg if lcfg is None else lcfg
    R = bodies.num
    dt32 = np.float32(dt)

    bodies, ncdf, n_r, xb = rigid_prologue(bodies, scene, cfg, dt, caps, rmap=rmap, gcfg=gcfg,
                                           world_off=world_off)
    mark("prologue")

    idx, n_near, n_coarse = compact_near_rigid_packed(st, pm, ncdf, gcfg,
                                                      fast_stage2=rmap is not None,
                                                      world_off=world_off)
    mini = gather_mini(st, idx)
    x_loc = local_x(mini[RX:RX + 3].t(), world_off)
    nd = cdf.stencil_node_data(x_loc, ncdf, gcfg)
    st_c, bd_c, bn_c, nb_c = cdf.gather_cdf_lookup(
        x_loc, mini[RSTATES].view(torch.int32), R, gcfg, nd)
    # affinity rows 37-42 rebuilt from zero (leaving the neighbourhood
    # clears affinity); only the near lanes carry values
    aff = torch.cat([st_c.view(torch.float32)[None], bd_c[None], bn_c.t(),
                     nb_c.to(torch.float32)[None]])
    st = st.clone()
    st[RSTATES:RNEARB + 1] = 0.0
    _write_rows(st, RSTATES, idx, aff)
    mini[RSTATES:RNEARB + 1] = aff
    mark("compact_and_cdf")

    tiles = p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg)
    mark("p2g_kernel")
    rec = blocked.merge_tiles(tiles, pm["nbr"])
    mark("merge_tiles")
    rec, J1, tau1 = p2g_correction(mini, nd, pm, bodies, rec, gcfg, dt, world_off)
    if exchange_fn is not None:
        rec = exchange_fn(rec)
    bodies = apply_impulses(bodies, *summed(sum_fn, J1, tau1))
    if scene.colliders:
        bodies = rigid_levelset_collision(bodies, xb, scene.bp_rid, scene.colliders, t, dt)
    mark("p2g_correction")

    vrec = grid_update_flat(rec, pm["ids"], gcfg,
                            scene.colliders if grid_colliders is None else grid_colliders, t, dt)
    mark("grid_update")
    win = blocked.windows(vrec, pm["nbr"])
    mark("windows")
    pout = g2p.g2p_blocked(pm["slot_keys"], st, win, cfg)
    mark("g2p_blocked_kernel")
    dv, dB, rid_last = g2p_correction(mini, nd, pm, bodies, vrec, gcfg, dt, world_off)
    vmask = mini[RACT] > 0.5
    corr = torch.cat([dv.t(), dB.reshape(-1, 9).t()])
    pout[:, idx] += torch.where(vmask, corr, 0.0)  # the near lanes are distinct
    mark("g2p_correction")

    st, vmax, plast = g2p.finish_packed(st, pout, cfg, dt, zero_C=st[RNEARB] > 0.5)
    mark("finish")

    # boundary penetration penalty (transfer.cpp:671-682) on the near set
    act_c = st[RACT, idx] > 0.5
    pen = (act_c & vmask & nb_c & (bd_c < -0.05 * cfg.dx) & (bd_c > -0.3 * cfg.dx))
    dvp = bd_c[:, None] * bn_c * cfg.penalty
    v_c = st[RV:RV + 3, idx]
    _write_rows(st, RV, idx, torch.where(pen, v_c - dvp.t(), v_c))
    # torque arms at the advected positions
    x_pen = st[RX:RX + 3, idx].t()
    J2, tau2 = accumulate_impulses(bodies, torch.clamp(rid_last, 0, R - 1),
                                   dvp * mini[RMASS][:, None], x_pen, pen & (rid_last >= 0))
    bodies = apply_impulses(bodies, *summed(sum_fn, J2, tau2))
    if cfg.particle_collision:
        st = packed.particle_collision_packed(st, cfg, scene.colliders, t)
    if cfg.clean_boundary:
        st = packed.clean_boundary_packed(st, cfg)
    mark("penalty")
    bodies = advance(bodies, t, dt, scene.pos_funcs, scene.rot_funcs, cfg.gravity)
    mark("advance")
    return (st, bodies, np.float32(t) + dt32), n_near, n_coarse, n_r, vmax, plast


def _lazy_rmap(bodies, scene, cfg: SimConfig, caps: Capacities):
    """The frame's lazy rigid page map: dilate=4, check plane at +1 (the
    margins that keep the rasterize and the fast stage-2 test exact)."""
    xb, _, _ = boundary_particle_world(bodies, scene.bp_rid, scene.bp_offset,
                                       scene.bp_normal, scene.bp_elem)
    return rigid_map(xb, cfg, caps, dilate=4, chk_dilate=1)


def _bp_blocks_ok(bodies, scene, cfg: SimConfig, chk):
    xb, _, _ = boundary_particle_world(bodies, scene.bp_rid, scene.bp_offset,
                                       scene.bp_normal, scene.bp_elem)
    return torch.all(chk[cdf.block_id_of(xb, cfg)])


def cpic_frame_loop(carry, bodies, t, cfg: SimConfig, scene, sched, caps: Capacities,
                    marks=None):
    """A CPIC frame over a persistent packed carry (st, keys, pm, drift)
    on the schedule `sched` (``packed.FixedDt`` or ``packed.AdaptiveDt``),
    the lazy re-sort continuing across frames. Two-level loop: coupled
    substeps run while the schedule has more, the drift stays below 0.45
    cell and the lazy rigid page map (caps.Kr > 0) still covers every
    boundary particle; then the state is re-sorted (when the drift
    demands it) and the map rebuilt (when stale). After each substep one
    host read takes max|v|, the map's staleness and an adaptive
    schedule's next dt limit. Returns (carry, bodies, t, max n_act,
    max n_near, max n_coarse, max n_r, n_sorts, plast, n_substeps)."""
    st, keys, pm, drift = carry
    drift = np.float32(drift)
    lazy = caps.Kr > 0
    rm = _lazy_rmap(bodies, scene, cfg, caps) if lazy else None
    nmax = int(pm["n_act"])
    nnear = ncoarse = nsorts = n = 0
    nr = rm[2] if lazy else 0
    stale = False
    plast = torch.zeros((), dtype=torch.int32, device=st.device)
    lim = sched.limit(st)
    if lim is not None:
        lim = np.float32(host_read(lim))
    while sched.more(t, n) or drift >= DRIFT_BOUND:
        while sched.more(t, n) and drift < DRIFT_BOUND and not stale:
            dt = sched.next_dt(t, lim)
            (st, bodies, t), n_near, n_coarse, n_r, vmax, dplast = (
                cpic_packed_substep_presorted(st, pm, bodies, t, cfg, scene, dt, caps,
                                              rmap=rm, marks=marks))
            ok = (_bp_blocks_ok(bodies, scene, cfg, rm[3]).to(torch.float32)
                  if lazy else None)
            vmax_h, (ok_h, lim) = packed.read_substep(vmax, ok, sched.limit(st))
            stale = lazy and ok_h < 0.5
            drift = drift + sched.drift(dt, vmax_h)
            plast = plast + dplast
            n += 1
            nnear, ncoarse, nr = max(nnear, n_near), max(ncoarse, n_coarse), max(nr, n_r)
        need = drift >= DRIFT_BOUND
        if need:
            st, keys, pm = packed.sort_and_map(st, cfg, pm["ids"].shape[0])
            drift = np.float32(0.0)
            nsorts += 1
            nmax = max(nmax, int(pm["n_act"]))
        if lazy and stale:
            rm = _lazy_rmap(bodies, scene, cfg, caps)
            nr = max(nr, rm[2])
            stale = False
    return (st, keys, pm, drift), bodies, t, nmax, nnear, ncoarse, nr, nsorts, plast, n


def cpic_packed_frame_carry(carry, bodies, t, cfg: SimConfig, scene, dt, n_substeps: int,
                            caps: Capacities, marks=None):
    """A fixed-dt CPIC frame over a persistent packed carry
    (``cpic_frame_loop``). Returns (carry, bodies, t, max n_act,
    max n_near, max n_coarse, max n_r, n_sorts, plast)."""
    return cpic_frame_loop(carry, bodies, t, cfg, scene, packed.FixedDt(dt, n_substeps, cfg),
                           caps, marks)[:9]


def cpic_packed_adaptive_frame_carry(carry, bodies, t, cfg: SimConfig, scene, frame_dt,
                                     unit_dt, max_dt, caps: Capacities, strength_dt_mul=1.0,
                                     cfl_dt_mul=1.0, max_substeps: int = 100000, marks=None,
                                     dts=None):
    """A global adaptive-dt CPIC frame over a persistent packed carry
    (the JAX package's ``cpic_packed_adaptive_frame_carry``: the loop of
    the fixed-dt frame, ending when t reaches t + frame_dt, each dt the
    snapped global limit of the packed rows). The dt limit is read with
    max|v| and the staleness, so it adds no host sync per substep; `dts`,
    where given, is a list the substeps' dt are appended to. Returns
    (carry, bodies, t, max n_act, max n_near, max n_coarse, max n_r,
    n_sorts, plast, n_substeps)."""
    sched = packed.AdaptiveDt(t, cfg, frame_dt, unit_dt, max_dt, strength_dt_mul,
                              cfl_dt_mul, max_substeps)
    out = cpic_frame_loop(carry, bodies, t, cfg, scene, sched, caps, marks)
    if dts is not None:
        dts.extend(sched.dts)
    return out


def cpic_packed_pack_carry(p: Particles, cfg: SimConfig, K: int):
    """The persistent packed CPIC carry (st, keys, pm, drift)."""
    return packed.pack_carry(p, cfg, K)


def cpic_packed_frame(p: Particles, bodies, t, cfg: SimConfig, scene, dt, n_substeps: int,
                      K: int, caps: Capacities):
    """A CPIC frame from and to a Particles set (pack, sort and unpack at
    the frame edges). Returns (p, bodies, t, max n_act, max n_near,
    max n_coarse, max n_r, n_sorts, plast); the sort count includes the
    initial sort."""
    carry = cpic_packed_pack_carry(p, cfg, K)
    carry, bodies, t, nmax, nnear, ncoarse, nr, nsorts, plast = cpic_packed_frame_carry(
        carry, bodies, t, cfg, scene, dt, n_substeps, caps)
    return (packed.unpack_particles(carry[0], p.capacity), bodies, t, nmax, nnear, ncoarse,
            nr, nsorts + 1, plast)
