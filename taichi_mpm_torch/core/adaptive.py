"""Global adaptive time stepping (torch counterpart of
``taichi_mpm_tpu.core.adaptive``, its global path).

Each substep takes the largest dt that the material sound-speed limit
(x ``strength_dt_mul``) and the advection CFL dx / max|v| (x
``cfl_dt_mul``) allow over all active particles, snapped down to
``unit_delta_t * 2^k`` and clamped to [unit_delta_t, base_delta_t], and
the frame ends when t reaches t + frame_dt. The limit is reduced on the
card and read with the substep's max|v| (one host read per substep);
the snapping runs on the host in float32, reproducing the JAX package's
arithmetic as XLA compiles it (``snap_pot``), so that the substep count
is the reference's.

On the dense path (2-D scenes, kernel orders 1 and 3,
``optimized=False``) the frame is ``adaptive_frame_fn``: the dense
substeps of ``core.solver`` at that dt, the limit read once per substep.
A scene with rigid bodies runs ``adaptive_cpic_frame_fn`` there, the
coupled substeps of ``rigid.cpic`` at that dt; so does a CPIC scene of
the blocked path with ``TMT_FUSED=0``, as in the JAX package (the packed
adaptive CPIC frame runs on the fused route only).

``AsyncMPM(per_block=True)`` runs the per-block bucketed scheduler
instead (``ops.async_bucketed``): a power-of-two dt level per grid block,
the largest level advanced first at each tick, slower neighbours read
from their backups. As in the JAX package it takes every 3-D scene of
particles to the packed path (whatever ``optimized``), on the route
``TMT_FUSED`` selects, and refuses 2-D scenes and rigid bodies. The unit
is snapped so that frame_dt = m * unit * 2^MAXLEV.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.solver import MPM, substep
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.materials import models as materials
from taichi_mpm_torch.ops import async_bucketed, packed
from taichi_mpm_torch.ops.async_bucketed import LN_2, LOG2_E
from taichi_mpm_torch.ops.rows import RACT, RX
from taichi_mpm_torch.rigid import cpic, cpic_packed
from taichi_mpm_torch.utils import host_read



def dt_limit(p: Particles, cfg: SimConfig, strength_dt_mul: float = 1.0,
             cfl_dt_mul: float = 1.0):
    """Global allowed dt of a Particles set, a 0-d tensor: min over active
    particles of the material sound-speed limit and the advection CFL."""
    speed = torch.sqrt(materials.sum_last(p.v * p.v))
    a_dt = materials.dispatch_allowed_dt(
        cfg.active_materials, p.mat, p.F, p.aux, p.params, p.vol, p.mass, speed, cfg.dx)
    strength = torch.min(torch.where(p.active, a_dt, 1e30)) * strength_dt_mul
    vmax = torch.max(torch.where(p.active, speed, 0.0))
    cfl = torch.full_like(vmax, cfl_dt_mul * cfg.dx) / torch.clamp(vmax, min=1e-30)
    return torch.minimum(strength, cfl)


def _log_f32(x):
    # the float32 logarithm rounded from float64: where it and XLA's
    # float32 log differ, they differ by one ulp away from the points
    # where floor(log2) changes (checked over ratios 1 to 2^40)
    return np.log(np.asarray(x, np.float64)).astype(np.float32)


def _exp_f32(x):
    return np.exp(np.asarray(x, np.float64)).astype(np.float32)


def snap_pot(dt, unit_dt: float, max_dt: float):
    """Snap dt down to unit_dt * 2^k (the async scheduler's power-of-two
    buckets), clamped to [unit_dt, max_dt]; float32 on the host.

    The JAX package computes ``floor(log2(max(dt / unit_dt, 1)))`` inside
    a jitted frame, where XLA turns the division by the constant unit_dt
    into a product with its float32 reciprocal, log2 into log times
    1.44269502 and exp2(k) into exp(k * 0.693147182). A float32 log2 is
    not exact at powers of two (floor(log2(2^13)) is 12 there), so this
    repeats those steps, and gives JAX's bits for every dt."""
    unit = np.float32(unit_dt)
    ratio = np.maximum(np.float32(dt) * async_bucketed.reciprocal_f32(unit_dt), np.float32(1.0))
    k = np.floor(_log_f32(ratio) * LOG2_E)
    snapped = unit * _exp_f32(k * LN_2)
    return np.minimum(np.maximum(snapped, unit), np.float32(max_dt))


def adaptive_frame_fn(p: Particles, t, cfg: SimConfig, colliders, frame_dt, unit_dt, max_dt,
                      strength_dt_mul: float = 1.0, cfl_dt_mul: float = 1.0,
                      max_substeps: int = 100000, xg=None, dts=None):
    """A dense frame at global adaptive dt: substeps until t reaches t +
    frame_dt, each of dt = min(snap_pot(dt_limit), t_end - t) on the
    schedule of ``ops.packed.AdaptiveDt`` (the JAX package's arithmetic,
    so the substep count is the reference's). One host read per substep:
    the dt limit. `xg` are the node positions; `dts`, where given, is a
    list the substeps' dt are appended to. Returns (p, t, n_substeps, the
    plasticity count as a 0-d tensor)."""
    sched = packed.AdaptiveDt(t, cfg, frame_dt, unit_dt, max_dt, strength_dt_mul, cfl_dt_mul,
                              max_substeps)
    count = torch.zeros((), dtype=torch.int64, device=p.device)
    n = 0
    while sched.more(t, n):
        lim = np.float32(host_read(dt_limit(p, cfg, strength_dt_mul, cfl_dt_mul)))
        p, t, c = substep(p, t, cfg, colliders, sched.next_dt(t, lim), xg)
        count = count + c
        n += 1
    if dts is not None:
        dts.extend(sched.dts)
    return p, t, n, count


def adaptive_cpic_frame_fn(p: Particles, bodies, t, cfg: SimConfig, scene, frame_dt, unit_dt,
                           max_dt, strength_dt_mul: float = 1.0, cfl_dt_mul: float = 1.0,
                           max_substeps: int = 100000, xg=None, dts=None):
    """A dense CPIC frame at global adaptive dt: ``rigid.cpic.cpic_substep``
    until t reaches t + frame_dt, each of dt = min(snap_pot(dt_limit), t_end
    - t), the schedule of ``adaptive_frame_fn``. One host read per substep
    (the dt limit), besides the host's rigid solves where the scene has
    articulations. Returns (p, bodies, t, n_substeps, the plasticity count
    as a 0-d tensor)."""
    sched = packed.AdaptiveDt(t, cfg, frame_dt, unit_dt, max_dt, strength_dt_mul, cfl_dt_mul,
                              max_substeps)
    count = torch.zeros((), dtype=torch.int64, device=p.device)
    n = 0
    while sched.more(t, n):
        lim = np.float32(host_read(dt_limit(p, cfg, strength_dt_mul, cfl_dt_mul)))
        p, bodies, t, c = cpic.cpic_substep(p, bodies, t, cfg, scene, sched.next_dt(t, lim), xg)
        count = count + c
        n += 1
    if dts is not None:
        dts.extend(sched.dts)
    return p, bodies, t, n, count


class AsyncMPM(MPM):
    """Solver with adaptive dt (the reference's ``async_mpm`` simulation
    type). base_delta_t is the largest dt, unit_delta_t the power-of-two
    unit. At global adaptive dt (per_block=False) plain scenes run on
    either route (``TMT_FUSED``); CPIC scenes on the fused route, or,
    with TMT_FUSED=0 and on the dense path, ``adaptive_cpic_frame_fn``.
    per_block=True runs the per-block bucketed scheduler
    (``ops.async_bucketed``) on 3-D scenes without rigid bodies.

    ``update_counter`` sums the particle updates over the frames (the
    reference's work counter: substeps x active particles at global dt,
    committed bucket advances per block); ``last_substeps`` is the newest
    frame's substep count (per block: its bucket advances) and
    ``last_dt_range`` its smallest and largest dt; ``last_frame_stats``
    the newest bucketed frame's ``async_bucketed.FrameStats``. The dense
    path runs ``adaptive_frame_fn``, with rigid bodies
    ``adaptive_cpic_frame_fn``."""

    def __init__(self, *args, unit_delta_t: float = 1e-6, strength_dt_mul: float = 1.0,
                 cfl_dt_mul: float = 1.0, per_block: bool = False, **kw):
        super().__init__(*args, **kw)
        self.unit_delta_t = unit_delta_t
        self.strength_dt_mul = strength_dt_mul
        self.cfl_dt_mul = cfl_dt_mul
        self.per_block = per_block
        self.update_counter = 0
        self.last_substeps = 0
        self.last_dt_range = None
        self.last_frame_stats = None

    def _use_blocked(self) -> bool:
        """MPM's gate, but a CPIC scene takes the blocked path on the fused
        route only: with TMT_FUSED=0 it runs the dense CPIC frame. The
        per-block scheduler takes the packed path, on the JAX package's
        conditions: 3-D scenes without rigid bodies."""
        if self.per_block:
            if self.bodies is not None:
                raise ValueError("per-block bucketed dt + CPIC not supported; use "
                                 "AsyncMPM(per_block=False) for global adaptive dt")
            if self.cfg.dim != 3:
                raise ValueError("per-block buckets are 3D-only")
            return True
        return super()._use_blocked() and (self.bodies is None or self.fused)

    def bucket_unit(self, frame_dt: Optional[float] = None) -> float:
        """The per-block scheduler's unit: unit_delta_t snapped so that
        frame_dt = m * unit * 2^MAXLEV (m >= 1)."""
        return async_bucketed.snapped_unit(frame_dt or self.frame_dt, self.unit_delta_t)

    def step(self, frame_dt: Optional[float] = None):
        """Advance one frame of frame_dt (default self.frame_dt) at
        adaptive dt. Returns the particles, as the reference does (read
        from the carry, which unpacks them)."""
        fresh = self._pcarry is None
        self._prepare_frame()
        fdt = frame_dt or self.frame_dt
        if self.per_block:
            return self._step_bucketed(fdt)
        args = (fdt, self.unit_delta_t, self.cfg.base_dt, self.strength_dt_mul,
                self.cfl_dt_mul)
        dts = []
        if not self._blocked and self.bodies is not None:
            p, self.bodies, t, n, plast = self._live_frame(lambda q: adaptive_cpic_frame_fn(
                q, self.bodies, self.t, self.cfg, self.rigid_scene, *args, xg=self._xg,
                dts=dts))
            self._end_dense_frame(p, t, plast)
            self._record(n, dts, int(p.active.sum()))
            return p
        if not self._blocked:
            p, t, n, plast = adaptive_frame_fn(self._particles, self.t, self.cfg,
                                               tuple(self.colliders), *args, xg=self._xg,
                                               dts=dts)
            self._end_dense_frame(p, t, plast)
            self._record(n, dts, int(p.active.sum()))
            return p
        if self.bodies is not None:
            out = cpic_packed.cpic_packed_adaptive_frame_carry(
                self._pcarry, self.bodies, self.t, self.cfg, self.rigid_scene, args[0],
                args[1], args[2], self.cpic_caps, *args[3:], dts=dts)
            carry, self.bodies, t, nmax, nnear, ncoarse, nr, nsorts, plast, n = out
            self.cpic_stats = dict(n_act=nmax, n_near=nnear, n_coarse=ncoarse, n_r=nr)
        else:
            if not fresh:
                # a plain frame starts sorted at zero drift, as the JAX
                # package's packed_adaptive_frame packs and sorts each frame
                st, keys, pm = packed.sort_and_map(self._pcarry[0], self.cfg,
                                                   self.block_capacity)
                self._pcarry = (st, keys, pm, np.float32(0.0))
                self.n_sorts += 1
            carry, t, _, nsorts, plast, n = packed.packed_adaptive_frame_carry(
                self._pcarry, self.t, self.cfg, tuple(self.colliders), *args,
                fused=self.fused, dts=dts)
        self._end_frame(carry, t, nsorts, plast)
        self._record(n, dts, int((carry[0][RACT] > 0.5).sum()))
        return self.particles

    def _step_bucketed(self, fdt):
        """One per-block bucketed frame over the packed carry
        (``async_bucketed.bucketed_frame_carry``, which sorts first, as
        the JAX package's frame packs and sorts its particles)."""
        unit = self.bucket_unit(fdt)
        carry, t, n_up, stats = async_bucketed.bucketed_frame_carry(
            self._pcarry[0], self.t, self.cfg, tuple(self.colliders), fdt, unit,
            self.block_capacity, self.strength_dt_mul, self.cfl_dt_mul, fused=self.fused)
        self._end_frame(carry, t, stats.sorts, 0)
        self.update_counter += n_up
        self.last_substeps = stats.n_substeps
        used = [L for L, n in enumerate(stats.advances) if n]
        self.last_dt_range = ((unit * (1 << used[0]), unit * (1 << used[-1])) if used
                              else None)
        self.last_frame_stats = stats
        return self.particles

    def visualize_scheduler(self, path: str, writer: str = "native"):
        """The scheduler's state per active particle as BGEO (the
        reference's async debug output): the material strength dt limit,
        the advection CFL limit and the combined limit; per block, the
        particle's block dt level and dt (``dt_level``, ``dt_block``) of
        the current particles sorted afresh, in sorted order."""
        from taichi_mpm_torch.io.bgeo import write_bgeo

        self._ensure_finalized()
        p, cfg = self.particles, self.cfg
        if self.per_block:
            unit = self.bucket_unit()
            st, keys = packed.sort_packed(packed.pack_particles(p), cfg)
            pm = packed.build_page_map_packed(keys, cfg, self._active_block_cap())
            lev = async_bucketed.slot_levels(st, pm, cfg, unit, self.strength_dt_mul,
                                             self.cfl_dt_mul)
            K = lev.shape[0]
            sk = pm["slot_keys"]
            lane_lev = torch.where(sk < K, lev[torch.clamp(sk, max=K - 1).long()], -1)
            act = (st[RACT] > 0.5).cpu().numpy()
            lane_lev = lane_lev.cpu().numpy()[act]
            write_bgeo(path, st[RX:RX + 3].t().cpu().numpy()[act],
                       {"dt_level": lane_lev.astype(np.float32),
                        "dt_block": (unit * np.exp2(lane_lev)).astype(np.float32)},
                       writer=writer)
            return
        speed = torch.sqrt(materials.sum_last(p.v * p.v))
        a_dt = materials.dispatch_allowed_dt(cfg.active_materials, p.mat, p.F, p.aux, p.params,
                                             p.vol, p.mass, speed, cfg.dx)
        cfl = torch.full_like(speed, self.cfl_dt_mul * cfg.dx) / torch.clamp(speed, min=1e-30)
        strength = a_dt * self.strength_dt_mul
        limit = torch.minimum(strength, cfl)
        act = p.active
        write_bgeo(path, p.x[act].cpu().numpy(),
                   {"limit_strength": strength[act].cpu().numpy(),
                    "limit_cfl": cfl[act].cpu().numpy(), "limit": limit[act].cpu().numpy()},
                   writer=writer)

    def _record(self, n: int, dts, n_active: int):
        self.last_substeps = n
        self.last_dt_range = (float(min(dts)), float(max(dts))) if dts else None
        self.update_counter += n * n_active
