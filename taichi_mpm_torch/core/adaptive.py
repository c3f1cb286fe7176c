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

``AsyncMPM(per_block=True)``, the per-block bucketed scheduler, is not
ported (ROADMAP.md queue 1, "per-block bucketed async").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.solver import MPM, substep
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.materials import models as materials
from taichi_mpm_torch.ops import packed
from taichi_mpm_torch.ops.rows import RACT
from taichi_mpm_torch.rigid import cpic, cpic_packed
from taichi_mpm_torch.utils import host_read

# The constants XLA compiles jnp.log2 and jnp.exp2 with: log2(x) is
# log(x) * 1.44269502 and exp2(k) is exp(k * 0.693147182), in float32.
_LOG2_E = np.float32(1.44269502)
_LN_2 = np.float32(0.693147182)


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
    ratio = np.maximum(np.float32(dt) * np.float32(1.0 / np.float64(unit)), np.float32(1.0))
    k = np.floor(_log_f32(ratio) * _LOG2_E)
    snapped = unit * _exp_f32(k * _LN_2)
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
    """Solver with global adaptive dt (the reference's ``async_mpm``
    simulation type on the JAX package's global path). base_delta_t is
    the largest dt, unit_delta_t the power-of-two unit. Plain scenes run
    on either route (``TMT_FUSED``); CPIC scenes on the fused route, or,
    with TMT_FUSED=0 and on the dense path, ``adaptive_cpic_frame_fn``.

    ``update_counter`` sums substeps x active particles over the frames
    (the reference's work counter); ``last_substeps`` is the newest
    frame's substep count and ``last_dt_range`` its smallest and largest
    dt. The dense path runs ``adaptive_frame_fn``, with rigid bodies
    ``adaptive_cpic_frame_fn``."""

    def __init__(self, *args, unit_delta_t: float = 1e-6, strength_dt_mul: float = 1.0,
                 cfl_dt_mul: float = 1.0, per_block: bool = False, **kw):
        if per_block:
            raise NotImplementedError(
                "AsyncMPM(per_block=True), the per-block bucketed scheduler "
                "(ops/async_bucketed.py), is not ported yet "
                "(ROADMAP.md queue 1, 'per-block bucketed async'); "
                "use per_block=False for global adaptive dt")
        super().__init__(*args, **kw)
        self.unit_delta_t = unit_delta_t
        self.strength_dt_mul = strength_dt_mul
        self.cfl_dt_mul = cfl_dt_mul
        self.update_counter = 0
        self.last_substeps = 0
        self.last_dt_range = None

    def _use_blocked(self) -> bool:
        """MPM's gate, but a CPIC scene takes the blocked path on the fused
        route only: with TMT_FUSED=0 it runs the dense CPIC frame."""
        return super()._use_blocked() and (self.bodies is None or self.fused)

    def step(self, frame_dt: Optional[float] = None):
        """Advance one frame of frame_dt (default self.frame_dt) at
        adaptive dt. Returns the particles, as the reference does (read
        from the carry, which unpacks them)."""
        fresh = self._pcarry is None
        self._prepare_frame()
        fdt = frame_dt or self.frame_dt
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

    def _record(self, n: int, dts, n_active: int):
        self.last_substeps = n
        self.last_dt_range = (float(min(dts)), float(max(dts))) if dts else None
        self.update_counter += n * n_active
