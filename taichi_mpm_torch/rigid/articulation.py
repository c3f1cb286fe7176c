"""Articulation constraints between rigid bodies (counterpart of
``taichi_mpm_tpu.rigid.articulation``, 2-D and 3-D).

Velocity-level constraint projection run as apply -> N x project ->
penalize (the reference's MPM::articulate, default 100 iterations), for
the six reference kinds: rotation, frozen, distance, axial_rotation,
motor, stepper. The projections run on a host copy of the bodies
(``rigid/host.py``), in numpy float32 with the JAX package's formulas and
operation order: a scene has a handful of bodies, and each projection is
a few 3-vector operations. Parameters are converted to body frames at
scene-build time (host-side, numpy). In 2-D the torques and angular
velocities are scalars, the axial kinds hold one anchor pair and no
axis, and "frozen" zeroes only the angular velocity (the JAX package's
writes to the missing components are dropped).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from taichi_mpm_torch.rigid.body import RigidBodies
from taichi_mpm_torch.rigid.host import HostBodies, dot, explicit_inv, matvec, rotate

_ZERO = np.float32(0.0)
_TINY = np.float32(1e-30)
_EYE12 = np.float32(1e-12) * np.eye(3, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class Articulation:
    """Static articulation descriptor. Offsets/axis are body-frame."""

    kind: str
    obj: Tuple[int, int]
    offset0: Tuple[float, ...] = ()
    offset1: Tuple[float, ...] = ()
    anchors0: Tuple = ()  # ((o0a, o1a), (o0b, o1b)) body-frame offsets
    axis_body: Tuple[float, ...] = ()  # in obj1's body frame (3-D)
    target_distance: float = 0.0
    penalty: float = 1e3
    power: float = 0.0
    angular_velocity: float = 0.0


def _anchor(hb: HostBodies, i: int, offset_body):
    return hb.pos[i] + rotate(hb.rot[i], np.asarray(offset_body, np.float32))


def _norm(v):
    return np.sqrt(dot(v, v))


def _anchor_pair(hb: HostBodies, i0, i1, off0, off1):
    """The two world anchors, the unit direction from p1 to p0 and their
    distance."""
    p0 = _anchor(hb, i0, off0)
    p1 = _anchor(hb, i1, off1)
    n = p0 - p1
    dist = _norm(n)
    return p0, p1, n / np.maximum(dist, np.float32(1e-10)), dist


def _distance_project(hb: HostBodies, i0, i1, off0, off1):
    """Remove the relative normal velocity at the anchor pair."""
    p0, p1, n, dist = _anchor_pair(hb, i0, i1, off0, off1)
    v01 = hb.velocity_at(i0, p0) - hb.velocity_at(i1, p1)
    k0 = hb.impulse_contribution(i0, p0 - hb.pos[i0], n)
    k1 = hb.impulse_contribution(i1, p1 - hb.pos[i1], n)
    j = _ZERO if dist < 1e-10 else dot(n, v01) / np.maximum(k0 + k1, _TINY)
    hb.impulse(i0, -j * n, p0)
    hb.impulse(i1, j * n, p1)


def _distance_penalize(hb: HostBodies, i0, i1, off0, off1, target, penalty, dt):
    """Positional drift correction."""
    p0, p1, n, dist = _anchor_pair(hb, i0, i1, off0, off1)
    j = _ZERO if dist < 1e-10 else np.float32(-dt * penalty) * (np.float32(target) - dist)
    hb.impulse(i0, -j * n, p0)
    hb.impulse(i1, j * n, p1)


def _project_one(hb: HostBodies, a: Articulation):
    i0, i1 = a.obj
    if a.kind == "rotation":
        hb.project_rotation(i0, i1)
    elif a.kind == "frozen":
        # zero x/y angular velocity and z linear velocity of obj0 (in 2-D
        # the angular velocity only)
        hb.omega[i0, :2] = 0.0
        if hb.dim == 3:
            hb.vel[i0, 2] = 0.0
    elif a.kind == "distance":
        _distance_project(hb, i0, i1, a.offset0, a.offset1)
    elif a.kind in ("axial_rotation", "motor", "stepper"):
        for (o0, o1) in a.anchors0:
            _distance_project(hb, i0, i1, o0, o1)
        if a.kind == "stepper" and hb.dim == 2:
            cur = hb.omega[i0, 0] - hb.omega[i1, 0]
            isum = hb.Iw[i0, 0] + hb.Iw[i1, 0]
            L = (np.float32(a.angular_velocity) - cur) / max(isum, _TINY)
            hb.apply_torque(i0, L)
            hb.apply_torque(i1, -L)
        elif a.kind == "stepper":
            # drive the relative angular velocity along the axis to target
            axis = rotate(hb.rot[i1], np.asarray(a.axis_body, np.float32))
            axis = axis / np.maximum(_norm(axis), _TINY)
            corr = np.float32(a.angular_velocity) - dot(hb.omega[i0] - hb.omega[i1], axis)
            L = matvec(explicit_inv(hb.Iw[i0] + hb.Iw[i1] + _EYE12), axis * corr)
            hb.apply_torque(i0, L)
            hb.apply_torque(i1, -L)
    else:
        raise ValueError(f"unknown articulation kind {a.kind}")


def _apply_one(hb: HostBodies, a: Articulation, dt):
    if a.kind == "motor":
        # torque impulse along the axis
        L = np.float32(a.power * dt)
        if hb.dim == 3:
            L = rotate(hb.rot[a.obj[1]], np.asarray(a.axis_body, np.float32)) * L
        hb.apply_torque(a.obj[0], L)
        hb.apply_torque(a.obj[1], -L)


def _penalize_one(hb: HostBodies, a: Articulation, dt):
    if a.kind == "distance":
        _distance_penalize(hb, a.obj[0], a.obj[1], a.offset0, a.offset1,
                           a.target_distance, a.penalty, dt)
    elif a.kind in ("axial_rotation", "motor", "stepper"):
        for (o0, o1) in a.anchors0:
            _distance_penalize(hb, a.obj[0], a.obj[1], o0, o1, 0.0, a.penalty, dt)


def articulate_host(hb: HostBodies, articulations: Tuple[Articulation, ...], dt,
                    iterations: int = 100):
    """apply -> iterations x project -> penalize on the host copy hb. A
    lone rotation, frozen or distance articulation is an exact idempotent
    projection, so one pass is taken (as in the JAX package)."""
    for a in articulations:
        _apply_one(hb, a, dt)
    if len(articulations) == 1 and articulations[0].kind in ("rotation", "frozen", "distance"):
        iterations = 1
    for _ in range(iterations):
        for a in articulations:
            _project_one(hb, a)
    for a in articulations:
        _penalize_one(hb, a, dt)


def articulate(b: RigidBodies, articulations: Tuple[Articulation, ...], dt,
               iterations: int = 100) -> RigidBodies:
    """articulate_host on a host copy of `b`; returns the bodies with the
    new velocities on their device."""
    if not articulations:
        return b
    hb = HostBodies(b)
    articulate_host(hb, articulations, dt, iterations)
    return hb.apply_to(b)


# -- host-side construction (body-frame conversion at scene-build time) ------


def _quat_rot_np(q, v):
    w, xyz = q[0], q[1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _to_body_np(rot_np, v):
    """World direction -> body frame (host, numpy, float64); rot_np is a
    quaternion, or an angle (1,) in 2-D."""
    v = np.asarray(v, np.float64)
    if len(v) == 2:
        c, s = math.cos(-float(rot_np[0])), math.sin(-float(rot_np[0]))
        return (c * v[0] - s * v[1], s * v[0] + c * v[1])
    w, x, y, z = [float(q) for q in rot_np]
    return tuple(_quat_rot_np(np.array([w, -x, -y, -z]), v))


def build_articulation(kind: str, obj0: int, obj1: int, bodies_np: dict, dim: int,
                       **kw) -> Articulation:
    """An Articulation with body-frame parameters; bodies_np holds numpy
    'pos' (R, d) and 'rot' (R, 4) or, in 2-D, (R, 1) at build time."""
    pos, rot = bodies_np["pos"], bodies_np["rot"]
    if kind in ("rotation", "frozen"):
        return Articulation(kind=kind, obj=(obj0, obj1))
    penalty = float(kw.get("penalty", 1e3))
    if kind == "distance":
        off0_w = np.asarray(kw.get("offset0", np.zeros(dim)), np.float64)
        off1_w = np.asarray(kw.get("offset1", np.zeros(dim)), np.float64)
        p0 = pos[obj0] + off0_w
        p1 = pos[obj1] + off1_w
        target = float(kw.get("target_distance", np.linalg.norm(p0 - p1)))
        return Articulation(kind=kind, obj=(obj0, obj1),
                            offset0=_to_body_np(rot[obj0], off0_w),
                            offset1=_to_body_np(rot[obj1], off1_w),
                            target_distance=target, penalty=penalty)
    if kind in ("axial_rotation", "motor", "stepper"):
        off0_w = np.asarray(kw.get("offset0", np.zeros(dim)), np.float64)
        # obj1's anchor offset, so both world anchors coincide at build
        off1_w = pos[obj0] + off0_w - pos[obj1]
        if dim == 2:  # one anchor pair, no axis
            anchors = [(_to_body_np(rot[obj0], off0_w), _to_body_np(rot[obj1], off1_w))]
            axis_body = ()
        else:
            axis_w = np.asarray(kw["axis"], np.float64)
            axis_w = axis_w / np.linalg.norm(axis_w)
            alen = float(kw.get("axis_length", 0.1))
            anchors = []
            for sgn in (1.0, -1.0):
                ao = axis_w * alen * sgn
                anchors.append((_to_body_np(rot[obj0], off0_w + ao),
                                _to_body_np(rot[obj1], off1_w + ao)))
            axis_body = _to_body_np(rot[obj1], axis_w)
        return Articulation(kind=kind, obj=(obj0, obj1), anchors0=tuple(anchors),
                            axis_body=axis_body, penalty=penalty,
                            power=float(kw.get("power", 0.0)),
                            angular_velocity=float(kw.get("angular_velocity", 0.0)))
    raise ValueError(f"unknown articulation kind {kind}")
