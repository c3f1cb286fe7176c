"""Rigid-body state and dynamics (torch counterpart of
``taichi_mpm_tpu.rigid.body``, 2-D and 3-D).

All R <= 12 bodies live in one ``RigidBodies`` of small tensors on the
scene's device. The formulas and their operation order follow the JAX
package, including the masked small-R forms (``R_UNROLL_MAX``) that the
CPIC corrections take, so sums round the same way.

Scripted motion: ``pos_funcs`` / ``rot_funcs`` are user callables of the
time. They are called with a Python float and what they return is
converted to a float32 tensor; no tensor is passed into user code.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from taichi_mpm_torch.math.quat import (
    quat_from_euler_xyz,
    quat_integrate,
    quat_rotate,
    quat_to_mat,
    rot2d,
)
from taichi_mpm_torch.utils import const, cross, index_add_ordered, upload


@dataclasses.dataclass
class RigidBodies:
    """Batched rigid-body state + constant parameters (leading axis R).

    3-D: rot is a wxyz quaternion (R, 4), omega (R, 3), inertia_inv the
    body-frame inverse inertia tensor (R, 3, 3). 2-D: rot is an angle
    (R, 1), omega (R, 1), inertia_inv (R, 1). Scripted (infinite-mass)
    bodies have mass_inv = 0 / inertia_inv = 0."""

    pos: torch.Tensor  # (R, d)
    vel: torch.Tensor  # (R, d)
    rot: torch.Tensor  # (R, 4) quaternion | (R, 1) angle
    omega: torch.Tensor  # (R, 3) | (R, 1)
    mass_inv: torch.Tensor  # (R,)
    inertia_inv: torch.Tensor  # (R, 3, 3) | (R, 1) body frame
    friction: torch.Tensor  # (R, 2) two-sided friction
    restitution: torch.Tensor  # (R,)
    rotation_axis: torch.Tensor  # (R, 3) zero = unconstrained (3-D only)
    linear_damping: torch.Tensor  # (R,)
    angular_damping: torch.Tensor  # (R,)

    @property
    def num(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    def replace(self, **kw) -> "RigidBodies":
        return dataclasses.replace(self, **kw)


BODY_FIELDS = tuple(f.name for f in dataclasses.fields(RigidBodies))

# Bodies up to this many take the masked forms below (a static unroll of
# R masked passes) in the CPIC corrections, as in the JAX package.
R_UNROLL_MAX = 6


def rotate(rot, v):
    """Body-frame -> world-frame vectors: quaternions (3-D) or angles
    (2-D)."""
    if v.shape[-1] == 2:
        return rot2d(rot, v)
    return quat_rotate(rot, v)


def world_inertia_inv(b: RigidBodies):
    """World-frame inverse inertia R I_b^-1 R^T (3-D); the scalar (R, 1)
    in 2-D."""
    if b.dim == 2:
        return b.inertia_inv
    Rm = quat_to_mat(b.rot)
    return Rm @ b.inertia_inv @ Rm.transpose(-1, -2)


def cross_omega(omega, r):
    """omega x r, a 2-D omega being the scalar z-component."""
    if r.shape[-1] == 2:
        w = omega[..., 0]
        return torch.stack([-w * r[..., 1], w * r[..., 0]], -1)
    return cross(omega, r)


def _torque_of(r, J):
    """r x J: the scalar z-component (..., 1) in 2-D."""
    if r.shape[-1] == 2:
        return (r[..., 0] * J[..., 1] - r[..., 1] * J[..., 0])[..., None]
    return cross(r, J)


def velocity_at(b: RigidBodies, rid, x):
    """Velocity of body `rid` (int tensor (...)) at world points x:
    v + omega x (x - pos)."""
    return b.vel[rid] + cross_omega(b.omega[rid], x - b.pos[rid])


def velocity_at_masked(b: RigidBodies, rid, x):
    """velocity_at as a static unroll over the bodies with rid == r
    masks; rows with rid outside [0, R) get 0."""
    out = torch.zeros_like(x)
    for r in range(b.num):
        vr = b.vel[r] + cross_omega(b.omega[r], x - b.pos[r])
        out = torch.where((rid == r)[..., None], vr, out)
    return out


def accumulate_impulses_masked(b: RigidBodies, rid, J, at, valid):
    """accumulate_impulses as per-body masked reductions (static unroll):
    the same totals without scatters."""
    rid_flat = rid.reshape(-1)
    J_flat = J.reshape(-1, b.dim)
    at_flat = at.reshape(-1, b.dim)
    v_flat = valid.reshape(-1)
    Js, taus = [], []
    for r in range(b.num):
        m = (v_flat & (rid_flat == r))[:, None]
        Jm = torch.where(m, J_flat, 0.0)
        Js.append(torch.sum(Jm, 0))
        taus.append(torch.sum(torch.where(m, _torque_of(at_flat - b.pos[r], Jm), 0.0), 0))
    return torch.stack(Js), torch.stack(taus)


def accumulate_impulses(b: RigidBodies, rid, J, at, valid):
    """Segment-sum impulses J (..., d) applied at world points `at` to
    bodies rid (...) where valid. Returns (J_tot (R, d), tau_tot (R, 3) or
    (R, 1) in 2-D)."""
    R, d = b.num, b.dim
    rid_flat = rid.reshape(-1)
    J_flat = torch.where(valid.reshape(-1)[:, None], J.reshape(-1, d), 0.0)
    at_flat = at.reshape(-1, d)
    safe_rid = torch.clamp(rid_flat, 0, R - 1).long()
    tau = _torque_of(at_flat - b.pos[safe_rid], J_flat)
    J_tot = torch.zeros((R, d), dtype=J_flat.dtype, device=J_flat.device)
    tau_tot = torch.zeros((R, tau.shape[-1]), dtype=J_flat.dtype, device=J_flat.device)
    return (index_add_ordered(J_tot, safe_rid, J_flat),
            index_add_ordered(tau_tot, safe_rid, tau))


def apply_impulses(b: RigidBodies, J_tot, tau_tot) -> RigidBodies:
    """vel += J / m; omega += I_world^-1 tau."""
    vel = b.vel + J_tot * b.mass_inv[:, None]
    if b.dim == 2:
        omega = b.omega + world_inertia_inv(b) * tau_tot
    else:
        omega = b.omega + (world_inertia_inv(b) @ tau_tot[:, :, None])[..., 0]
    return b.replace(vel=vel, omega=omega)


def impulse_contribution(b: RigidBodies, rid, r, direction):
    """1/m + dir . ((I^-1 (r x dir)) x r): the effective inverse mass
    along `direction` at offset r from the centre of mass."""
    minv = b.mass_inv[rid]
    Iinv = world_inertia_inv(b)[rid]
    if b.dim == 2:
        rxd = r[..., 0] * direction[..., 1] - r[..., 1] * direction[..., 0]
        return minv + Iinv[..., 0] * rxd * rxd
    rxd = cross(r, direction)
    ang = (Iinv @ rxd[..., None])[..., 0]
    return minv + torch.sum(cross(ang, r) * direction, -1)


def enforce_rotation_axis(b: RigidBodies) -> RigidBodies:
    """Project omega onto rotation_axis for constrained bodies (no-op
    where the axis is zero, and in 2-D)."""
    if b.dim == 2:
        return b
    axis = b.rotation_axis
    norm2 = torch.sum(axis * axis, -1, keepdim=True)
    constrained = torch.amax(torch.abs(axis), -1, keepdim=True) > 0.1
    proj = axis * (torch.sum(b.omega * axis, -1, keepdim=True) / torch.clamp(norm2, min=1e-30))
    return b.replace(omega=torch.where(constrained, proj, b.omega))


def advance(
    b: RigidBodies,
    t,
    dt,
    pos_funcs: Tuple[Optional[Callable], ...],
    rot_funcs: Tuple[Optional[Callable], ...],
    gravity,
) -> RigidBodies:
    """Symplectic advance + scripted overrides + gravity impulse: axis
    constraint -> damped advance -> gravity -> axis constraint. Scripted
    bodies take position/rotation from their functions, velocities from
    forward differences. t and dt are float32 values."""
    dev = b.pos.device
    b = enforce_rotation_axis(b)
    dt32 = np.float32(dt)
    lin_k = torch.exp(-b.linear_damping * float(dt32))[:, None]
    ang_k = torch.exp(-b.angular_damping * float(dt32))[:, None]
    vel = b.vel * lin_k
    omega = b.omega * ang_k
    pos = b.pos + float(dt32) * vel
    if b.dim == 2:
        rot = b.rot + float(dt32) * omega
    else:
        rot = quat_integrate(b.rot, omega, float(dt32))

    # the scripts' values at t and t + dt (a 2-D rotation script gives one
    # angle), uploaded together. The scripts get float32 scalars, as the
    # JAX package's get traced float32 values: a script's arithmetic with
    # Python numbers (0.4 + t) then rounds in float32 there and here.
    t0 = np.float32(t)
    t1 = np.float32(t0 + dt32)
    scripted = [(i, f) for i, f in enumerate(pos_funcs) if f is not None]
    scripted += [(len(pos_funcs) + i, g) for i, g in enumerate(rot_funcs) if g is not None]
    if scripted:
        host = [np.asarray([fn(t0), fn(t1)], np.float32).reshape(2, -1) for _, fn in scripted]
        vals = upload(np.concatenate([h.ravel() for h in host]), dev)
        pos_list, vel_list = list(pos.unbind(0)), list(vel.unbind(0))
        rot_list, omg_list = list(rot.unbind(0)), list(omega.unbind(0))
        k0 = 0
        for (k, _), h in zip(scripted, host):
            n = h.shape[1]
            v0, v1 = vals[k0:k0 + n], vals[k0 + n:k0 + 2 * n]
            k0 += 2 * n
            if k < len(pos_funcs):
                pos_list[k] = v1
                vel_list[k] = (v1 - v0) / float(dt32)
            else:
                e0, e1 = torch.deg2rad(v0), torch.deg2rad(v1)
                rot_list[k - len(pos_funcs)] = e1 if b.dim == 2 else quat_from_euler_xyz(e1)
                omg_list[k - len(pos_funcs)] = (e1 - e0) / float(dt32)
        pos, vel = torch.stack(pos_list), torch.stack(vel_list)
        rot, omega = torch.stack(rot_list), torch.stack(omg_list)

    finite = (b.mass_inv > 0.0)[:, None]
    vel = torch.where(finite, vel + const(gravity, device=dev) * float(dt32), vel)
    return enforce_rotation_axis(b.replace(pos=pos, vel=vel, rot=rot, omega=omega))


def boundary_particle_world(b: RigidBodies, bp_rid, bp_offset, bp_normal, bp_elem):
    """World-space boundary-particle positions, normals and element
    vertices from their body-frame statics."""
    rid = bp_rid.long()
    rot = b.rot[rid]
    pos = b.pos[rid]
    x = pos + rotate(rot, bp_offset)
    n = rotate(rot, bp_normal)
    elem = pos[:, None, :] + rotate(rot[:, None, :], bp_elem)
    return x, n, elem
