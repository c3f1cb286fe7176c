"""Rotation utilities for the rigid-body module (torch counterpart of
``taichi_mpm_tpu.math.quat``).

Batched, pure functions on (..., 4) wxyz quaternions (3-D) and on
angles (2-D, ``rot2d``), with the same formulas and operation order as
the JAX package.
"""

from __future__ import annotations

import torch

from taichi_mpm_torch.utils import cross


def quat_mul(a, b):
    """Hamilton product of wxyz quaternions (broadcasting)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quat_normalize(q, eps=1e-12):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_mat(q):
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        -1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_from_euler_xyz(euler):
    """Intrinsic X, then Y, then Z rotation (the reference's
    AngleAxis(x, UnitX) * AngleAxis(y, UnitY) * AngleAxis(z, UnitZ)).
    euler in radians, shape (..., 3)."""
    hx, hy, hz = euler[..., 0] * 0.5, euler[..., 1] * 0.5, euler[..., 2] * 0.5
    zeros = torch.zeros_like(hx)
    qx = torch.stack([torch.cos(hx), torch.sin(hx), zeros, zeros], -1)
    qy = torch.stack([torch.cos(hy), zeros, torch.sin(hy), zeros], -1)
    qz = torch.stack([torch.cos(hz), zeros, zeros, torch.sin(hz)], -1)
    return quat_mul(quat_mul(qx, qy), qz)


def quat_integrate(q, omega, dt):
    """Advance orientation by world-frame angular velocity omega (..., 3):
    q' = normalize(q + dt/2 * [0, omega] * q)."""
    zero = torch.zeros_like(omega[..., :1])
    oq = torch.cat([zero, omega], -1)
    return quat_normalize(q + 0.5 * dt * quat_mul(oq, q))


def cos_sin(a):
    """cos and sin of float32 angles, evaluated in float64 and rounded to
    float32. XLA's float32 cos and sin on the CPU are not torch's: over
    200,000 angles in [-10, 10] they differ in about 5% of the values,
    by one ulp, while the rounded float64 values differ from XLA's in
    about 1.3% (``tests/port/port_helpers.py cos-sin`` measures it,
    ``tests/port/test_torch_rigid_2d.py`` bounds it). The rounded
    float64 values are also the same on the card and on the CPU."""
    a64 = a.to(torch.float64)
    return torch.cos(a64).to(torch.float32), torch.sin(a64).to(torch.float32)


def rot2d(angle, v):
    """Rotate 2-D vectors v (..., 2) by angles (..., 1) or (...,)."""
    a = angle[..., 0] if angle.dim() == v.dim() else angle
    c, s = cos_sin(a)
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], -1)
