"""The rigid bodies' own small solves on the host.

A scene has a handful of bodies; the rigid-rigid collision solve and the
articulation projection run some 20 sequential projections of a few
3-vectors each per substep. As tensor ops on the card that is thousands
of tiny launches, each costing the host more than the card; here they run
in numpy float32 on a host copy of the bodies (one read from the card,
one upload back per substep), with the JAX package's formulas and
operation order: float32 elementwise arithmetic rounds alike in numpy,
torch and XLA, and the matrix-vector products are formed as XLA's CPU
dot forms them, as chains of fused multiply-adds. In 2-D a body's
rotation, angular velocity and inverse inertia are scalars (the angle
form of ``rigid.body``).
"""

from __future__ import annotations

import numpy as np
import torch

from taichi_mpm_torch.rigid.body import RigidBodies
from taichi_mpm_torch.utils import upload


def cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def cross_omega(w, r):
    """omega x r with the 2-D omega's scalar z-component w (..., 1)."""
    return np.stack([-w[..., 0] * r[..., 1], w[..., 0] * r[..., 0]], -1)


def torque(r, J):
    """The 2-D torque r x J as a (..., 1) array."""
    return (r[..., 0] * J[..., 1] - r[..., 1] * J[..., 0])[..., None]


def rotate(q, v):
    """v rotated by the quaternion q, or in 2-D by the angle q (1,), its
    cos and sin rounded from float64 as ``math.quat.cos_sin``'s."""
    if v.shape[-1] == 2:
        a = np.float64(q[..., 0])
        c, s = np.cos(a).astype(np.float32), np.sin(a).astype(np.float32)
        return np.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], -1)
    qv, w = q[..., 1:], q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                  2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                  2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def dot(a, b):
    out = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        out = out + a[..., k] * b[..., k]
    return out


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in
    float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def dot_fma(a, b):
    """The dot product as XLA's CPU dot and torch's CPU matmul form it: a
    chain of fused multiply-adds over the axis in order."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def matvec(M, v):
    """M v with each row a fused multiply-add chain, as a matrix product
    (the JAX package's einsum or @) rounds it."""
    return np.stack([dot_fma(M[..., 0, :], v), dot_fma(M[..., 1, :], v),
                     dot_fma(M[..., 2, :], v)], -1)


def matmul(A, B):
    return np.stack([matvec(A, B[..., :, j]) for j in range(3)], -1)


def explicit_inv(M):
    """rigid/cdf.explicit_inv in numpy: the adjugate inverse with the
    unsigned determinant clamp."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    dm, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = [[e * i - f * h, c * h - b * i, b * f - c * e],
         [f * g - dm * i, a * i - c * g, c * dm - a * f],
         [dm * h - e * g, b * g - a * h, a * e - b * dm]]
    det = a * A[0][0] + b * A[1][0] + c * A[2][0]
    inv_det = np.float32(1.0) / (np.float32(1e-30) if abs(det) < 1e-30 else det)
    return np.asarray([[x * inv_det for x in row] for row in A], np.float32)


class HostBodies:
    """float32 numpy copies of the bodies' fields, read from their device
    at once; Iw is the world inverse inertia (fixed while only velocities
    change; the scalar (R, 1) in 2-D). ``apply_to`` uploads the new
    velocities."""

    FIELDS = ("pos", "vel", "rot", "omega", "mass_inv", "inertia_inv", "friction",
              "restitution")

    def __init__(self, b: RigidBodies):
        flat = torch.cat([getattr(b, f).reshape(-1) for f in self.FIELDS]).cpu().numpy()
        k = 0
        for f in self.FIELDS:
            n = getattr(b, f).numel()
            setattr(self, f, flat[k:k + n].reshape(tuple(getattr(b, f).shape)).copy())
            k += n
        self.dim = self.pos.shape[-1]
        if self.dim == 2:
            self.Iw = self.inertia_inv.copy()
        else:
            Rm = quat_to_mat(self.rot)
            self.Iw = matmul(matmul(Rm, self.inertia_inv), np.swapaxes(Rm, -1, -2))

    def apply_to(self, b: RigidBodies) -> RigidBodies:
        dev = b.pos.device
        return b.replace(vel=upload(self.vel, dev), omega=upload(self.omega, dev))

    def velocity_at(self, i, x):
        if self.dim == 2:
            return self.vel[i] + cross_omega(self.omega[i], x - self.pos[i])
        return self.vel[i] + cross(self.omega[i], x - self.pos[i])

    def impulse_contribution(self, i, r, n):
        if self.dim == 2:
            rxd = r[..., 0] * n[..., 1] - r[..., 1] * n[..., 0]
            return self.mass_inv[i] + self.Iw[i, 0] * rxd * rxd
        return self.mass_inv[i] + dot(cross(matvec(self.Iw[i], cross(r, n)), r), n)

    def apply_torque(self, i, L):
        """omega_i += I_world^-1 L (L a scalar in 2-D)."""
        if self.dim == 2:
            self.omega[i] = self.omega[i] + self.Iw[i] * L
        else:
            self.omega[i] = self.omega[i] + matvec(self.Iw[i], L)

    def impulse(self, i, J, at):
        """The impulse J at the world point `at` to body i."""
        self.vel[i] = self.vel[i] + J * self.mass_inv[i]
        if self.dim == 2:
            self.omega[i] = self.omega[i] + self.Iw[i] * torque(at - self.pos[i], J)
        else:
            self.omega[i] = self.omega[i] + matvec(self.Iw[i], cross(at - self.pos[i], J))

    def pair_impulse(self, i, j, p, n, J):
        """-J*n at p to body i, +J*n at p to body j."""
        imp = J * n
        self.impulse(i, -imp, p)
        self.impulse(j, imp, p)

    def project_rotation(self, i0, i1):
        """The rotation articulation's projection: both bodies take the
        angular velocity of their total angular momentum."""
        if self.dim == 2:
            I0 = np.float32(1.0) / max(self.Iw[i0, 0], np.float32(1e-12))
            I1 = np.float32(1.0) / max(self.Iw[i1, 0], np.float32(1e-12))
            w = (I0 * self.omega[i0, 0] + I1 * self.omega[i1, 0]) / (I0 + I1)
            self.omega[i0] = w
            self.omega[i1] = w
            return
        eye = np.float32(1e-12) * np.eye(3, dtype=np.float32)
        I0 = explicit_inv(self.Iw[i0] + eye)
        I1 = explicit_inv(self.Iw[i1] + eye)
        L = matvec(I0, self.omega[i0]) + matvec(I1, self.omega[i1])
        w = matvec(explicit_inv(I0 + I1), L)
        self.omega[i0] = w
        self.omega[i1] = w.copy()
