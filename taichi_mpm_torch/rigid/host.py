"""The rigid bodies' own small solves on the host.

A scene has a handful of bodies; the rigid-rigid collision solve and the
articulation projection run some 20 sequential projections of a few
3-vectors each per substep. As tensor ops on the card that is thousands
of tiny launches, each costing the host more than the card; here they run
in numpy float32 on a host copy of the bodies (one read from the card,
one upload back per substep), with the JAX package's formulas and
operation order: float32 elementwise arithmetic rounds alike in numpy,
torch and XLA, and the matrix-vector products are formed as XLA's CPU
dot forms them, as chains of fused multiply-adds.
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


def rotate(q, v):
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
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


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
    change). ``apply_to`` uploads the new velocities."""

    FIELDS = ("pos", "vel", "rot", "omega", "mass_inv", "inertia_inv", "friction",
              "restitution")

    def __init__(self, b: RigidBodies):
        flat = torch.cat([getattr(b, f).reshape(-1) for f in self.FIELDS]).cpu().numpy()
        k = 0
        for f in self.FIELDS:
            n = getattr(b, f).numel()
            setattr(self, f, flat[k:k + n].reshape(tuple(getattr(b, f).shape)).copy())
            k += n
        Rm = quat_to_mat(self.rot)
        self.Iw = matmul(matmul(Rm, self.inertia_inv), np.swapaxes(Rm, -1, -2))

    def apply_to(self, b: RigidBodies) -> RigidBodies:
        dev = b.pos.device
        return b.replace(vel=upload(self.vel, dev), omega=upload(self.omega, dev))

    def velocity_at(self, i, x):
        return self.vel[i] + cross(self.omega[i], x - self.pos[i])

    def impulse_contribution(self, i, r, n):
        return self.mass_inv[i] + dot(cross(matvec(self.Iw[i], cross(r, n)), r), n)

    def impulse(self, i, J, at):
        """The impulse J at the world point `at` to body i."""
        self.vel[i] = self.vel[i] + J * self.mass_inv[i]
        self.omega[i] = self.omega[i] + matvec(self.Iw[i], cross(at - self.pos[i], J))

    def pair_impulse(self, i, j, p, n, J):
        """-J*n at p to body i, +J*n at p to body j."""
        imp = J * n
        self.impulse(i, -imp, p)
        self.impulse(j, imp, p)

    def project_rotation(self, i0, i1):
        """The rotation articulation's projection: both bodies take the
        angular velocity of their total angular momentum."""
        eye = np.float32(1e-12) * np.eye(3, dtype=np.float32)
        I0 = explicit_inv(self.Iw[i0] + eye)
        I1 = explicit_inv(self.Iw[i1] + eye)
        L = matvec(I0, self.omega[i0]) + matvec(I1, self.omega[i1])
        w = matvec(explicit_inv(I0 + I1), L)
        self.omega[i0] = w
        self.omega[i1] = w.copy()
