"""Batched 2x2 / 3x3 SVD and polar decomposition on matrix tensors
(torch counterpart of ``taichi_mpm_tpu.math.svd``).

The rotation-variant SVD, vectorized over a leading batch:

    F = U @ diag(sigma) @ V.T,  U, V in SO(d) (det = +1),
    sigma[0] >= sigma[1] >= |sigma[d-1]|,
    sign(sigma[d-1]) = sign(det F).

A fixed-sweep cyclic Jacobi eigensolver on F^T F, then a Gram-Schmidt
construction of U with fallbacks for degenerate columns, in the JAX
package's formulas and order. The 3x3 Jacobi sweeps are
``math.cmat3.c_symmetric_eig`` (the component form the fused kernels'
twins use), whose square roots give the same bits on the card as on the
CPU (``cmat3._rsqrt``). All functions take (..., d, d) tensors.
"""

from __future__ import annotations

import torch

from taichi_mpm_torch.math import cmat3
from taichi_mpm_torch.utils import const


def mm(a, b):
    """Batched small matrix product, summed k = 0, 1, ... in order from 0
    (the JAX package's unrolled ``utils.mm``: sum(a_ik b_kj for k)), as
    whole-matrix ops: column k of a times row k of b."""
    out = 0 + a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def _normalize(v, eps=1e-12):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps), n[..., 0]


def _unit(like, axis):
    e = torch.zeros_like(like)
    e[..., axis] = 1.0
    return e


def _det3(V):
    return (V[..., 0, 0] * (V[..., 1, 1] * V[..., 2, 2] - V[..., 1, 2] * V[..., 2, 1])
            - V[..., 0, 1] * (V[..., 1, 0] * V[..., 2, 2] - V[..., 1, 2] * V[..., 2, 0])
            + V[..., 0, 2] * (V[..., 1, 0] * V[..., 2, 1] - V[..., 1, 1] * V[..., 2, 0]))


def svd3x3(F, sweeps: int = 6):
    """Rotation-variant SVD of batched 3x3 matrices: (U, sigma, V)."""
    A = mm(F.transpose(-1, -2), F)
    eig_c, V_c = cmat3.c_symmetric_eig(cmat3.split33(A), sweeps=sweeps)
    eig = torch.stack(eig_c, -1)
    V = cmat3.join33(V_c)

    # eigenvalues descending (a stable sort, as jnp.argsort), V's columns with them
    order = torch.argsort(-eig, dim=-1, stable=True)
    eig = torch.take_along_dim(eig, order, dim=-1)
    V = torch.take_along_dim(V, order[..., None, :], dim=-1)

    # det(V) = +1: flip the last column where it is -1
    flip = torch.where(_det3(V) < 0, -1.0, 1.0)
    V = torch.cat([V[..., :, :2], V[..., :, 2:] * flip[..., None, None]], -1)

    B = mm(F, V)
    b0, b1 = B[..., :, 0], B[..., :, 1]
    u0, n0 = _normalize(b0)
    u0 = torch.where((n0 > 1e-12)[..., None], u0, _unit(u0, 0))  # F v0 ~ 0

    b1p = b1 - torch.sum(u0 * b1, -1, keepdim=True) * u0
    u1, n1 = _normalize(b1p)
    alt = torch.where((torch.abs(u0[..., 1]) > 0.9)[..., None], _unit(u0, 2), _unit(u0, 1))
    fb1, _ = _normalize(torch.linalg.cross(u0, alt, dim=-1))
    u1 = torch.where((n1 > 1e-12)[..., None], u1, fb1)
    u2 = torch.linalg.cross(u0, u1, dim=-1)  # det(U) = +1

    U = torch.stack([u0, u1, u2], -1)
    # signed singular values sigma_i = u_i . (F v_i); det F's sign in sigma_2
    sigma = torch.einsum("...ij,...ij->...j", U, B)
    return U, sigma, V


def svd2x2(F):
    """Rotation-variant SVD of batched 2x2 matrices (closed form)."""
    A = mm(F.transpose(-1, -2), F)
    a, b, d = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
    tr = a + d
    disc = torch.sqrt(torch.clamp((a - d) ** 2 + 4.0 * b * b, min=0.0))
    lam0 = 0.5 * (tr + disc)  # the larger eigenvalue
    v0a = torch.stack([b, lam0 - a], -1)
    v0b = torch.stack([lam0 - d, b], -1)
    use_a = torch.abs(lam0 - a) > torch.abs(lam0 - d)
    v0 = torch.where(use_a[..., None], v0a, v0b)
    v0n, nv = _normalize(v0)
    v0n = torch.where((nv > 1e-12)[..., None], v0n, _unit(v0n, 0))
    v1 = torch.stack([-v0n[..., 1], v0n[..., 0]], -1)  # det(V) = +1
    V = torch.stack([v0n, v1], -1)

    B = mm(F, V)
    u0, n0 = _normalize(B[..., :, 0])
    u0 = torch.where((n0 > 1e-12)[..., None], u0, _unit(u0, 0))
    u1 = torch.stack([-u0[..., 1], u0[..., 0]], -1)  # det(U) = +1
    U = torch.stack([u0, u1], -1)
    sigma = torch.einsum("...ij,...ij->...j", U, B)
    return U, sigma, V


def svd(F, sweeps: int = 6):
    """Dispatch on the matrix dimension."""
    d = F.shape[-1]
    if d == 2:
        return svd2x2(F)
    if d == 3:
        return svd3x3(F, sweeps=sweeps)
    raise ValueError(f"svd supports 2x2/3x3, got {d}x{d}")


def polar_decomp(F, sweeps: int = 6):
    """Polar decomposition F = R @ S with R in SO(d), S symmetric."""
    U, sigma, V = svd(F, sweeps=sweeps)
    VT = V.transpose(-1, -2)
    return torch.matmul(U, VT), torch.matmul(V, sigma[..., :, None] * VT)


def inv_transpose(F):
    """Closed-form batched inverse-transpose of 2x2/3x3 (adjugate / det)."""
    if F.shape[-1] == 2:
        det = F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
        inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
        row0 = torch.stack([F[..., 1, 1], -F[..., 1, 0]], -1)
        row1 = torch.stack([-F[..., 0, 1], F[..., 0, 0]], -1)
        return torch.stack([row0, row1], -2) * inv_det[..., None, None]
    # the cofactors (next row, next column) x (previous row, previous
    # column) - (next, previous) x (previous, next), rows and columns
    # cyclic: cmat3.c_adjugate_T's products, as whole-matrix ops
    nxt = const((1, 2, 0), torch.int64, F.device)
    prv = const((2, 0, 1), torch.int64, F.device)
    n, p = F.index_select(-2, nxt), F.index_select(-2, prv)
    adj = (n.index_select(-1, nxt) * p.index_select(-1, prv)
           - n.index_select(-1, prv) * p.index_select(-1, nxt))
    det = F[..., 0, 0] * adj[..., 0, 0] + F[..., 0, 1] * adj[..., 0, 1] + F[..., 0, 2] * adj[..., 0, 2]
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    return adj * inv_det[..., None, None]


def polar_newton(F, iters: int = 6):
    """Rotation factor of F by the scaled Newton iteration
    X <- (g X + X^{-T} / g) / 2, g from the Frobenius norms."""
    X = F
    for _ in range(iters):
        Xit = inv_transpose(X)
        nx = torch.sqrt(torch.sum(X * X, dim=(-2, -1), keepdim=True))
        ni = torch.sqrt(torch.sum(Xit * Xit, dim=(-2, -1), keepdim=True))
        g = torch.sqrt(torch.clamp(ni, min=1e-20) / torch.clamp(nx, min=1e-20))
        X = 0.5 * (g * X + Xit / g)
    return X
