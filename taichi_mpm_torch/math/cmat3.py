"""Component-form batched 3x3 linear algebra (torch counterpart of
``taichi_mpm_tpu.math.cmat3``).

A 3x3 matrix batch is a 9-tuple of same-shape tensors (row-major: m00,
m01, m02, m10, ..., m22); a vector batch is a 3-tuple. Every operation is
elementwise arithmetic on the components, so a row of the packed
``(NCH, Pw)`` state is a component directly. The formulas and their order
are the JAX package's; the CUDA kernels repeat them per particle.
"""

from __future__ import annotations

import torch

_EPS = 1e-20


# -- tuple helpers ----------------------------------------------------------


def split33(F):
    """(..., 3, 3) tensor -> 9-tuple."""
    return tuple(F[..., i, j] for i in range(3) for j in range(3))


def join33(t):
    """9-tuple -> (..., 3, 3) tensor."""
    rows = [torch.stack(t[3 * i : 3 * i + 3], -1) for i in range(3)]
    return torch.stack(rows, -2)


def c_eye(like):
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)
    return (one, zero, zero, zero, one, zero, zero, zero, one)


def c_scale(A, s):
    return tuple(a * s for a in A)


def c_add(A, B):
    return tuple(a + b for a, b in zip(A, B))


def c_sub(A, B):
    return tuple(a - b for a, b in zip(A, B))


def c_where(cond, A, B):
    return tuple(torch.where(cond, a, b) for a, b in zip(A, B))


def c_mt(A):
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = A
    return (a00, a10, a20, a01, a11, a21, a02, a12, a22)


def c_mm(A, B):
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = A
    b00, b01, b02, b10, b11, b12, b20, b21, b22 = B
    return (
        a00 * b00 + a01 * b10 + a02 * b20,
        a00 * b01 + a01 * b11 + a02 * b21,
        a00 * b02 + a01 * b12 + a02 * b22,
        a10 * b00 + a11 * b10 + a12 * b20,
        a10 * b01 + a11 * b11 + a12 * b21,
        a10 * b02 + a11 * b12 + a12 * b22,
        a20 * b00 + a21 * b10 + a22 * b20,
        a20 * b01 + a21 * b11 + a22 * b21,
        a20 * b02 + a21 * b12 + a22 * b22,
    )


def c_mv(A, v):
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = A
    v0, v1, v2 = v
    return (
        a00 * v0 + a01 * v1 + a02 * v2,
        a10 * v0 + a11 * v1 + a12 * v2,
        a20 * v0 + a21 * v1 + a22 * v2,
    )


def c_det(A):
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = A
    return (
        a00 * (a11 * a22 - a12 * a21)
        - a01 * (a10 * a22 - a12 * a20)
        + a02 * (a10 * a21 - a11 * a20)
    )


def c_trace(A):
    return A[0] + A[4] + A[8]


def c_fnorm2(A):
    return sum(a * a for a in A)


def c_outer(u, v):
    u0, u1, u2 = u
    v0, v1, v2 = v
    return (u0 * v0, u0 * v1, u0 * v2, u1 * v0, u1 * v1, u1 * v2,
            u2 * v0, u2 * v1, u2 * v2)


def c_col_scale(A, s):
    """A @ diag(s): scale column j by s[j]."""
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = A
    s0, s1, s2 = s
    return (a00 * s0, a01 * s1, a02 * s2, a10 * s0, a11 * s1, a12 * s2,
            a20 * s0, a21 * s1, a22 * s2)


def c_adjugate_T(A):
    """Transpose of the adjugate: adj(A)^T / det = A^{-T}."""
    a, b, c, d, e, f, g, h, i = A
    return (
        e * i - f * h, f * g - d * i, d * h - e * g,
        c * h - b * i, a * i - c * g, b * g - a * h,
        b * f - c * e, c * d - a * f, a * e - b * d,
    )


def c_inv_transpose(A):
    adjT = c_adjugate_T(A)
    det = A[0] * adjT[0] + A[1] * adjT[1] + A[2] * adjT[2]
    inv_det = 1.0 / torch.where(torch.abs(det) < _EPS, _EPS, det)
    return c_scale(adjT, inv_det)


def c_polar_newton(F, iters: int = 6):
    """Rotation factor by scaled Newton iteration (6 fixed iterations)."""
    X = F
    for _ in range(iters):
        Xit = c_inv_transpose(X)
        nx = torch.sqrt(c_fnorm2(X))
        ni = torch.sqrt(c_fnorm2(Xit))
        g = torch.sqrt(torch.clamp(ni, min=_EPS) / torch.clamp(nx, min=_EPS))
        X = tuple(0.5 * (g * x + xi / g) for x, xi in zip(X, Xit))
    return X


# -- symmetric eigensolver + SVD -------------------------------------------

_JACOBI_PAIRS = ((0, 1), (0, 2), (1, 2))


def _rsqrt(x):
    """1 / sqrt(x) as float32 square root then division, on every device:
    the kernels' 1.0f / sqrtf (csrc/cmat3.cuh). torch.rsqrt computes just
    that on the CPU, but on the card it is CUDA's approximate rsqrtf,
    whose 2-ulp error the 18 rotations of an SVD carry into the singular
    values (on an H100 the unfused 125k sand frame then drifts to v
    8.9e-5 from the CPU frame, against 1.5e-5), while there the division
    is IEEE's (on the CPU torch's 1 / sqrt rounds otherwise in 0.6% of
    lanes)."""
    return torch.rsqrt(x) if x.device.type == "cpu" else 1.0 / torch.sqrt(x)


def _jacobi_rotation(app, aqq, apq):
    trivial = torch.abs(apq) < _EPS
    safe_apq = torch.where(trivial, 1.0, apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)
    c = _rsqrt(1.0 + t * t)
    s = t * c
    c = torch.where(trivial, 1.0, c)
    s = torch.where(trivial, 0.0, s)
    return c, s


def c_symmetric_eig(A, sweeps: int = 6):
    """Cyclic-Jacobi eigendecomposition of a symmetric 3x3. Returns
    (eig 3-tuple, V 9-tuple with eigenvector COLUMNS), unsorted."""
    a = {
        (0, 0): A[0], (1, 1): A[4], (2, 2): A[8],
        (0, 1): A[1], (0, 2): A[2], (1, 2): A[5],
    }

    def get(i, j):
        return a[(i, j)] if (i, j) in a else a[(j, i)]

    ones = torch.ones_like(A[0])
    zeros = torch.zeros_like(ones)
    vcol = [
        [ones, zeros, zeros],
        [zeros, ones, zeros],
        [zeros, zeros, ones],
    ]

    for _ in range(sweeps):
        for (p, q) in _JACOBI_PAIRS:
            r = 3 - p - q
            app, aqq, apq = get(p, p), get(q, q), get(p, q)
            c, s = _jacobi_rotation(app, aqq, apq)
            arp, arq = get(r, p), get(r, q)
            cc, ss, cs = c * c, s * s, c * s
            a[(p, p)] = cc * app - 2.0 * cs * apq + ss * aqq
            a[(q, q)] = ss * app + 2.0 * cs * apq + cc * aqq
            a[(p, q) if (p, q) in a else (q, p)] = zeros
            key_rp = (r, p) if (r, p) in a else (p, r)
            key_rq = (r, q) if (r, q) in a else (q, r)
            a[key_rp] = c * arp - s * arq
            a[key_rq] = s * arp + c * arq
            vp, vq = vcol[p], vcol[q]
            vcol[p] = [c * vp[i] - s * vq[i] for i in range(3)]
            vcol[q] = [s * vp[i] + c * vq[i] for i in range(3)]

    eig = (a[(0, 0)], a[(1, 1)], a[(2, 2)])
    V = (
        vcol[0][0], vcol[1][0], vcol[2][0],
        vcol[0][1], vcol[1][1], vcol[2][1],
        vcol[0][2], vcol[1][2], vcol[2][2],
    )
    return eig, V


def _normalize3(v):
    n = torch.sqrt(sum(x * x for x in v))
    inv = 1.0 / torch.clamp(n, min=1e-12)
    return tuple(x * inv for x in v), n


def _cross(u, v):
    return (
        u[1] * v[2] - u[2] * v[1],
        u[2] * v[0] - u[0] * v[2],
        u[0] * v[1] - u[1] * v[0],
    )


def c_svd(F, sweeps: int = 6):
    """Rotation-variant SVD: F = U diag(s) V^T, U/V rotations,
    s0 >= s1 >= |s2|, sign(s2) = sign(det F). Returns (U 9-tuple,
    s 3-tuple, V 9-tuple)."""
    A = c_mm(c_mt(F), F)
    eig, V = c_symmetric_eig(A, sweeps=sweeps)
    e = list(eig)
    cols = [
        [V[0], V[3], V[6]],
        [V[1], V[4], V[7]],
        [V[2], V[5], V[8]],
    ]

    def cswap(i, j):
        swap = e[i] < e[j]
        e[i], e[j] = (
            torch.where(swap, e[j], e[i]),
            torch.where(swap, e[i], e[j]),
        )
        for r in range(3):
            ci, cj = cols[i][r], cols[j][r]
            cols[i][r] = torch.where(swap, cj, ci)
            cols[j][r] = torch.where(swap, ci, cj)

    # descending sort network for 3 elements
    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)

    Vs = (
        cols[0][0], cols[1][0], cols[2][0],
        cols[0][1], cols[1][1], cols[2][1],
        cols[0][2], cols[1][2], cols[2][2],
    )
    detV = c_det(Vs)
    flip = torch.where(detV < 0, -1.0, 1.0)
    Vs = (
        Vs[0], Vs[1], Vs[2] * flip,
        Vs[3], Vs[4], Vs[5] * flip,
        Vs[6], Vs[7], Vs[8] * flip,
    )

    B = c_mm(F, Vs)  # columns b_k = F v_k
    b0 = (B[0], B[3], B[6])
    b1 = (B[1], B[4], B[7])
    u0, n0 = _normalize3(b0)
    ok0 = n0 > 1e-12
    zero = torch.zeros_like(n0)
    one = torch.ones_like(n0)
    u0 = (
        torch.where(ok0, u0[0], one),
        torch.where(ok0, u0[1], zero),
        torch.where(ok0, u0[2], zero),
    )
    dot01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2]
    b1p = tuple(b - dot01 * u for b, u in zip(b1, u0))
    u1, n1 = _normalize3(b1p)
    # fallback: unit vector orthogonal to u0
    big1 = torch.abs(u0[1]) > 0.9
    alt = (zero, torch.where(big1, zero, one), torch.where(big1, one, zero))
    fb1, _ = _normalize3(_cross(u0, alt))
    ok1 = n1 > 1e-12
    u1 = tuple(torch.where(ok1, a, b) for a, b in zip(u1, fb1))
    u2 = _cross(u0, u1)

    U = (u0[0], u1[0], u2[0], u0[1], u1[1], u2[1], u0[2], u1[2], u2[2])
    s = (
        u0[0] * B[0] + u0[1] * B[3] + u0[2] * B[6],
        u1[0] * B[1] + u1[1] * B[4] + u1[2] * B[7],
        u2[0] * B[2] + u2[1] * B[5] + u2[2] * B[8],
    )
    return U, s, Vs
