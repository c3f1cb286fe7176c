"""B-spline interpolation kernels (torch counterpart of
``taichi_mpm_tpu.math.kernels``).

Linear (order 1), quadratic (order 2, the MLS-MPM default) and cubic
(order 3) tensor-product B-splines. Positions are in grid units.
``stencil_start(order, x)`` is the lowest node the stencil touches:
floor(x) for order 1, floor(x - 0.5) for order 2, floor(x) - 1 for
order 3. ``inv_D(order) = 6 - order`` is the MLS/APIC inertia-tensor
inverse scale (4 for quadratic). The blocked path uses the dense
quadratic form ``quadratic_weight``: N(t) for a particle at signed
distance t (grid units) from a node, zero for |t| >= 1.5.
"""

from __future__ import annotations

import torch


def inv_D(order: int) -> float:
    """MLS/APIC D-matrix inverse scale: 4 (quadratic), 3 (cubic)."""
    return float(6 - order)


def stencil_size(order: int) -> int:
    return order + 1


def quadratic_weight(t: torch.Tensor) -> torch.Tensor:
    """Dense quadratic B-spline N(t), zero outside |t| < 1.5 (the form the
    blocked kernels evaluate, ``p2g_pallas._quadratic_weight``)."""
    a = torch.abs(t)
    inner = 0.75 - t * t
    outer = 0.5 * (1.5 - a) * (1.5 - a)
    return torch.where(a <= 0.5, inner, torch.where(a < 1.5, outer, torch.zeros_like(t)))


def stencil_start(order: int, x: torch.Tensor) -> torch.Tensor:
    """Lowest node index of the interpolation stencil (int32)."""
    if order == 1:
        return torch.floor(x).to(torch.int32)
    if order == 2:
        return torch.floor(x - 0.5).to(torch.int32)
    if order == 3:
        return torch.floor(x).to(torch.int32) - 1
    raise ValueError(f"unsupported B-spline order {order}")


def _cube(t):
    # jnp's t**3 (lax.integer_pow): t * (t * t)
    return t * (t * t)


def bspline_weights(order: int, x: torch.Tensor):
    """Per-axis B-spline weights and grid-unit gradients, in the JAX
    package's formulas and order of operations. x: positions in grid
    units (..., d). Returns (base int32 (..., d), w (..., d, order + 1),
    dw (..., d, order + 1))."""
    base = stencil_start(order, x)
    fx = x - base.to(x.dtype)  # the offset from the first node
    if order == 1:
        w = torch.stack([1.0 - fx, fx], -1)
        dw = torch.stack([-torch.ones_like(fx), torch.ones_like(fx)], -1)
    elif order == 2:
        a, b, c = 1.5 - fx, fx - 1.0, fx - 0.5
        w = torch.stack([0.5 * (a * a), 0.75 - b * b, 0.5 * (c * c)], -1)
        dw = torch.stack([fx - 1.5, -2.0 * b, c], -1)
    else:  # order 3: signed distances t_m = fx - m to the nodes
        t0, t1, t2, t3 = fx, fx - 1.0, fx - 2.0, fx - 3.0
        w = torch.stack([
            (-1.0 / 6.0) * _cube(t0) + t0 * t0 - 2.0 * t0 + 4.0 / 3.0,
            0.5 * _cube(t1) - t1 * t1 + 2.0 / 3.0,
            -0.5 * _cube(t2) - t2 * t2 + 2.0 / 3.0,
            (1.0 / 6.0) * _cube(t3) + t3 * t3 + 2.0 * t3 + 4.0 / 3.0,
        ], -1)
        dw = torch.stack([
            -0.5 * (t0 * t0) + 2.0 * t0 - 2.0,
            1.5 * (t1 * t1) - 2.0 * t1,
            -1.5 * (t2 * t2) - 2.0 * t2,
            0.5 * (t3 * t3) + 2.0 * t3 + 2.0,
        ], -1)
    return base, w, dw
