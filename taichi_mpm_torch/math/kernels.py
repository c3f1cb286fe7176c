"""B-spline interpolation kernels (torch counterpart of
``taichi_mpm_tpu.math.kernels``).

Positions are in grid units. ``inv_D(order) = 6 - order`` is the MLS/APIC
inertia-tensor inverse scale (4 for quadratic). The blocked path uses the
dense quadratic form ``quadratic_weight``: N(t) for a particle at signed
distance t (grid units) from a node, zero for |t| >= 1.5.
"""

from __future__ import annotations

import torch


def inv_D(order: int) -> float:
    """MLS/APIC D-matrix inverse scale: 4 (quadratic), 3 (cubic)."""
    return float(6 - order)


def quadratic_weight(t: torch.Tensor) -> torch.Tensor:
    """Dense quadratic B-spline N(t), zero outside |t| < 1.5 (the form the
    blocked kernels evaluate, ``p2g_pallas._quadratic_weight``)."""
    a = torch.abs(t)
    inner = 0.75 - t * t
    outer = 0.5 * (1.5 - a) * (1.5 - a)
    return torch.where(a <= 0.5, inner, torch.where(a < 1.5, outer, torch.zeros_like(t)))


def bspline_weights(order: int, x: torch.Tensor):
    """Quadratic per-axis weights and grid-unit gradients
    (``taichi_mpm_tpu.math.kernels.bspline_weights`` for order 2, same
    formulas and order). x: positions in grid units (..., d). Returns
    (base int32 = floor(x - 0.5), w (..., d, 3), dw (..., d, 3))."""
    if order != 2:
        raise NotImplementedError(
            f"B-spline order {order}: only the quadratic kernel is ported "
            "(ROADMAP.md queue 1, 'the dense oracle path')")
    base = torch.floor(x - 0.5).to(torch.int32)
    fx = x - base.to(x.dtype)
    a, b, c = 1.5 - fx, fx - 1.0, fx - 0.5
    w = torch.stack([0.5 * (a * a), 0.75 - b * b, 0.5 * (c * c)], -1)
    dw = torch.stack([fx - 1.5, -2.0 * b, c], -1)
    return base, w, dw
