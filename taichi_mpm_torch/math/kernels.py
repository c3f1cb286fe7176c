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
