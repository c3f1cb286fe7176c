"""Stencil helpers of the transfers (torch counterpart of part of
``taichi_mpm_tpu.core.transfer``). Only ``stencil_offsets`` is ported so
far; the dense transfers wait for the dense oracle path (ROADMAP.md
queue 1)."""

from __future__ import annotations

import itertools


def stencil_offsets(dim: int, order: int):
    """Node offsets of the B-spline stencil, in the JAX package's order
    (itertools.product: the last axis varies fastest)."""
    return tuple(itertools.product(range(order + 1), repeat=dim))
