"""Analytic level-set boundaries (torch counterpart of
``taichi_mpm_tpu.core.levelset``).

SDF, normal and velocity callables take a torch tensor of positions
(..., d) and a time, and return tensors on the same device.

Friction encoding (reference mpm_fwd.h):
  mu >= 0  : Coulomb friction coefficient
  mu == -1 : sticky (velocity = boundary velocity)
  mu <= -2 : slip with friction (-mu - 2), normal velocity removed
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from taichi_mpm_torch.utils import const


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return const(values, torch.float32, like.device)


def friction_project(velocity, base_velocity, normal, friction):
    """The reference's boundary friction projection (mpm_fwd.h:26-57) in
    the dense form of ``taichi_mpm_tpu.core.levelset.friction_project``:
    it divides by max(|vt|, 1e-30), so a zero tangential velocity gives
    scale * 0 rather than the grid update's guarded form (the CPIC
    corrections use this one). ``friction`` is a tensor of the points'
    batch shape."""
    rel = velocity - base_velocity
    sticky = friction == -1.0
    slip = friction <= -2.0
    mu = torch.where(slip, -friction - 2.0, friction)
    vn = torch.sum(normal * rel, -1, keepdim=True)
    vt = rel - vn * normal
    vt_norm = torch.linalg.vector_norm(vt, dim=-1, keepdim=True)
    scale = torch.clamp(vt_norm + torch.clamp(vn, max=0.0) * mu[..., None], min=0.0) / torch.clamp(
        vt_norm, min=1e-30)
    keep_normal = torch.where(slip[..., None], 0.0, torch.clamp(vn, min=0.0))
    projected = scale * vt + keep_normal * normal + base_velocity
    return torch.where(sticky[..., None], base_velocity, projected)


@dataclasses.dataclass(frozen=True)
class Collider:
    """An analytic SDF boundary.

    sdf(x, t): signed distance, negative inside the obstacle.
    velocity(x, t): boundary velocity field (defaults to static).
    normal_fn(x, t): analytic unit normal; None = central differences.
    Nodes with sdf in (band_lo*dx, band_hi*dx] get projected.
    """

    sdf: Callable
    friction: float = 0.0
    velocity: Optional[Callable] = None
    normal_fn: Optional[Callable] = None
    time_varying: bool = False
    band_lo: float = -3.0
    band_hi: float = 0.0

    def normal(self, x, t, eps):
        """Unit outward normal: analytic if provided, else central
        differences of the SDF."""
        if self.normal_fn is not None:
            return self.normal_fn(x, t)
        d = x.shape[-1]
        grads = []
        for k in range(d):
            e = torch.zeros((d,), dtype=x.dtype, device=x.device)
            e[k] = eps
            grads.append((self.sdf(x + e, t) - self.sdf(x - e, t)) / (2 * eps))
        g = torch.stack(grads, -1)
        return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)

    def boundary_velocity(self, x, t):
        if self.velocity is None:
            return torch.zeros_like(x)
        return self.velocity(x, t)


def plane(point, normal_vec, friction=0.0, velocity=None) -> Collider:
    """Half-space obstacle: the region behind the plane (opposite normal)."""
    n = np.asarray(normal_vec, np.float32)
    n_unit = (n / np.linalg.norm(n)).tolist()  # normalized in f32

    def sdf(x, t):
        return torch.sum((x - _vec(point, x)) * _vec(n_unit, x), -1)

    def normal_fn(x, t):
        return _vec(n_unit, x).expand(x.shape)

    return Collider(sdf=sdf, friction=friction, velocity=velocity, normal_fn=normal_fn)


def sphere(center, radius, friction=0.0, inside_out=False, velocity=None) -> Collider:
    def sdf(x, t):
        d = torch.linalg.norm(x - _vec(center, x), dim=-1) - radius
        return -d if inside_out else d

    def normal_fn(x, t):
        r = x - _vec(center, x)
        nrm = r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True), min=1e-12)
        return -nrm if inside_out else nrm

    return Collider(sdf=sdf, friction=friction, velocity=velocity, normal_fn=normal_fn)


def box_domain(lo, hi, friction=0.0, velocity=None) -> Collider:
    """Container: the allowed region is the axis-aligned box [lo, hi].

    The SDF is the distance *into* the domain from the nearest wall
    (positive inside, negative outside)."""

    def sdf(x, t):
        return torch.minimum(
            torch.amin(x - _vec(lo, x), dim=-1), torch.amin(_vec(hi, x) - x, dim=-1)
        )

    def normal_fn(x, t):
        # inward normal of the nearest wall (one-hot on the argmin face;
        # ties take the first face, as jnp.argmin does)
        dist = torch.cat([x - _vec(lo, x), _vec(hi, x) - x], -1)
        k = torch.argmin(dist, -1)
        d = x.shape[-1]
        sign = torch.where(k < d, 1.0, -1.0)
        axis = torch.where(k < d, k, k - d)
        onehot = torch.nn.functional.one_hot(axis, d).to(x.dtype)
        return sign[..., None] * onehot

    return Collider(sdf=sdf, friction=friction, velocity=velocity, normal_fn=normal_fn)


def cylinder(center, axis: int, radius, friction=0.0, velocity=None) -> Collider:
    """Infinite cylinder obstacle along the given axis."""

    def sdf(x, t):
        c = _vec(center, x)
        r = torch.sqrt(sum((x[..., k] - c[k]) ** 2 for k in range(x.shape[-1]) if k != axis))
        return r - radius

    return Collider(sdf=sdf, friction=friction, velocity=velocity)


def union(*colliders_same_friction) -> Tuple[Collider, ...]:
    return tuple(colliders_same_friction)


@dataclasses.dataclass(frozen=True)
class DirichletRegion:
    """Pins grid velocity to `velocity` wherever mask(x, t) is True."""

    mask: Callable  # (x (..., d), t) -> bool (...)
    velocity: Tuple[float, ...] = ()


def dirichlet_slab(axis: int, lo: float, hi: float, velocity=()) -> DirichletRegion:
    """Grid velocity pinned to `velocity` (default 0) where
    lo <= x[axis] < hi."""
    return DirichletRegion(
        mask=lambda x, t: (x[..., axis] >= lo) & (x[..., axis] < hi),
        velocity=tuple(velocity),
    )
