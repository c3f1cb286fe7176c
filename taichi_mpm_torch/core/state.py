"""Particle state: structure-of-arrays tensors with a validity mask.

The torch counterpart of ``taichi_mpm_tpu.core.state`` (same field names
and shapes). Capacity is fixed; deletion is masking and emission fills
free slots.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Particles:
    """Structure-of-arrays particle state (capacity P, dimension d).

    C is the APIC affine matrix in grid units. aux is the per-material
    mutable scalar (snow Jp / water j / sand logJp / visco tau). states,
    bdist, bnormal and near_b are CPIC fields, inert without rigids.
    """

    x: torch.Tensor  # (P, d) positions, physical units
    v: torch.Tensor  # (P, d) velocities
    F: torch.Tensor  # (P, d, d) elastic deformation gradient
    C: torch.Tensor  # (P, d, d) APIC B (grid units)
    aux: torch.Tensor  # (P,)
    mass: torch.Tensor  # (P,)
    vol: torch.Tensor  # (P,)
    mat: torch.Tensor  # (P,) int32 material id
    params: torch.Tensor  # (P, 8) material parameters
    active: torch.Tensor  # (P,) bool
    states: torch.Tensor  # (P,) int32 affinity bits, 2 per rigid
    bdist: torch.Tensor  # (P,) signed boundary distance (world units)
    bnormal: torch.Tensor  # (P, d) boundary normal
    near_b: torch.Tensor  # (P,) bool near-boundary flag

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def count(self) -> int:
        return int(self.active.sum())

    def take(self, idx) -> "Particles":
        """The particles at lanes `idx` (an index tensor or a slice), as a
        new set."""
        return Particles(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)})


FIELDS = tuple(f.name for f in dataclasses.fields(Particles))


def empty_particles(capacity: int, dim: int, device) -> Particles:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    eye = torch.eye(dim, **f32).expand(capacity, dim, dim).contiguous()
    return Particles(
        x=torch.zeros((capacity, dim), **f32),
        v=torch.zeros((capacity, dim), **f32),
        F=eye,
        C=torch.zeros((capacity, dim, dim), **f32),
        aux=torch.zeros((capacity,), **f32),
        mass=torch.zeros((capacity,), **f32),
        vol=torch.zeros((capacity,), **f32),
        mat=torch.zeros((capacity,), **i32),
        params=torch.zeros((capacity, 8), **f32),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        states=torch.zeros((capacity,), **i32),
        bdist=torch.zeros((capacity,), **f32),
        bnormal=torch.zeros((capacity, dim), **f32),
        near_b=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )
