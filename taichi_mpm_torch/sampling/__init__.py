"""Particle seeding (torch port's copy of ``taichi_mpm_tpu.sampling``):
Poisson-disk sampling and density-field textures, host numpy."""

from taichi_mpm_torch.sampling import poisson, texture  # noqa: F401
from taichi_mpm_torch.sampling.texture import Texture  # noqa: F401
