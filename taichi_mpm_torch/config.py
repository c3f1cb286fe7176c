"""Typed, frozen simulation configuration.

A copy of ``taichi_mpm_tpu.config.SimConfig`` with the same field names
and defaults, kept here so the port never imports the JAX package.
Parameter names and defaults mirror ``MPM<dim>::initialize`` in the
reference solver (src/mpm.cpp:26-75).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # Discretization
    res: Tuple[int, ...] = (128, 128, 128)
    dx: float = 0.0  # 0 => auto: 1 / res[0] (reference delta_x convention)
    base_dt: float = 1e-4
    kernel_order: int = 2  # quadratic = the MLS-MPM default

    # Physics
    gravity: Tuple[float, ...] = (0.0, -10.0, 0.0)
    particle_gravity: bool = False  # add gravity on particles in P2G
    apic: bool = True
    rpic_damping: float = 0.0  # damp symmetric part of B
    apic_damping: float = 0.0  # damp skew part of B
    penalty: float = 0.0  # boundary penetration penalty (CPIC)
    pushing_force: float = 20000.0  # CPIC ghost-velocity push
    cfl: float = 1.0  # global adaptive dt multiplier (0 => fixed dt)

    # Materials present in the scene (static dispatch set).
    active_materials: Tuple[int, ...] = ()

    # Position clamp epsilon.
    clamp_eps: float = 1e-4

    # Per-particle levelset projection after G2P.
    particle_collision: bool = False
    # Deactivate particles within 7 cells of the domain boundary each
    # substep.
    clean_boundary: bool = False

    # Rigid-body coupling (CPIC): the number of rigid bodies (set when the
    # scene is finalized), the iterations of the {rigidify, articulate,
    # rasterize} prologue per substep, and the 2-D CDF tag dilation passes
    # (kept for field parity: the port's scenes are 3-D).
    num_rigids: int = 0
    coupling_iterations: int = 1
    cdf_expand: int = 0

    def __post_init__(self):
        if self.dx == 0.0:
            object.__setattr__(self, "dx", 1.0 / self.res[0])

    @property
    def dim(self) -> int:
        return len(self.res)

    @property
    def inv_dx(self) -> float:
        return 1.0 / self.dx

    @property
    def grid_nodes(self) -> Tuple[int, ...]:
        # res+2 nodes per axis: full quadratic support for a clamped
        # particle (pos_grid <= res - eps).
        return tuple(r + 2 for r in self.res)

    def with_materials(self, mats) -> "SimConfig":
        return dataclasses.replace(self, active_materials=tuple(sorted(set(mats))))
