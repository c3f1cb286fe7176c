"""Canonical scenes (torch counterpart of ``taichi_mpm_tpu.scenes``).

``benchmark_cube`` is the reference's analytic benchmark seeding
(``benchmark=125`` / ``benchmark=8000``): a cube of cells each holding 8
particles on a 2x2x2 sub-lattice, dropped under gravity in a res^3 box
with sticky walls.
"""

from __future__ import annotations

import numpy as np

from taichi_mpm_torch.core import levelset
from taichi_mpm_torch.core.solver import MPM


def cube_lattice(cells_per_side: int, dx: float, origin, ppc_axis: int = 2,
                 jitter: float = 0.0, seed: int = 0) -> np.ndarray:
    """ppc_axis^d particles per cell on a regular sub-lattice (8 ppc default)."""
    n = cells_per_side * ppc_axis
    h = dx / ppc_axis
    ax = (np.arange(n, dtype=np.float32) + 0.5) * h
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        g = g + rng.uniform(-jitter * h, jitter * h, g.shape).astype(np.float32)
    return g + np.asarray(origin, np.float32)


def benchmark_cube(
    cells: int = 100,
    res: int = 125,
    material: str = "jelly",
    base_dt: float = 1e-4,
    gravity: float = -10.0,
    device=None,
    **mat_kw,
) -> MPM:
    """cells=25 -> 125k particles; cells=100 -> 8M (the reference's
    benchmark=125 / benchmark=8000). Runs on the card unless `device`
    names another."""
    sim = MPM(
        res=(res, res, res),
        base_delta_t=base_dt,
        gravity=(0.0, gravity, 0.0),
        device=device,
    )
    dx = sim.cfg.dx
    margin = (res - cells) // 2 * dx
    pos = cube_lattice(cells, dx, origin=(margin, margin, margin))
    sim.add_particles(material, pos=pos, density=400.0, ppc=8.0, **mat_kw)
    pad = 3.5 * dx
    sim.add_collider(
        levelset.box_domain(
            lo=(pad, pad, pad),
            hi=(res * dx - pad, res * dx - pad, res * dx - pad),
            friction=-1.0,
        )
    )
    return sim
