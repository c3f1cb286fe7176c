"""Canonical scenes (torch counterpart of ``taichi_mpm_tpu.scenes``).

``benchmark_cube`` is the reference's analytic benchmark seeding
(``benchmark=125`` / ``benchmark=8000``): a cube of cells each holding 8
particles on a 2x2x2 sub-lattice, dropped under gravity in a res^3 box
with sticky walls.

``cpic_wheel`` is the repo's CPIC benchmark scene (``bench.py``,
``BENCH_MODE=cpic``): water poured on a free-spinning 6-paddle wheel on a
hub, joined by a rotation articulation.

``water_dam`` is the adaptive-dt dam break of ``scripts/async/water.py``
and ``sand_column`` the sand column of ``scripts/async/sand.py``, both
seeded on a lattice (the cells the earlier H100 measurements name).
``water_script`` and ``sand_paddles`` build their scripts' scenes line
for line, texture seeding and the sand source included.
``elastic_block_drop`` and ``sand_column_collapse`` are the JAX package's
baseline scenes.
"""

from __future__ import annotations

import numpy as np

from taichi_mpm_torch.core import levelset
from taichi_mpm_torch.core.adaptive import AsyncMPM
from taichi_mpm_torch.core.solver import MPM
from taichi_mpm_torch.rigid.mesh import cylinder_mesh, paddle_wheel_mesh
from taichi_mpm_torch.sampling import texture


def cube_lattice(cells_per_side: int, dx: float, origin, ppc_axis: int = 2,
                 jitter: float = 0.0, seed: int = 0) -> np.ndarray:
    """ppc_axis^d particles per cell on a regular sub-lattice (8 ppc default)."""
    g = box_lattice((0.0,) * 3, (cells_per_side * dx,) * 3, dx, ppc_axis)
    if jitter > 0:
        h = dx / ppc_axis
        rng = np.random.default_rng(seed)
        g = g + rng.uniform(-jitter * h, jitter * h, g.shape).astype(np.float32)
    return g + np.asarray(origin, np.float32)


def box_lattice(lo, hi, dx: float, ppc_axis: int = 2) -> np.ndarray:
    """ppc_axis^3 particles per cell on a regular sub-lattice, over
    round((hi - lo) / dx) cells from lo along each axis."""
    axes = []
    for a, b in zip(lo, hi):
        n = int(round((b - a) / dx)) * ppc_axis
        axes.append((np.arange(n, dtype=np.float32) + 0.5) * np.float32(dx / ppc_axis)
                    + np.float32(a))
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


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
    benchmark=125 / benchmark=8000). `material` is a material name, or a
    tuple of names that take the lattice's particles in turn (each with
    `mat_kw`). Runs on the card unless `device` names another."""
    sim = MPM(
        res=(res, res, res),
        base_delta_t=base_dt,
        gravity=(0.0, gravity, 0.0),
        device=device,
    )
    dx = sim.cfg.dx
    margin = (res - cells) // 2 * dx
    pos = cube_lattice(cells, dx, origin=(margin, margin, margin))
    names = (material,) if isinstance(material, str) else tuple(material)
    for i, name in enumerate(names):
        sim.add_particles(name, pos=pos[i::len(names)], density=400.0, ppc=8.0, **mat_kw)
    pad = 3.5 * dx
    sim.add_collider(
        levelset.box_domain(
            lo=(pad, pad, pad),
            hi=(res * dx - pad, res * dx - pad, res * dx - pad),
            friction=-1.0,
        )
    )
    return sim


WHEEL_CENTER = (0.5, 0.4, 0.5)


def cpic_wheel(n: int = 100_000, res: int = 96, seed: int = 0, device=None,
               lo=(0.25, 0.6, 0.35), hi=(0.75, 0.95, 0.65), vel=None, solver=MPM,
               material: str = "water", **solver_kw) -> MPM:
    """The CPIC benchmark of ``bench.py`` (``_bench_cpic``): n water
    particles (density 1000; or, with material="sand", sand at density
    2000 and friction angle 35, as ``scripts/mls-cpic/sand_*.py`` seed it)
    uniform in the box [lo, hi] (by default
    [0.25, 0.75] x [0.6, 0.95] x [0.35, 0.65]) from default_rng(seed),
    at rest unless `vel` is given, over a hub (cylinder, radius 0.04,
    half height 0.06, 16 sides, axis z) and a 6-paddle wheel, both
    codimensional with density 1, friction 0.2, angular damping 3, a
    scripted position at (0.5, 0.4, 0.5) and free rotation about z,
    joined by a rotation articulation; res^3 grid, dt 1e-4, gravity -10,
    penalty 1e3. `solver` is the solver class (MPM, or AsyncMPM with its
    keywords in `solver_kw`). Runs on the card unless `device` names
    another."""
    rng = np.random.default_rng(seed)
    sim = solver(res=(res, res, res), base_delta_t=1e-4, gravity=(0.0, -10.0, 0.0),
                 penalty=1e3, device=device, **solver_kw)
    extent = (np.asarray(hi, np.float64) - np.asarray(lo, np.float64)).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32) * extent + np.asarray(lo, np.float32)
    if material == "sand":
        sim.add_particles("sand", pos=pos, vel=vel, density=2000.0, friction_angle=35.0)
    else:
        sim.add_particles(material, pos=pos, vel=vel, density=1000.0)
    body = dict(density=1.0, friction=0.2, codimensional=True, angular_damping=3.0,
                scripted_position=lambda t: WHEEL_CENTER, rotation_axis=(0, 0, 1))
    hub = sim.add_particles("rigid", mesh=cylinder_mesh(radius=0.04, half_height=0.06, n=16,
                                                        axis=2), **body)
    wheel = sim.add_particles("rigid", mesh=paddle_wheel_mesh(), **body)
    sim.add_articulation("rotation", hub, wheel)
    return sim


def water_dam(res: int = 128, ppc_axis: int = 2, device=None) -> AsyncMPM:
    """The adaptive-dt water dam break of ``scripts/async/water.py``:
    AsyncMPM(res^3, base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6), a
    frictionless floor at y = 0.08, water (density 1000) in the box
    (0.1, 0.08, 0.1)-(0.35, 0.5, 0.9), seeded with ppc_axis^3 particles
    per cell on a lattice (about 1.4M at res 128). Runs on the card unless
    `device` names another."""
    sim = AsyncMPM(res=(res, res, res), base_delta_t=1e-3, frame_dt=0.01,
                   unit_delta_t=1e-6, device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.08, friction=0.0))
    pos = box_lattice((0.1, 0.08, 0.1), (0.35, 0.5, 0.9), sim.cfg.dx, ppc_axis)
    sim.add_particles("water", pos=pos, density=1000.0, ppc=float(ppc_axis ** 3))
    return sim


def sand_column(res: int = 64, ppc_axis: int = 2, device=None) -> AsyncMPM:
    """The adaptive-dt sand column collapse of ``scripts/async/sand.py``:
    AsyncMPM(res^3, base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6),
    a floor at y = 0.1 with friction 0.4, sand (density 2000, friction
    angle 35) in the box (0.45, 0.1, 0.45)-(0.55, 0.5, 0.55), seeded with
    ppc_axis^3 particles per cell on a lattice (the script seeds a
    texture of density 8). Runs on the card unless `device` names
    another."""
    sim = AsyncMPM(res=(res, res, res), base_delta_t=1e-3, frame_dt=0.01,
                   unit_delta_t=1e-6, device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.1, friction=0.4))
    pos = box_lattice((0.45, 0.1, 0.45), (0.55, 0.5, 0.55), sim.cfg.dx, ppc_axis)
    sim.add_particles("sand", pos=pos, density=2000.0, friction_angle=35.0,
                      ppc=float(ppc_axis ** 3))
    return sim


def elastic_block_drop(res: int = 64, cells: int = 24, **kw) -> MPM:
    """The JAX package's baseline scene 2: a fixed-corotated elastic
    block dropped in a box."""
    return benchmark_cube(cells=cells, res=res, material="jelly", E=2e4, nu=0.35, **kw)


def sand_column_collapse(res: int = 64, base_dt: float = 1e-4, device=None) -> MPM:
    """The JAX package's baseline scene 3: a Drucker-Prager sand column
    (res/8 cells wide, res/2 high, 8 particles per cell on a lattice)
    collapsing on the floor of a box with friction 0.4."""
    sim = MPM(res=(res, res, res), base_delta_t=base_dt, gravity=(0.0, -10.0, 0.0),
              device=device)
    dx = sim.cfg.dx
    w, h = res // 8, res // 2
    hx = dx / 2
    ax = (np.arange(w * 2, dtype=np.float32) + 0.5) * hx
    ay = (np.arange(h * 2, dtype=np.float32) + 0.5) * hx
    g = np.stack(np.meshgrid(ax, ay, ax, indexing="ij"), -1).reshape(-1, 3)
    origin = np.array([(res // 2 - w // 2) * dx, 4.0 * dx, (res // 2 - w // 2) * dx],
                      np.float32)
    sim.add_particles("sand", pos=g + origin, density=2000.0, friction_angle=35.0)
    pad = 3.5 * dx
    sim.add_collider(levelset.box_domain(lo=(pad, pad, pad),
                                         hi=(res * dx - pad, res * dx - pad, res * dx - pad),
                                         friction=0.4))
    return sim


def water_script(res: int = 64, device=None) -> AsyncMPM:
    """``scripts/async/water.py`` line for line: AsyncMPM(res^3,
    base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6), a frictionless
    floor at y = 0.08, and water (density 1000) seeded by Poisson disks
    from the texture box((0.1, 0.08, 0.1), (0.35, 0.5, 0.9)) * 6
    (1,056,758 particles at res 128). Runs on the card unless `device`
    names another."""
    sim = AsyncMPM(res=(res, res, res), base_delta_t=1e-3, frame_dt=0.01,
                   unit_delta_t=1e-6, device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.08, friction=0.0))
    dam = texture.box((0.1, 0.08, 0.1), (0.35, 0.5, 0.9)) * 6
    sim.add_particles("water", density=1000, density_tex=dam)
    return sim


SAND_SOURCE = texture.sphere((0.5, 0.85, 0.5), 0.05) * 8
SAND_SOURCE_FRAMES = 80


def sand_paddles(res: int = 64, device=None, solver=MPM) -> MPM:
    """``scripts/mls-cpic/sand_paddles.py`` line for line: res^3, dt 5e-5,
    frame_dt 0.01, penalty 1e3, capacity 50,000; a floor at y = 0.12 with
    friction 0.4; two 4-paddle wheels at x = 0.35 and 0.65 (y 0.3, z 0.5),
    codimensional, density 1, friction 0.4, scripted to turn at 180 deg/s
    in opposite senses. It holds no particles at first: its sand comes
    from ``sand_paddles_source``, the script's ``frame_update``. `solver`
    is the class (the runner's ``mpm_class``). Runs on the card unless
    `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-5, frame_dt=0.01, penalty=1e3,
                 capacity=50_000, device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.12, friction=0.4))
    for k, cx in enumerate((0.35, 0.65)):
        sim.add_particles(
            "rigid", mesh=paddle_wheel_mesh(n_paddles=4, inner=0.02, outer=0.1, half_w=0.04),
            density=1.0, friction=0.4, codimensional=True,
            scripted_position=lambda t, cx=cx: (cx, 0.3, 0.5),
            scripted_rotation=lambda t, k=k: (0.0, 0.0, (1 - 2 * (k % 2)) * 180.0 * t),
        )
    return sim


def sand_paddles_source(s, f):
    """The sand source of ``scripts/mls-cpic/sand_paddles.py`` (its
    ``frame_update``): for the first 80 frames, sand (density 2000,
    friction angle 35) emitted from the sphere texture at (0.5, 0.85,
    0.5), radius 0.05, density 8, falling at 0.8 m/s."""
    if f < SAND_SOURCE_FRAMES:
        s.add_particles("sand", density=2000, friction_angle=35.0, density_tex=SAND_SOURCE,
                        pd_source=True, vel=(0, -0.8, 0), delta_t=s.frame_dt)
