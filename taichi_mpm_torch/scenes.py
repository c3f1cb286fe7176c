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
``water_script``, ``async_balls`` (``scripts/async/balls.py``) and
``sand_paddles`` build their scripts' scenes line for line, texture
seeding and the sand source included, and so does ``water_wheel``
(``scripts/mls-cpic/water_wheel.py``, the water source included), which
runs on slabs with ``solver=DistributedMPM``.
``elastic_block_drop`` and ``sand_column_collapse`` are the JAX package's
baseline scenes.

The dense path's scenes: ``colliding_balls_energy`` and
``oscillating_jello`` build ``scripts/benchmark``'s energy scripts line
for line (``optimized=False``), ``tetris`` the 2-D scene of
``demos/tetris.py`` and ``mpm88`` the 2-D snow scene of the repo's
mls-mpm88 oracle test. Its 2-D CPIC scenes: ``sand_wheel_2d``
(``scripts/mls-cpic/sand_wheel_2D.py``, with its source
``sand_wheel_2d_source``) and ``async_wheel`` (``scripts/async/wheel.py``).

The other 3-D scene scripts, line for line: ``sand_layers``,
``colliding_balls_3d``, the adaptive ``async_combo``, ``async_sand``,
``async_slope`` and ``async_stork``, and the CPIC ``banana``,
``bunny_split``, ``buoyancy`` (its jets ``buoyancy_source``),
``goo_blocks``, ``robot`` (``reversed=True``: ``robot_reversed.py``),
``sand_stir`` and ``sand_sweep``; their scripted motions (``cutter_pos``,
``rod_pos``, ``blade_pos``) are numpy functions of the float32 time.

The slab frames' small scenes, from the JAX package's tests:
``crossing_blob`` and ``dam_frame`` (per-block async on slabs),
``spatial_strip`` and ``sharding_cube`` (the dense slab frames),
``plate_scene`` (CPIC on slabs and pencils), ``driver_jelly``,
``pencil_drift``, ``corner_cluster``, ``corner_crossing`` and
``diagonal_pair`` (the pencil mesh);
``tag_pending`` tags each particle's index so that runs match by id.
A scene that takes `ls` or `plate_mesh` is built by either package's
solver, with that package's levelset or mesh module.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from taichi_mpm_torch.core import levelset
from taichi_mpm_torch.core.adaptive import AsyncMPM
from taichi_mpm_torch.core.solver import MPM
from taichi_mpm_torch.rigid.mesh import (box_mesh, cylinder_mesh, paddle_wheel_mesh, plate_mesh,
                                         sphere_mesh, wheel_mesh_2d)
from taichi_mpm_torch.sampling import poisson, texture
from taichi_mpm_torch.utils import const


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
    solver=MPM,
    **mat_kw,
) -> MPM:
    """cells=25 -> 125k particles; cells=100 -> 8M (the reference's
    benchmark=125 / benchmark=8000). `material` is a material name, or a
    tuple of names that take the lattice's particles in turn (each with
    `mat_kw`). `solver` is the class (MPM, or DistributedMPM with its
    keywords bound). Runs on the card unless `device` names another."""
    sim = solver(
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


def _async_solver(solver, per_block: bool, solver_kw: dict) -> dict:
    """The keywords of an async script's solver: AsyncMPM's `per_block`
    where it is set (``DistributedAsyncMPM`` is per block and has none)."""
    return dict(solver_kw, per_block=True) if per_block else solver_kw


def water_script(res: int = 64, device=None, per_block: bool = False, solver=AsyncMPM,
                 **solver_kw) -> AsyncMPM:
    """``scripts/async/water.py`` line for line: AsyncMPM(res^3,
    base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6), a frictionless
    floor at y = 0.08, and water (density 1000) seeded by Poisson disks
    from the texture box((0.1, 0.08, 0.1), (0.35, 0.5, 0.9)) * 6
    (1,056,758 particles at res 128). `per_block` is AsyncMPM's (the
    per-block bucketed scheduler); `solver` is the class (AsyncMPM, or
    DistributedAsyncMPM with its keywords in `solver_kw`). Runs on the
    card unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6,
                 device=device, **_async_solver(solver, per_block, solver_kw))
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.08, friction=0.0))
    dam = texture.box((0.1, 0.08, 0.1), (0.35, 0.5, 0.9)) * 6
    sim.add_particles("water", density=1000, density_tex=dam)
    return sim


def async_balls(res: int = 64, device=None, per_block: bool = False, solver=AsyncMPM,
                **solver_kw) -> AsyncMPM:
    """``scripts/async/balls.py`` line for line, the script's
    CFL-heterogeneous scene: AsyncMPM(res^3, base_delta_t=1e-3,
    frame_dt=0.005, unit_delta_t=1e-6, no gravity), a stiff elastic ball
    (E 1e5, nu 0.3, density 400) seeded by Poisson disks from
    sphere((0.25, 0.5, 0.5), 0.07) * 8 moving at 3 m/s along x into a soft
    one (E 1e4) from sphere((0.65, 0.5, 0.5), 0.1) * 8 at rest.
    `per_block` and `solver` as ``water_script``'s. Runs on the card
    unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=1e-3, frame_dt=0.005, unit_delta_t=1e-6,
                 gravity=(0, 0, 0), device=device, **_async_solver(solver, per_block, solver_kw))
    t1 = texture.sphere((0.25, 0.5, 0.5), 0.07) * 8
    sim.add_particles("elastic", density=400, density_tex=t1, vel=(3.0, 0, 0), E=1e5, nu=0.3)
    t2 = texture.sphere((0.65, 0.5, 0.5), 0.1) * 8
    sim.add_particles("elastic", density=400, density_tex=t2, E=1e4, nu=0.3)
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


WATER_WHEEL_CENTER = (0.5, 0.5, 0.5)
# the stream strikes the paddles (reach |x - 0.5| <= 0.15) left of the axle
WATER_WHEEL_SOURCE = texture.ring((0.40, 0.85), inner=0.0, outer=0.04, axis=2).bound(
    2, 0.47, 0.53) * 8


def water_wheel(res: int = 64, device=None, solver=MPM) -> MPM:
    """``scripts/mls-cpic/water_wheel.py`` line for line: res^3, dt 5e-5,
    frame_dt 0.01, penalty 1e3, capacity max(50,000, 0.025 res^3); a floor
    at y = 0.1 with friction 0.2; a hub (cylinder, radius 0.04, half height
    0.06, 16 sides, axis z) and a 6-paddle wheel, both codimensional with
    density 1, friction 0.2, angular damping 3, their position scripted at
    (0.5, 0.5, 0.5) and free rotation about z, joined by a rotation
    articulation. It holds no particles at first: its water comes from
    ``water_wheel_source``, the script's ``frame_update``. `solver` is the
    class (the runner's ``mpm_class``: with SHARDS=N, ``DistributedMPM``).
    Runs on the card unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-5, frame_dt=0.01, penalty=1e3,
                 capacity=max(50_000, int(0.025 * res ** 3)), device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.1, friction=0.2))
    body = dict(density=1.0, friction=0.2, codimensional=True, angular_damping=3.0,
                scripted_position=lambda t: WATER_WHEEL_CENTER, rotation_axis=(0, 0, 1))
    hub = sim.add_particles("rigid", mesh=cylinder_mesh(radius=0.04, half_height=0.06, n=16,
                                                        axis=2), **body)
    wheel = sim.add_particles("rigid", mesh=paddle_wheel_mesh(), **body)
    sim.add_articulation("rotation", hub, wheel)
    return sim


def water_wheel_source(s, f):
    """The water source of ``scripts/mls-cpic/water_wheel.py`` (its
    ``frame_update``): every frame, water (density 1000) emitted from the
    ring texture at (0.40, 0.85), radius 0.04, z in [0.47, 0.53], density 8,
    falling at 0.5 m/s."""
    s.add_particles("water", density=1000, density_tex=WATER_WHEEL_SOURCE, pd_source=True,
                    vel=(0, -0.5, 0), delta_t=s.frame_dt)


def sand_paddles_source(s, f):
    """The sand source of ``scripts/mls-cpic/sand_paddles.py`` (its
    ``frame_update``): for the first 80 frames, sand (density 2000,
    friction angle 35) emitted from the sphere texture at (0.5, 0.85,
    0.5), radius 0.05, density 8, falling at 0.8 m/s."""
    if f < SAND_SOURCE_FRAMES:
        s.add_particles("sand", density=2000, friction_angle=35.0, density_tex=SAND_SOURCE,
                        pd_source=True, vel=(0, -0.8, 0), delta_t=s.frame_dt)


def colliding_balls_energy(res: int = 100, device=None, solver=MPM, **solver_kw) -> MPM:
    """``scripts/benchmark/colliding_balls_energy.py`` line for line: two
    jelly balls (radius 0.1 at x = 0.35 and 0.65, Poisson-seeded from a
    texture of density 8, density 400, E 5e3, nu 0.3) meeting at 0.5 m/s
    each in zero gravity, res^3, dt 3e-4, frame_dt 0.01, on the dense path
    (optimized=False); about 67k particles at res 100. `solver` is the
    class (MPM, or AsyncMPM with its keywords in `solver_kw`). Runs on the
    card unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=3e-4, frame_dt=0.01, gravity=(0, 0, 0),
                 optimized=False, device=device, **solver_kw)
    for cx, vx in ((0.35, 0.5), (0.65, -0.5)):
        tex = texture.sphere((cx, 0.5, 0.5), 0.1) * 8
        sim.add_particles("jelly", density=400, density_tex=tex, vel=(vx, 0, 0), E=5e3, nu=0.3)
    return sim


def oscillating_jello(res: int = 50, device=None, solver=MPM, **solver_kw) -> MPM:
    """``scripts/benchmark/oscillating_jello.py`` line for line: a jelly
    block (0.35, 0.4, 0.4)-(0.65, 0.6, 0.6), Poisson-seeded at density 8,
    stretched by an outward velocity 4 (x - 0.5) along x, in zero gravity,
    res^3, dt 5e-4, frame_dt 0.01, on the dense path (optimized=False).
    `solver` is the class (MPM, or AsyncMPM with its keywords in
    `solver_kw`). Runs on the card unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-4, frame_dt=0.01, gravity=(0, 0, 0),
                 optimized=False, device=device, **solver_kw)
    tex = texture.box((0.35, 0.4, 0.4), (0.65, 0.6, 0.6)) * 8
    pos = poisson.sample_from_periodic_data(tex, np.zeros(3), np.ones(3), sim.cfg.dx, 3)
    vel = np.zeros_like(pos)
    vel[:, 0] = (pos[:, 0] - 0.5) * 4.0
    sim.add_particles("jelly", pos=pos, vel=vel, density=400, E=5e3, nu=0.3)
    return sim


TETROMINOES = {
    "T": [(0, 0), (1, 0), (2, 0), (1, 1)],
    "L": [(0, 0), (0, 1), (0, 2), (1, 0)],
    "O": [(0, 0), (1, 0), (0, 1), (1, 1)],
    "I": [(0, 0), (0, 1), (0, 2), (0, 3)],
}


def tetromino_particles(shape, origin, cell=0.04, ppc_axis=4) -> np.ndarray:
    """A tetromino's particles: ppc_axis^2 per square cell on a lattice."""
    pts = []
    h = cell / ppc_axis
    for cx, cy in TETROMINOES[shape]:
        ax = (np.arange(ppc_axis) + 0.5) * h
        g = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)
        pts.append(g + np.asarray(origin) + np.asarray([cx, cy]) * cell)
    return np.concatenate(pts).astype(np.float32)


def tetris(res: int = 128, device=None, solver=MPM, **solver_kw) -> MPM:
    """``demos/tetris.py``'s 2-D scene: six tetrominoes of jelly (E 2e4,
    nu 0.3), snow (E 1.4e5, nu 0.2) and water (k 1e4) in turn, density
    800 (water 1000), dropped under gravity -20 into a box of frictional
    walls (0.3) at x = 0.05, 0.95 and a floor at y = 0.05; res^2, dt
    1e-4, frame_dt 4e-3 (384 particles). Runs on the card unless `device`
    names another."""
    sim = solver(res=(res, res), base_delta_t=1e-4, frame_dt=4e-3, gravity=(0, -20.0),
                 device=device, **solver_kw)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.05, friction=0.3))
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 0] - 0.05, friction=0.3))
    sim.add_collider(levelset.Collider(sdf=lambda x, t: 0.95 - x[..., 0], friction=0.3))
    mats = [("jelly", dict(E=2e4, nu=0.3)), ("snow", dict(E=1.4e5, nu=0.2)),
            ("water", dict(k=1e4))]
    shapes = list(TETROMINOES)
    for k in range(6):
        mat, kw = mats[k % len(mats)]
        pos = tetromino_particles(shapes[k % len(shapes)], origin=(0.2 + 0.1 * k, 0.5 + 0.06 * k))
        sim.add_particles(mat, pos=pos, density=800 if mat != "water" else 1000, **kw)
    return sim


MPM88_WALL = 0.045  # between grid nodes, as the oracle test places it


def mpm88_colliders():
    """The box of the mls-mpm88 and tetris compiled references: sticky
    walls left, right and top, a separating floor (band reaching every
    node behind each wall)."""
    w = MPM88_WALL
    return [
        levelset.Collider(sdf=lambda x, t: x[..., 0] - w, friction=-1.0, band_lo=-1e9),
        levelset.Collider(sdf=lambda x, t: (1 - w) - x[..., 0], friction=-1.0, band_lo=-1e9),
        levelset.Collider(sdf=lambda x, t: (1 - w) - x[..., 1], friction=-1.0, band_lo=-1e9),
        levelset.Collider(sdf=lambda x, t: x[..., 1] - w, friction=0.0, band_lo=-1e9),
    ]


def mpm88(pos=None, device=None, solver=MPM, **solver_kw) -> MPM:
    """The 2-D mls-mpm88 scene of the repo's oracle test: res 80^2, dt
    1e-4, frame_dt 1e-3, gravity -200, snow (E 1e4, nu 0.2, hardening 10)
    of unit mass and volume in ``mpm88_colliders``' box. `pos` defaults
    to the test's 192 particles (uniform in a square of half-width 0.08
    about (0.5, 0.55), from default_rng(42)). Runs on the card unless
    `device` names another."""
    if pos is None:
        rng = np.random.default_rng(42)
        pos = (rng.uniform(-1, 1, size=(192, 2)) * 0.08 + np.array([0.5, 0.55])).astype(np.float32)
    sim = solver(res=(80, 80), base_delta_t=1e-4, frame_dt=1e-3, gravity=(0.0, -200.0),
                 device=device, **solver_kw)
    sim.add_particles("snow", pos=pos, mass=1.0, vol=1.0, youngs_modulus=1e4, poisson_ratio=0.2,
                      hardening=10.0)
    for c in mpm88_colliders():
        sim.add_collider(c)
    return sim


def _wheel_2d(sim):
    """The free-spinning wheel of the 2-D CPIC scripts over their floor."""
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.05, friction=0.4))
    sim.add_particles("rigid", mesh=wheel_mesh_2d(radius=0.12, n_spokes=6, spoke_width=0.03),
                      codimensional=True, friction=0.3, density=5.0,
                      scripted_position=lambda t: (0.5, 0.45))
    return sim


def sand_wheel_2d(res: int = 128, device=None, solver=MPM) -> MPM:
    """``scripts/mls-cpic/sand_wheel_2D.py`` line for line: res^2, dt 1e-4,
    frame_dt 0.01, penalty 1e3, capacity 100,000; a floor at y = 0.05 with
    friction 0.4; a 6-spoke wheel (radius 0.12, spokes 0.03 wide),
    codimensional, density 5, friction 0.3, its position scripted at
    (0.5, 0.45) and its rotation free. It holds no particles at first: its
    sand comes from ``sand_wheel_2d_source``, the script's
    ``frame_update``. `solver` is the class (the runner's ``mpm_class``).
    Runs on the card unless `device` names another."""
    return _wheel_2d(solver(res=(res, res), base_delta_t=1e-4, frame_dt=0.01, penalty=1e3,
                            gravity=(0, -10.0), capacity=100_000, device=device))


WHEEL_2D_SOURCE = texture.box((0.46, 0.8), (0.54, 0.88)) * 6
WHEEL_2D_SOURCE_FRAMES = 150


def sand_wheel_2d_source(s, f):
    """The sand source of ``scripts/mls-cpic/sand_wheel_2D.py`` (its
    ``frame_update``): for the first 150 frames, sand (density 2000,
    friction angle 35) emitted from the box texture [0.46, 0.54] x [0.8,
    0.88] of density 6, falling at 0.6 m/s."""
    if f < WHEEL_2D_SOURCE_FRAMES:
        s.add_particles("sand", density=2000, friction_angle=35.0, density_tex=WHEEL_2D_SOURCE,
                        pd_source=True, vel=(0.0, -0.6), delta_t=s.frame_dt)


def async_wheel(res: int = 128, device=None) -> AsyncMPM:
    """``scripts/async/wheel.py`` line for line: AsyncMPM(res^2,
    base_delta_t=2e-4, frame_dt=0.01, unit_delta_t=1e-6), penalty 1e3,
    capacity 100,000, the wheel of ``sand_wheel_2d`` over its floor, and a
    sand column (density 2000, friction angle 35) seeded by Poisson disks
    from the texture box((0.44, 0.62), (0.56, 0.82)) * 6 (2,361 particles
    at res 128). Runs on the card unless `device` names another."""
    sim = _wheel_2d(AsyncMPM(res=(res, res), base_delta_t=2e-4, frame_dt=0.01,
                             unit_delta_t=1e-6, penalty=1e3, gravity=(0, -10.0),
                             capacity=100_000, device=device))
    sim.add_particles("sand", density=2000, friction_angle=35.0,
                      density_tex=texture.box((0.44, 0.62), (0.56, 0.82)) * 6)
    return sim


# -- the other 3-D scene scripts, line for line. Their callables are numpy
# functions of the float32 time the rigid advance passes (the scripted
# motions) or torch functions of the node positions (the colliders). ------------------


def layer_cohesion(p):
    """``scripts/sand_layers.py``'s cohesion texture: four horizontal
    bands from y = 0.1, 0.1125 thick, alternating loose (1e-4) and
    strongly cohesive (4e-2)."""
    band = np.floor((p[..., 1] - 0.1) / 0.1125).astype(np.int32)
    return np.where(band % 2 == 0, 1e-4, 4e-2)


def sand_layers(res: int = 64, device=None, solver=MPM) -> MPM:
    """``scripts/sand_layers.py`` line for line: res^3, dt 2e-4, frame_dt
    0.01, gravity -9.8; a floor at y = 0.1 with friction 0.4; a sand column
    (density 2000, friction angle 35) Poisson-seeded from box((0.42, 0.1,
    0.42), (0.58, 0.55, 0.58)) * 8, each particle's cohesion from
    ``layer_cohesion`` at its seed. Runs on the card unless `device` names
    another."""
    sim = solver(res=(res, res, res), base_delta_t=2e-4, frame_dt=0.01, gravity=(0, -9.8, 0),
                 device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.1, friction=0.4))
    col = texture.box((0.42, 0.1, 0.42), (0.58, 0.55, 0.58)) * 8
    sim.add_particles("sand", density=2000, friction_angle=35.0, density_tex=col,
                      cohesion_tex=layer_cohesion)
    return sim


def colliding_balls_3d(res: int = 64, device=None, solver=MPM) -> MPM:
    """``scripts/benchmark/colliding_balls_3d_test.py`` line for line:
    res^3, dt 1e-4, frame_dt 0.01, gravity -10; a floor at y = 0.08 with
    friction 0.2; two jelly balls (radius 0.08 at x = 0.3 and 0.7, y 0.4,
    Poisson-seeded at density 8, density 400, E 2e4, nu 0.35) meeting at 1
    m/s each. Runs on the card unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=1e-4, frame_dt=0.01, device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.08, friction=0.2))
    for cx, vx in ((0.3, 1.0), (0.7, -1.0)):
        tex = texture.sphere((cx, 0.4, 0.5), 0.08) * 8
        sim.add_particles("jelly", density=400, density_tex=tex, vel=(vx, 0, 0), E=2e4, nu=0.35)
    return sim


def async_combo(res: int = 64, device=None, solver=AsyncMPM) -> AsyncMPM:
    """``scripts/async/combo.py`` line for line: AsyncMPM(res^3,
    base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6); a floor at y =
    0.1 with friction 0.3; three balls of radius 0.07 Poisson-seeded at
    density 6: snow (density 400, E 1.4e5, nu 0.2) at (0.3, 0.6, 0.5),
    visco (density 800, E 5e3, nu 0.4) at (0.5, 0.75, 0.5) and sand
    (density 2000, friction angle 35) at (0.7, 0.6, 0.5). Runs on the card
    unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6,
                 device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.1, friction=0.3))
    sim.add_particles("snow", density=400, E=1.4e5, nu=0.2,
                      density_tex=texture.sphere((0.3, 0.6, 0.5), 0.07) * 6)
    sim.add_particles("visco", density=800, E=5e3, nu=0.4,
                      density_tex=texture.sphere((0.5, 0.75, 0.5), 0.07) * 6)
    sim.add_particles("sand", density=2000, friction_angle=35.0,
                      density_tex=texture.sphere((0.7, 0.6, 0.5), 0.07) * 6)
    return sim


def async_sand(res: int = 64, device=None, solver=AsyncMPM) -> AsyncMPM:
    """``scripts/async/sand.py`` line for line (``sand_column`` is its
    lattice-seeded cell): AsyncMPM(res^3, base_delta_t=1e-3,
    frame_dt=0.01, unit_delta_t=1e-6); a floor at y = 0.1 with friction
    0.4; sand (density 2000, friction angle 35) Poisson-seeded from
    box((0.45, 0.1, 0.45), (0.55, 0.5, 0.55)) * 8. Runs on the card unless
    `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6,
                 device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.1, friction=0.4))
    col = texture.box((0.45, 0.1, 0.45), (0.55, 0.5, 0.55)) * 8
    sim.add_particles("sand", density=2000, friction_angle=35.0, density_tex=col)
    return sim


# scripts/async/slope.py's slope normal, normalized in float64 as the script does
SLOPE_NORMAL = np.array([0.4, 1.0, 0.0]) / np.linalg.norm(np.array([0.4, 1.0, 0.0]))


def async_slope(res: int = 64, device=None, solver=AsyncMPM) -> AsyncMPM:
    """``scripts/async/slope.py`` line for line: AsyncMPM(res^3,
    base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6); the slope
    x n0 + y n1 = 0.35 (n = (0.4, 1, 0) normalized) with friction 0.25;
    snow (density 400, E 1.4e5, nu 0.2) Poisson-seeded from
    sphere((0.3, 0.65, 0.5), 0.08) * 6. Runs on the card unless `device`
    names another."""
    n = SLOPE_NORMAL
    sim = solver(res=(res, res, res), base_delta_t=1e-3, frame_dt=0.01, unit_delta_t=1e-6,
                 device=device)
    sim.add_collider(levelset.Collider(
        sdf=lambda x, t: x[..., 0] * n[0] + x[..., 1] * n[1] - 0.35, friction=0.25))
    blob = texture.sphere((0.3, 0.65, 0.5), 0.08) * 6
    sim.add_particles("snow", density=400, density_tex=blob, E=1.4e5, nu=0.2)
    return sim


def box_sdf(lo, hi):
    """The SDF of the solid box [lo, hi] (negative inside), as
    ``scripts/async/stork.py``'s ``_box_sdf``: |x - c| - h, the norm of its
    positive part outside, its largest component inside."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    c = ((lo + hi) / 2.0).tolist()
    h = ((hi - lo) / 2.0).tolist()

    def sdf(x, t):
        q = torch.abs(x - const(c, device=x.device)) - const(h, device=x.device)
        outside = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
        inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
        return outside + inside

    return sdf


STORK_SPEED = 4.0  # the head's nod: it moves down at STORK_SPEED / 4 m/s


def async_stork(res: int = 64, device=None, solver=AsyncMPM) -> AsyncMPM:
    """``scripts/async/stork.py`` line for line: AsyncMPM(res^3,
    base_delta_t=8e-4, frame_dt=0.01, unit_delta_t=1e-6,
    strength_dt_mul=0.8), no gravity; the sticky pedestal box (0.5, 0.1,
    0.3)-(0.7, 0.35, 0.7) (``box_sdf``, friction -1); five elastic parts
    (density 10, nu 0.3) Poisson-seeded at density 10: legs E 4e5, body
    4e3, shoulder joint 2e4, neck 4e3, and the head 4e3 moving down at 1
    m/s. Runs on the card unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=8e-4, frame_dt=0.01, unit_delta_t=1e-6,
                 strength_dt_mul=0.8, gravity=(0.0, 0.0, 0.0), device=device)
    sim.add_collider(levelset.Collider(sdf=box_sdf((0.5, 0.1, 0.3), (0.7, 0.35, 0.7)),
                                       friction=-1.0))
    legs = texture.box((0.585, 0.32, 0.48), (0.615, 0.5, 0.52)) * 10
    body = texture.sphere((0.6, 0.52, 0.5), 0.055) * 10
    joint = texture.sphere((0.56, 0.56, 0.5), 0.03) * 10
    neck = texture.box((0.47, 0.56, 0.485), (0.56, 0.60, 0.515)) * 10
    head = texture.sphere((0.46, 0.62, 0.5), 0.035) * 10
    sim.add_particles("elastic", density=10, E=4e5, nu=0.3, density_tex=legs)
    sim.add_particles("elastic", density=10, E=4e3, nu=0.3, density_tex=body)
    sim.add_particles("elastic", density=10, E=2e4, nu=0.3, density_tex=joint)
    sim.add_particles("elastic", density=10, E=4e3, nu=0.3, density_tex=neck)
    sim.add_particles("elastic", density=10, E=4e3, nu=0.3, vel=(0.0, -0.25 * STORK_SPEED, 0.0),
                      density_tex=head)
    return sim


# scripts/mls-cpic/banana.py's zig-zag cutter: down, sideways, up, sideways
CUTTER_LENGTH, CUTTER_WIDTH = 0.20, 0.03
CUTTER_X, CUTTER_Y, CUTTER_Z, CUTTER_SPEED = 0.6, 0.67, 0.5, 0.5
CUTTER_PERIOD = (2 * CUTTER_LENGTH + 3 * CUTTER_WIDTH) / CUTTER_SPEED


def cutter_pos(t):
    """``banana.py``'s ``cutter_pos`` on a float32 time, in float32 (the
    script's Python constants round to float32 where they meet t, as
    JAX's weak types do)."""
    f = np.float32
    length, width = CUTTER_LENGTH, CUTTER_WIDTH
    t = f(t)
    i = np.floor(t / f(CUTTER_PERIOD))
    dis = f(CUTTER_SPEED) * (t - f(CUTTER_PERIOD) * i)
    x0 = f(CUTTER_X) - f(width) * i
    if dis < f(length):
        return (x0, f(CUTTER_Y) - dis, CUTTER_Z)
    if dis < f(length + width):
        return (x0 + (dis - f(length)), f(CUTTER_Y - length), CUTTER_Z)
    if dis < f(2 * length + width):
        return (x0 + f(width), f(CUTTER_Y) - (f(2 * length + width) - dis), CUTTER_Z)
    return (x0 + f(width) - (dis - f(2 * length + width)) * f(0.0), f(CUTTER_Y), CUTTER_Z)


def banana(res: int = 96, device=None, solver=MPM) -> MPM:
    """``scripts/mls-cpic/banana.py`` line for line: res^3, dt 5e-5,
    frame_dt 0.01, penalty 1e3, cfl 0.5, rpic_damping 1; sticky floors at
    y = 0.42 and x = 0.16; a von Mises ellipsoid (``sphere_mesh`` scaled
    to (0.16, 0.05, 0.07) at (0.5, 0.47, 0.5), density 8, density 400,
    E 4e5, nu 0.4, yield stress 5) cut by a codimensional sticky plate
    (half size 0.1, normal x) moved by ``cutter_pos``, its rotation
    scripted at zero. `solver` is the class (the runner's ``mpm_class``).
    Runs on the card unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-5, frame_dt=0.01, penalty=1e3, cfl=0.5,
                 rpic_damping=1.0, device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.42, friction=-1.0))
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 0] - 0.16, friction=-1.0))
    tex = texture.mesh(sphere_mesh(1.0, subdiv=2), translate=(0.5, 0.47, 0.5),
                       scale=(0.16, 0.05, 0.07)) * 8
    sim.add_particles("von_mises", density=400, density_tex=tex, E=4e5, nu=0.4, yield_stress=5.0)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.1, half_v=0.1, axis=0),
                      codimensional=True, friction=-1.0, scripted_position=cutter_pos,
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0))
    return sim


def bunny_split(res: int = 96, device=None, solver=MPM) -> MPM:
    """``scripts/mls-cpic/bunny_split.py`` line for line: res^3, dt 5e-5,
    frame_dt 0.01, penalty 1e3; a floor at y = 0.1 with friction 0.2; a
    jelly ball (radius 0.12 at (0.5, 0.6, 0.5), density 8, density 400, E
    5e4, nu 0.35) falling on a static frictionless codimensional plate
    (half size 0.18, normal x) at (0.5, 0.25, 0.5). Runs on the card
    unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-5, frame_dt=0.01, penalty=1e3,
                 device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.1, friction=0.2))
    tex = texture.sphere((0.5, 0.6, 0.5), 0.12) * 8
    sim.add_particles("jelly", density=400, density_tex=tex, E=5e4, nu=0.35)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.18, half_v=0.18, axis=0),
                      codimensional=True, friction=0.0,
                      scripted_position=lambda t: (0.5, 0.25, 0.5),
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0))
    return sim


BUOYANCY_FRICTION = 0.3
BUOYANCY_JET_TIME = 1.0  # the jets pour while t < 1 s
BUOYANCY_JETS = tuple(
    texture.ring((0.33, 0.8), inner=0.0, outer=0.035, axis=2).bound(2, lo, hi) * 8
    for lo, hi in ((0.41, 0.47), (0.53, 0.59)))


def buoyancy(res: int = 64, device=None, solver=MPM) -> MPM:
    """``scripts/mls-cpic/buoyancy.py`` line for line: res^3, dt 5e-5,
    frame_dt 0.01, penalty 1e3, pushing force 0, capacity 120,000; the tank
    ``box_domain`` (0.2, 0.18, 0.35)-(0.8, 0.95, 0.65), friction 0.3; six
    dynamic cubes (half size 0.018, friction 0.3) in two rows at x = 0.56,
    density 200, 400, 600 along z; a pool of water (density 1000) from
    box((0.21, 0.19, 0.36), (0.79, 0.24, 0.64)) * 4. Its jets come from
    ``buoyancy_source``, the script's ``frame_update``. `solver` is the
    class (the runner's ``mpm_class``). Runs on the card unless `device`
    names another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-5, frame_dt=0.01, penalty=1e3,
                 pushing_force=0.0, capacity=120_000, device=device)
    sim.add_collider(levelset.box_domain(lo=(0.2, 0.18, 0.35), hi=(0.8, 0.95, 0.65),
                                         friction=BUOYANCY_FRICTION))
    cube = box_mesh((0.018, 0.018, 0.018))
    for j in range(2):
        for k in range(3):
            sim.add_particles("rigid", mesh=cube, density=200.0 * (k + 1),
                              friction=BUOYANCY_FRICTION, codimensional=False,
                              initial_position=(0.56, 0.255 + 0.04 * j, 0.44 + 0.04 * k))
    pool = texture.box((0.21, 0.19, 0.36), (0.79, 0.24, 0.64)) * 4
    sim.add_particles("water", density=1000, density_tex=pool)
    return sim


def buoyancy_source(s, f):
    """The jets of ``scripts/mls-cpic/buoyancy.py`` (its ``frame_update``):
    while t < 1 s, water (density 1000) emitted from two rings at (0.33,
    0.8), radius 0.035, z in [0.41, 0.47] and [0.53, 0.59], density 8,
    falling at 2 m/s."""
    if float(s.t) < BUOYANCY_JET_TIME:
        for jet in BUOYANCY_JETS:
            s.add_particles("water", density=1000, density_tex=jet, pd_source=True,
                            vel=(0, -2.0, 0), delta_t=s.frame_dt)


def goo_blocks(res: int = 64, device=None, solver=MPM) -> MPM:
    """``scripts/mls-cpic/goo_blocks.py`` line for line: res^3, dt 5e-5,
    frame_dt 0.01, penalty 1e3; a floor at y = 0.1 with friction 0.3; visco
    goo (density 800, E 5e3, nu 0.4) from box((0.2, 0.1, 0.2), (0.8, 0.35,
    0.8)) * 4; three dynamic boxes (half size 0.04, density 600, friction
    0.2) dropped from y = 0.6, 0.7, 0.8. Runs on the card unless `device`
    names another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-5, frame_dt=0.01, penalty=1e3,
                 device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.1, friction=0.3))
    goo = texture.box((0.2, 0.1, 0.2), (0.8, 0.35, 0.8)) * 4
    sim.add_particles("visco", density=800, density_tex=goo, E=5e3, nu=0.4)
    for k, (cx, cz) in enumerate(((0.35, 0.4), (0.6, 0.55), (0.48, 0.65))):
        sim.add_particles("rigid", mesh=box_mesh((0.04, 0.04, 0.04)), codimensional=False,
                          density=600.0, friction=0.2, initial_position=(cx, 0.6 + 0.1 * k, cz))
    return sim


ROBOT_SPIN = 12.0  # rad/s, the steppers' wheel spin (reversed: -12)


def robot(res: int = 64, device=None, solver=MPM, reversed: bool = False) -> MPM:
    """``scripts/mls-cpic/robot.py`` line for line (with `reversed`,
    ``robot_reversed.py``): res^3, dt 5e-5, frame_dt 0.01, penalty 1e3; a
    floor at y = 0.12 with friction 0.4; a sand bed (density 2000,
    friction angle 35) from box((0.1, 0.12, 0.35), (0.9, 0.2, 0.65)) * 4;
    a dynamic box body (half size (0.08, 0.02, 0.05), density 300,
    friction 0.3) at (0.35, 0.27, 0.5); two codimensional cylinder wheels
    (radius 0.045, half height 0.055, 16 sides, axis z, density 50,
    friction 0.8) at x = 0.29 and 0.41, y 0.24, each joined to the body by
    a stepper about z at +12 rad/s (reversed: -12), axis length 0.05,
    penalty 1e3. Runs on the card unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-5, frame_dt=0.01, penalty=1e3,
                 device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.12, friction=0.4))
    bed = texture.box((0.1, 0.12, 0.35), (0.9, 0.2, 0.65)) * 4
    sim.add_particles("sand", density=2000, friction_angle=35.0, density_tex=bed)
    body = sim.add_particles("rigid", mesh=box_mesh((0.08, 0.02, 0.05)), codimensional=False,
                             density=300.0, friction=0.3, initial_position=(0.35, 0.27, 0.5))
    spin = -ROBOT_SPIN if reversed else ROBOT_SPIN
    for dxw in (-0.06, 0.06):
        w = sim.add_particles(
            "rigid", mesh=cylinder_mesh(radius=0.045, half_height=0.055, n=16, axis=2),
            codimensional=True, density=50.0, friction=0.8, initial_position=(0.35 + dxw, 0.24, 0.5))
        sim.add_articulation("stepper", w, body, axis=(0, 0, 1), angular_velocity=spin,
                             axis_length=0.05, offset0=(0.0, 0.0, 0.0), penalty=1e3)
    return sim


def fma32(a, b, c):
    """a b + c of float32 values with one rounding: XLA's CPU code fuses a
    script's product and sum (0.15 + 0.4 t) into one fused multiply-add
    (the float64 product of two float32 values is exact)."""
    return np.float32(np.float64(np.float32(a)) * np.float64(np.float32(b))
                      + np.float64(np.float32(c)))


STIR_OMEGA = 2.0 * math.pi * 0.4  # rad/s, scripts/mls-cpic/sand_stir.py's rod


def rod_pos(t):
    """``sand_stir.py``'s ``rod_pos`` on a float32 time: a circle of radius
    0.18 about (0.5, 0.5) in x-z at 0.4 turns a second, y 0.22; cos and sin
    of the float32 angle evaluated in float64 and rounded (the closest
    match to XLA's float32 ones, ``math.quat.cos_sin``), the rest as
    ``fma32``."""
    a = np.float64(np.float32(STIR_OMEGA) * np.float32(t))
    c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
    return (fma32(0.18, c, 0.5), 0.22, fma32(0.18, s, 0.5))


def sand_stir(res: int = 64, device=None, solver=MPM) -> MPM:
    """``scripts/mls-cpic/sand_stir.py`` line for line: res^3, dt 5e-5,
    frame_dt 0.01, penalty 1e3; a floor at y = 0.1 with friction 0.4; a
    sand bed (density 2000, friction angle 35) from box((0.2, 0.1, 0.2),
    (0.8, 0.25, 0.8)) * 4; a codimensional rod (cylinder radius 0.02, half
    height 0.12, 12 sides, axis y, friction 0.4) moved by ``rod_pos``, its
    rotation scripted at zero. Runs on the card unless `device` names
    another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-5, frame_dt=0.01, penalty=1e3,
                 device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.1, friction=0.4))
    bed = texture.box((0.2, 0.1, 0.2), (0.8, 0.25, 0.8)) * 4
    sim.add_particles("sand", density=2000, friction_angle=35.0, density_tex=bed)
    sim.add_particles("rigid", mesh=cylinder_mesh(radius=0.02, half_height=0.12, n=12, axis=1),
                      codimensional=True, friction=0.4, scripted_position=rod_pos,
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0))
    return sim


def blade_pos(t):
    """``sand_sweep.py``'s ``blade_pos`` on a float32 time: x = 0.15 +
    0.4 min(t, 1.2) (``fma32``), y 0.18, z 0.5."""
    return (fma32(0.4, min(np.float32(t), np.float32(1.2)), 0.15), 0.18, 0.5)


def sand_sweep(res: int = 64, device=None, solver=MPM) -> MPM:
    """``scripts/mls-cpic/sand_sweep.py`` line for line: res^3, dt 5e-5,
    frame_dt 0.01, penalty 1e3; a floor at y = 0.1 with friction 0.4; a
    sand pile (density 2000, friction angle 35) from box((0.4, 0.1, 0.35),
    (0.6, 0.22, 0.65)) * 4; a codimensional blade (plate, half sizes 0.08
    and 0.15, normal x, friction 0.3) moved by ``blade_pos``, its rotation
    scripted at zero. Runs on the card unless `device` names another."""
    sim = solver(res=(res, res, res), base_delta_t=5e-5, frame_dt=0.01, penalty=1e3,
                 device=device)
    sim.add_collider(levelset.Collider(sdf=lambda x, t: x[..., 1] - 0.1, friction=0.4))
    pile = texture.box((0.4, 0.1, 0.35), (0.6, 0.22, 0.65)) * 4
    sim.add_particles("sand", density=2000, friction_angle=35.0, density_tex=pile)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.08, half_v=0.15, axis=0),
                      codimensional=True, friction=0.3, scripted_position=blade_pos,
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0))
    return sim


# -- the slab frames' small scenes: the JAX package's tests' scenes, which the
# port's tests and chip_smoke.py hold the slab frames to --------------------------------

ID_SLOT = 7  # a params slot no material reads: tag_pending puts each index there
SLAB_UNIT = 5e-4  # tests/test_async_spatial.py's unit: frames of 64 units


def tag_pending(sim):
    """Each pending particle's index in params[:, ID_SLOT], so that two
    runs can be matched particle by particle. Returns `sim`."""
    first = 0
    for batch in sim._pending:
        n = batch["x"].shape[0]
        batch["params"][:, ID_SLOT] = np.arange(first, first + n, dtype=np.float32)
        first += n
    return sim


def crossing_blob(solver=AsyncMPM, device=None, **solver_kw):
    """tests/test_async_spatial.py:110-139's scene: 1,200 elastic
    particles (E 4e3) in [0.30, 0.55] x [0.3, 0.7]^2 moving at 1 m/s along
    x, res 32, no gravity, a frame of 64 units of 5e-4 s: the frame
    re-sorts and particles cross x = 0.5. Ids tagged."""
    pos = np.random.default_rng(0).uniform((0.30, 0.3, 0.3), (0.55, 0.7, 0.7),
                                           (1200, 3)).astype(np.float32)
    sim = solver(res=(32, 32, 32), base_delta_t=1e-3, frame_dt=SLAB_UNIT * 64,
                 unit_delta_t=SLAB_UNIT, gravity=(0.0, 0.0, 0.0), device=device, **solver_kw)
    sim.add_particles("elastic", pos=pos, vel=(1.0, 0.0, 0.0), E=4e3, nu=0.3, density=1000)
    return tag_pending(sim)


def dam_frame(res: int, solver=AsyncMPM, device=None, **solver_kw):
    """``water_script`` at `res` with frames of 5e-4 s: all its water lies
    in x < 0.35, so on two slabs the right one starts empty (2,081
    particles at res 16). Ids tagged."""
    sim = water_script(res, device=device, solver=solver, **solver_kw)
    sim.frame_dt = 5e-4
    return tag_pending(sim)


def spatial_strip(solver=MPM, vel_x: float = 1.0, **solver_kw):
    """tests/test_spatial.py's 2-D scene: 400 jelly particles on a 40 x 10
    lattice in [0.1, 0.9] x [0.5, 0.7] moving at vel_x, res 64, dt 2e-4,
    gravity -10. `solver` is any class with MPM's constructor."""
    sim = solver(res=(64, 64), base_delta_t=2e-4, frame_dt=2e-3, gravity=(0, -10.0),
                 **solver_kw)
    pos = np.stack(np.meshgrid(np.linspace(0.1, 0.9, 40), np.linspace(0.5, 0.7, 10)),
                   -1).reshape(-1, 2)
    vel = np.zeros_like(pos)
    vel[:, 0] = vel_x
    sim.add_particles("jelly", pos=pos, vel=vel, E=1e4, nu=0.3)
    return sim


def sharding_cube(device=None) -> MPM:
    """tests/test_sharding.py's scene: benchmark_cube(cells=4, res=16),
    512 jelly particles in a sticky box."""
    return benchmark_cube(cells=4, res=16, material="jelly", E=2e4, nu=0.35, device=device)


def plate_scene(solver, plate_mesh, free: bool = False, center=(0.5, 0.4, 0.5), **solver_kw):
    """tests/test_distributed_driver.py:79-121's (and :153-168's) scene:
    400 jelly particles uniform in [0.25, 0.75]^3 moving at (1, -0.5, 0),
    res 32, penalty 1e3, over a plate (half size 0.22, normal y) at
    `center`, (0.5, 0.4, 0.5), which straddles the slab and pencil
    boundary at x = 0.5 (at (0.5, 0.49, 0.5) it lies across the corner of
    four pencils of a (2, 2) mesh); its rotation scripted, or free with
    `free`; frames of 6 substeps. `plate_mesh` is the mesh module's of
    `solver`'s package; ids tagged."""
    rng = np.random.default_rng(3)
    sim = solver(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=12e-4, gravity=(0, -10.0, 0),
                 penalty=1e3, **solver_kw)
    pos = rng.uniform(0.25, 0.75, size=(400, 3)).astype(np.float32)
    sim.add_particles("jelly", pos=pos, vel=(1.0, -0.5, 0), E=1e4, nu=0.3, density=1000)
    motion = {} if free else dict(scripted_rotation=lambda t: (0.0, 0.0, 0.0))
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.22, half_v=0.22, axis=1),
                      scripted_position=lambda t: center, codimensional=True,
                      friction=0.2, **motion)
    return tag_pending(sim)


def driver_jelly(solver=MPM, n: int = 600, ls=levelset, **solver_kw):
    """tests/test_distributed_driver.py:17-28's scene: `n` jelly particles
    uniform in [0.15, 0.85]^3 moving at (1, 0, 0) in a box (0.1 to 0.9,
    friction 0.3), res 32, gravity -10 along y, frames of 10 substeps.
    Ids tagged."""
    rng = np.random.default_rng(42)
    sim = solver(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=2e-3, gravity=(0.0, -10.0, 0.0),
                 **solver_kw)
    sim.add_collider(ls.box_domain(lo=(0.1, 0.1, 0.1), hi=(0.9, 0.9, 0.9), friction=0.3))
    x0 = rng.uniform(0.15, 0.85, size=(n, 3)).astype(np.float32)
    sim.add_particles("jelly", pos=x0, vel=(1.0, 0.0, 0.0), density=1000.0, E=1e4, nu=0.3)
    return tag_pending(sim)


def pencil_drift(solver=MPM, ls=levelset, **solver_kw):
    """tests/test_spatial_mesh2d.py:22-31's scene and the box of its
    frames (:88-91): 700 jelly particles uniform in [0.08, 0.92]^3 moving
    at (1.5, 1.0, 0), so that they cross both pencil axes, in a box (0.1
    to 0.9, friction 0.3), res 32, gravity -10 along y, frames of 8
    substeps. Ids tagged."""
    rng = np.random.default_rng(1)
    sim = solver(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=16e-4, gravity=(0.0, -10.0, 0.0),
                 **solver_kw)
    sim.add_collider(ls.box_domain(lo=(0.1, 0.1, 0.1), hi=(0.9, 0.9, 0.9), friction=0.3))
    x0 = rng.uniform(0.08, 0.92, size=(700, 3)).astype(np.float32)
    sim.add_particles("jelly", pos=x0, vel=(1.5, 1.0, 0.0), density=1000.0, E=1e4, nu=0.3)
    return tag_pending(sim)


def corner_cluster(solver=MPM, ls=levelset, **solver_kw):
    """tests/test_spatial_mesh2d.py:143-174's scene: 800 jelly particles in
    the low-x, low-y corner ([0.03, 0.20]^2 x [0.3, 0.7]) moving at (3, 2,
    0), res (64, 64, 32), gravity -10 along z, in a box (0.02 to 0.98 in x
    and y, 0.05 to 0.95 in z, friction 0.3), frames of 6 substeps. On a
    (2, 2) mesh the balanced bounds of both axes move toward the corner.
    Ids tagged."""
    rng = np.random.default_rng(11)
    sim = solver(res=(64, 64, 32), base_delta_t=2e-4, frame_dt=12e-4, gravity=(0.0, 0.0, -10.0),
                 **solver_kw)
    sim.add_collider(ls.box_domain(lo=(0.02, 0.02, 0.05), hi=(0.98, 0.98, 0.95), friction=0.3))
    n = 800
    x0 = np.empty((n, 3), np.float32)
    x0[:, 0] = rng.uniform(0.03, 0.20, n)
    x0[:, 1] = rng.uniform(0.03, 0.20, n)
    x0[:, 2] = rng.uniform(0.3, 0.7, n)
    sim.add_particles("jelly", pos=x0, vel=(3.0, 2.0, 0.0), density=1000.0, E=1e4, nu=0.3)
    return tag_pending(sim)


def corner_crossing(solver=MPM, ls=levelset, speed: float = 8.0, **solver_kw):
    """Two jelly blobs (600 particles each, radius 0.06) by the middle of
    a res-32 box, at z 0.35 and 0.65 so that they pass each other: one
    centred at (0.47, 0.47) moving at (speed, speed, 0), one at (0.47,
    0.53) moving at (speed, -speed, 0). On a (2, 2) mesh of uniform
    pencils they cross both axes at once, so a re-sort moves particles
    to the diagonal pencil, through the pencil beside it (drift 0.45
    cell after 9 substeps at 8 m/s). A box (0.1 to 0.9, friction 0.3),
    gravity -10 along y, frames of 12 substeps. Ids tagged."""
    rng = np.random.default_rng(9)

    def blob(center):
        d = rng.normal(size=(600, 3))
        r = 0.06 * rng.uniform(0.0, 1.0, 600) ** (1.0 / 3.0)
        return (np.asarray(center) + d / np.linalg.norm(d, axis=1, keepdims=True)
                * r[:, None]).astype(np.float32)

    sim = solver(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=2.4e-3,
                 gravity=(0.0, -10.0, 0.0), **solver_kw)
    sim.add_collider(ls.box_domain(lo=(0.1, 0.1, 0.1), hi=(0.9, 0.9, 0.9), friction=0.3))
    sim.add_particles("jelly", pos=blob((0.47, 0.47, 0.35)), vel=(speed, speed, 0.0),
                      density=1000.0, E=1e4, nu=0.3)
    sim.add_particles("jelly", pos=blob((0.47, 0.53, 0.65)), vel=(speed, -speed, 0.0),
                      density=1000.0, E=1e4, nu=0.3)
    return tag_pending(sim)


def diagonal_pair(solver=MPM, **solver_kw):
    """Two jelly blobs (200 particles each, in cubes of side 0.04) at
    (0.45, 0.45, 0.5) and (0.55, 0.55, 0.5) closing on each other at
    (1, 1, 0) and (-1, -1, 0), res 32, no gravity, frames of 6
    substeps: on a (2, 2) mesh of uniform pencils the nodes at the
    corner (16, 16) take mass from pencils (0, 0) and (1, 1), while
    pencils (0, 1) and (1, 0) hold no particle. Ids tagged."""
    rng = np.random.default_rng(2)
    sim = solver(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=1.2e-3, gravity=(0.0, 0.0, 0.0),
                 **solver_kw)
    for center, vel in (((0.45, 0.45, 0.5), (1.0, 1.0, 0.0)),
                        ((0.55, 0.55, 0.5), (-1.0, -1.0, 0.0))):
        pos = (np.asarray(center) + rng.uniform(-0.02, 0.02, (200, 3))).astype(np.float32)
        sim.add_particles("jelly", pos=pos, vel=vel, density=1000.0, E=1e4, nu=0.3)
    return tag_pending(sim)
