"""Shared inputs of the port's CPU tests: scenes built once in numpy and
handed to both packages (the JAX reference and the torch port)."""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from taichi_mpm_torch import convert, scenes
from taichi_mpm_torch.core.state import FIELDS
from taichi_mpm_torch.materials import models as tmodels


def scene_arrays(n=1200, seed=0, mats=("jelly",), lo=0.375, hi=0.5,
                 v_scale=0.5, cap_extra=17):
    """Numpy particle fields of a random box of particles (capacity
    n + cap_extra, the extra slots inactive) and its material ids."""
    rng = np.random.default_rng(seed)
    cap = n + cap_extra
    a = {
        "x": np.zeros((cap, 3), np.float32),
        "v": np.zeros((cap, 3), np.float32),
        "F": np.broadcast_to(np.eye(3, dtype=np.float32), (cap, 3, 3)).copy(),
        "C": np.zeros((cap, 3, 3), np.float32),
        "aux": np.zeros(cap, np.float32),
        "mass": np.zeros(cap, np.float32),
        "vol": np.zeros(cap, np.float32),
        "mat": np.zeros(cap, np.int32),
        "params": np.zeros((cap, 8), np.float32),
        "active": np.zeros(cap, bool),
        "states": np.zeros(cap, np.int32),
        "bdist": np.zeros(cap, np.float32),
        "bnormal": np.zeros((cap, 3), np.float32),
        "near_b": np.zeros(cap, bool),
    }
    a["x"][:n] = rng.uniform(lo, hi, (n, 3))
    a["v"][:n] = v_scale * rng.standard_normal((n, 3))
    mids = []
    for i, m in enumerate(mats):
        mid, params, aux0 = tmodels.pack_params(m)
        mids.append(mid)
        sel = np.arange(n) % len(mats) == i
        a["mat"][:n][sel] = mid
        a["params"][:n][sel] = params
        a["aux"][:n][sel] = aux0
    a["mass"][:n] = 1e-3
    a["vol"][:n] = 1e-6
    a["active"][:n] = True
    return a, tuple(sorted(set(mids)))


def jax_particles(arrays):
    import jax.numpy as jnp

    from taichi_mpm_tpu.core.state import Particles as JParticles

    return JParticles(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


def configs(mats, res=(32, 32, 32), base_dt=2e-4, gravity_zero=False, **kw):
    """(JAX SimConfig, port SimConfig) with the same fields."""
    from taichi_mpm_tpu.config import SimConfig as JConfig

    jcfg = JConfig(res=res, base_dt=base_dt,
                   gravity=(0.0, 0.0, 0.0) if gravity_zero else (0.0, -10.0, 0.0),
                   active_materials=tuple(mats), **kw)
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def np_of(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def max_err(a, b):
    return float(np.max(np.abs(np_of(a).astype(np.float64) - np_of(b).astype(np.float64))))


# -- CPIC scenes: built by the JAX package's MPM, handed to the port in numpy --

WHEEL_CENTER = (0.5, 0.4, 0.5)


def jax_plate_scene(vel=(0.0, -0.5, 0.0), seed=3, n=220):
    """tests/test_cpic_packed.py's plate scene: jelly over a scripted
    plate, res 16."""
    from taichi_mpm_tpu.core.solver import MPM as JMPM
    from taichi_mpm_tpu.rigid.mesh import plate_mesh

    rng = np.random.default_rng(seed)
    sim = JMPM(res=(16, 16, 16), base_delta_t=2e-4, gravity=(0, -10.0, 0), penalty=1e3)
    pos = rng.uniform(0.3, 0.7, size=(n, 3)).astype(np.float32)
    sim.add_particles("jelly", pos=pos, vel=vel, E=1e4, nu=0.3, density=1000)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.25, half_v=0.25, axis=1),
                      scripted_position=lambda t: (0.5, 0.45, 0.5),
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0),
                      codimensional=True, friction=0.2)
    sim._finalize()
    return sim


def jax_wheel_scene():
    """tests/test_cpic_packed.py's wheel scene: water falling beside the
    axis of a free 4-paddle wheel, res 16."""
    from taichi_mpm_tpu.core.solver import MPM as JMPM
    from taichi_mpm_tpu.rigid.mesh import paddle_wheel_mesh

    rng = np.random.default_rng(11)
    sim = JMPM(res=(16, 16, 16), base_delta_t=2e-4, gravity=(0, -10.0, 0), penalty=1e3)
    pos = np.empty((200, 3), np.float32)
    pos[:, 0] = rng.uniform(0.55, 0.65, 200)
    pos[:, 1] = rng.uniform(0.6, 0.8, 200)
    pos[:, 2] = rng.uniform(0.45, 0.55, 200)
    sim.add_particles("water", pos=pos, vel=(0, -1.0, 0), density=1000)
    sim.add_particles("rigid", mesh=paddle_wheel_mesh(n_paddles=4, outer=0.18),
                      initial_position=(0.5, 0.4, 0.5), rotation_axis=(0, 0, 1),
                      codimensional=True, friction=0.1, density=40.0)
    sim._finalize()
    return sim


def hub_wheel_kw():
    return dict(density=1.0, friction=0.2, codimensional=True, angular_damping=3.0,
                scripted_position=lambda t: WHEEL_CENTER, rotation_axis=(0, 0, 1))


def jax_hub_wheel_scene(n=240, seed=5):
    """The CPIC benchmark's bodies (hub + 6-paddle wheel, rotation
    articulation, a rigid-rigid collision pair) at res 16, with water
    falling onto the right-hand paddles."""
    from taichi_mpm_tpu.core.solver import MPM as JMPM
    from taichi_mpm_tpu.rigid.mesh import cylinder_mesh, paddle_wheel_mesh

    rng = np.random.default_rng(seed)
    sim = JMPM(res=(16, 16, 16), base_delta_t=2e-4, gravity=(0, -10.0, 0), penalty=1e3)
    pos = (rng.uniform(0.0, 1.0, (n, 3)) * [0.2, 0.3, 0.2] + [0.5, 0.35, 0.4]).astype(np.float32)
    sim.add_particles("water", pos=pos, vel=(0, -1.0, 0), density=1000)
    hub = sim.add_particles("rigid", mesh=cylinder_mesh(radius=0.04, half_height=0.06, n=16,
                                                        axis=2), **hub_wheel_kw())
    wheel = sim.add_particles("rigid", mesh=paddle_wheel_mesh(), **hub_wheel_kw())
    sim.add_articulation("rotation", hub, wheel)
    sim._finalize()
    return sim


def port_inputs(sim):
    """(particles, bodies, scene, config) of the port from a finalized JAX
    solver's state."""
    tcfg = convert.config_from_dict(dataclasses.asdict(sim.cfg))
    tp = convert.particles_from_numpy(convert.particles_to_numpy(sim.particles))
    return (tp, convert.bodies_from_jax(sim.bodies), convert.scene_from_jax(sim.rigid_scene),
            tcfg)


CPIC_BOUNDS = dict(x=5e-6, v=5e-4, F=5e-5)  # tests/test_cpic_packed.py
BODY_BOUNDS = dict(vel=1e-5, omega=1e-5, pos=1e-6)


def assert_cpic_close(jp, jb, tp, tb):
    """The port's CPIC frame result against JAX's at the bounds of
    tests/test_cpic_packed.py."""
    ja = np.asarray(jp.active)
    ta = np_of(tp.active)
    assert np.array_equal(ja, ta)
    for name, bound in CPIC_BOUNDS.items():
        err = max_err(np.asarray(getattr(jp, name))[ja], np_of(getattr(tp, name))[ta])
        assert err <= bound, (name, err)
    for name in ("states", "near_b"):
        assert np.array_equal(np.asarray(getattr(jp, name))[ja], np_of(getattr(tp, name))[ta]), name
    for name, bound in BODY_BOUNDS.items():
        err = max_err(getattr(jb, name), getattr(tb, name))
        assert err <= bound, (name, err)


# the dense CDF gather (tests/port/test_torch_cdf_2d.py): the boundary
# distance is a float32 least-squares solve by Cramer's rule, which XLA
# jitted rounds otherwise than op by op (the port rounds as the latter):
# 1.9e-6 dx on the 3-D oracle plate, a solve near a singular, planar
# stencil; the unit normal 3.8e-6 there
GATHER_BDIST_DX, GATHER_BNORMAL = 5e-6, 1e-5


def assert_gather_close(jout, tout, dx):
    """Two CDF gathers' (states, bdist, bnormal, near_b): the integers
    equal, the distance and the normal within the bounds above."""
    js, jd, jn, jnear = (np_of(a) for a in jout)
    ts, td, tn, tnear = (np_of(a) for a in tout)
    assert np.array_equal(js, ts) and np.array_equal(jnear, tnear)
    assert max_err(jd, td) <= GATHER_BDIST_DX * dx
    assert max_err(jn, tn) <= GATHER_BNORMAL


# -- frames of plain materials ------------------------------------------------

FRAME_BOUNDS = dict(x=5e-6, v=5e-5, F=5e-6, C=5e-4, aux=5e-6)  # tests/test_fused.py


def assert_frame_close(jp, tp, bounds=FRAME_BOUNDS):
    """Two frames' particles (either package's) alive on the same lanes
    and within `bounds` there."""
    ja, ta = np_of(jp.active), np_of(tp.active)
    assert np.array_equal(ja, ta)
    for name, bound in bounds.items():
        err = max_err(np_of(getattr(jp, name))[ja], np_of(getattr(tp, name))[ta])
        assert err <= bound, (name, err)


def fast_arrays(n=1200, seed=7, mats=("jelly",), drift=(12.0, -3.0, 0.0), v_scale=0.5):
    """scene_arrays whose particles also move together at `drift` (m/s),
    so the frame re-sorts (the grid transfer averages the random part of
    v away within a substep, a common velocity stays)."""
    a, mids = scene_arrays(n, seed=seed, mats=mats, v_scale=v_scale)
    a["v"][:n] += np.float32(drift)
    return a, mids


# -- particles matched by identity ----------------------------------------------

ID_SLOT = 7  # a params slot no material reads: tests tag each particle's index there


def tag_ids(arrays):
    """The numpy particle arrays with each slot's index in params[:, ID_SLOT]."""
    a = dict(arrays)
    a["params"] = np.array(a["params"], np.float32)
    a["params"][:, ID_SLOT] = np.arange(a["params"].shape[0], dtype=np.float32)
    return a


def by_id(p):
    """The active particles of `p` (either package's) as numpy arrays,
    ordered by their id tag: a resumed run sorts afresh, so its lanes
    come in another order than the run it was cut from."""
    a = convert.particles_to_numpy(p)
    act = a["active"]
    order = np.argsort(a["params"][act, ID_SLOT], kind="stable")
    return {k: v[act][order] for k, v in a.items()}


def assert_close_by_id(p, q, bounds=FRAME_BOUNDS, equal=()):
    """Two particle sets with the same tagged particles alive, within
    `bounds`, the fields `equal` exactly."""
    a, b = by_id(p), by_id(q)
    assert np.array_equal(a["params"][:, ID_SLOT], b["params"][:, ID_SLOT])
    for name, bound in bounds.items():
        err = max_err(a[name], b[name])
        assert err <= bound, (name, err)
    for name in equal:
        assert np.array_equal(a[name], b[name]), name


# -- per-block bucketed async: tests/test_async_bucketed.py's blobs --------------

# (lo, hi, n, E) of the elastic blobs of tests/test_async_bucketed.py
SOFT = ((0.15, 0.3, 0.3), (0.45, 0.7, 0.7), 1600, 4e3)
STIFF = ((0.65, 0.4, 0.4), (0.85, 0.6, 0.6), 400, 4e5)


def blob_arrays(blobs, seed=0, cap_extra=1, v=None):
    """tests/test_async_bucketed.py's ``_make`` in numpy: elastic blobs
    (nu 0.3, mass 1e-3, vol 1e-6) in a res-32 box without gravity, v ~
    0.1 N(0, 1) (or `v`), and `cap_extra` inactive lanes after them.
    Returns (arrays, (JAX config, port config))."""
    rng = np.random.default_rng(seed)
    xs, ps = [], []
    mid = None
    for lo, hi, n, E in blobs:
        mid, par, _ = tmodels.pack_params("elastic", E=E, nu=0.3)
        xs.append(rng.uniform(lo, hi, (n, 3)).astype(np.float32))
        ps.append(np.broadcast_to(np.asarray(par, np.float32), (n, 8)))
    n = sum(b[2] for b in blobs)
    a, _ = scene_arrays(n, cap_extra=cap_extra, mats=("elastic",))
    a["x"][:n] = np.concatenate(xs)
    a["params"][:n] = np.concatenate(ps)
    a["v"][:n] = (0.1 * np.random.default_rng(seed + 1).standard_normal((n, 3)).astype(np.float32)
                  if v is None else np.float32(v))
    a["aux"][:] = 0.0
    return a, configs((mid,), base_dt=1e-3, gravity_zero=True)


# -- the dense path: scenes of any dimension, and the compiled-reference goldens --


def dense_arrays(n=300, dim=3, seed=0, mats=("jelly",), lo=0.3, hi=0.6, v_scale=0.5,
                 cap_extra=5):
    """Numpy particle fields of `n` random particles in [lo, hi]^dim (the
    materials dealt in turn at their defaults, F = I, mass 1e-3, vol 1e-6;
    `cap_extra` inactive slots after them) and the material ids."""
    rng = np.random.default_rng(seed)
    cap = n + cap_extra
    d = dim
    a = {
        "x": np.zeros((cap, d), np.float32),
        "v": np.zeros((cap, d), np.float32),
        "F": np.broadcast_to(np.eye(d, dtype=np.float32), (cap, d, d)).copy(),
        "C": np.zeros((cap, d, d), np.float32),
        "aux": np.zeros(cap, np.float32),
        "mass": np.zeros(cap, np.float32),
        "vol": np.zeros(cap, np.float32),
        "mat": np.zeros(cap, np.int32),
        "params": np.zeros((cap, 8), np.float32),
        "active": np.zeros(cap, bool),
        "states": np.zeros(cap, np.int32),
        "bdist": np.zeros(cap, np.float32),
        "bnormal": np.zeros((cap, d), np.float32),
        "near_b": np.zeros(cap, bool),
    }
    a["x"][:n] = rng.uniform(lo, hi, (n, d))
    a["v"][:n] = v_scale * rng.standard_normal((n, d))
    mids = []
    for i, m in enumerate(mats):
        mid, params, aux0 = tmodels.pack_params(m)
        mids.append(mid)
        sel = np.arange(n) % len(mats) == i
        a["mat"][:n][sel] = mid
        a["params"][:n][sel] = params
        a["aux"][:n][sel] = aux0
    a["mass"][:n] = 1e-3
    a["vol"][:n] = 1e-6
    a["active"][:n] = True
    return a, tuple(sorted(set(mids)))


def dense_configs(mids, dim=3, res=16, **kw):
    """(JAX SimConfig, port SimConfig) of a res^dim scene with the same
    fields (gravity -10 along y)."""
    from taichi_mpm_tpu.config import SimConfig as JConfig

    jcfg = JConfig(res=(res,) * dim, base_dt=1e-4, gravity=(0.0, -10.0, 0.0)[:dim],
                   active_materials=tuple(mids), **kw)
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _jax_substep(jcfg, jcol, jit):
    """The JAX package's dense substep of (config, colliders), jitted once
    per pair (a test that steps the same scene frame after frame compiles
    it once)."""
    import jax

    from taichi_mpm_tpu.core.solver import substep

    def step(p, tt):
        return substep(p, tt, jcfg, jcol, jcfg.base_dt)

    return jax.jit(step) if jit else step


def jax_substeps(jp, jcfg, jcol, n, t=0.0, jit=True):
    """n of the JAX package's dense substeps of base_dt
    (``core.solver.substep``, the body of its ``frame_fn``): jitted once
    and called n times, or with jit=False run op by op (quicker where
    the substep's compile would take longer than its ops)."""
    import jax.numpy as jnp

    step = _jax_substep(jcfg, jcol, jit)
    t = jnp.float32(t)
    for _ in range(n):
        jp, t = step(jp, t)
    return jp, t


def load_golden(path):
    """Frames of a compiled-reference golden file (``FRAME k n`` then n
    rows each), by frame number (the loader of tests/test_mpm88_oracle.py
    and tests/test_tetris_golden.py)."""
    txt = open(path).read().splitlines()
    frames = {}
    i = 0
    while i < len(txt):
        tok = txt[i].split()
        assert tok[0] == "FRAME"
        k, n = int(tok[1]), int(tok[2])
        frames[k] = np.array([[float(v) for v in line.split()] for line in txt[i + 1:i + 1 + n]],
                             np.float32)
        i += 1 + n
    return frames


# the numpy MLS-MPM oracle of tests/test_mpm88_oracle.py, copied
MPM88_N = 80
MPM88_DX = 1.0 / MPM88_N
MPM88_DT = 1e-4
MPM88_GRAVITY = -200.0
_E, _NU, _HARDENING = 1e4, 0.2, 10.0
_MU0 = _E / (2 * (1 + _NU))
_LAM0 = _E * _NU / ((1 + _NU) * (1 - 2 * _NU))
_THETA_C, _THETA_S = 2.5e-2, 7.5e-3


def numpy_mpm88_substep(x, v, F, B, Jp, nodes):
    """One mls-mpm88 substep, straight from the MLS-MPM equations, looped
    in numpy (sticky walls, a separating floor)."""
    inv_dx, dt, wall = float(MPM88_N), MPM88_DT, scenes.MPM88_WALL
    n = x.shape[0]
    grid = np.zeros(nodes + (3,), np.float32)
    for p in range(n):
        pos = x[p] * inv_dx
        base = np.floor(pos - 0.5).astype(np.int32)
        fx = pos - base
        w = np.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1) ** 2, 0.5 * (fx - 0.5) ** 2]
                     ).astype(np.float32)
        e = np.float32(np.exp(_HARDENING * (1.0 - Jp[p])))
        mu, lam = _MU0 * e, _LAM0 * e
        J = np.linalg.det(F[p])
        u, s, vt = np.linalg.svd(F[p])
        R = (u @ vt).astype(np.float32)
        pft = 2 * mu * (F[p] - R) @ F[p].T + lam * (J - 1) * J * np.eye(2, dtype=np.float32)
        affine = 4.0 * B[p] - 4.0 * inv_dx * dt * (-pft)
        for i in range(3):
            for j in range(3):
                node = base + np.array([i, j])
                dpos = (pos - node).astype(np.float32)
                weight = w[i, 0] * w[j, 1]
                grid[node[0], node[1], :2] += weight * (v[p] + affine @ dpos)
                grid[node[0], node[1], 2] += weight
    gx = np.arange(nodes[0], dtype=np.float32) * MPM88_DX
    gy = np.arange(nodes[1], dtype=np.float32) * MPM88_DX
    for i in range(nodes[0]):
        for j in range(nodes[1]):
            m = grid[i, j, 2]
            if m > 0:
                grid[i, j, :2] /= m
                grid[i, j, 1] += dt * MPM88_GRAVITY
                if gx[i] <= wall or gx[i] >= 1 - wall or gy[j] >= 1 - wall:
                    grid[i, j, :2] = 0.0
                if gy[j] <= wall:
                    grid[i, j, 1] = max(0.0, grid[i, j, 1])
    for p in range(n):
        pos = x[p] * inv_dx
        base = np.floor(pos - 0.5).astype(np.int32)
        fx = pos - base
        w = np.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1) ** 2, 0.5 * (fx - 0.5) ** 2]
                     ).astype(np.float32)
        new_v = np.zeros(2, np.float32)
        new_B = np.zeros((2, 2), np.float32)
        for i in range(3):
            for j in range(3):
                node = base + np.array([i, j])
                dpos = (pos - node).astype(np.float32)
                weight = np.float32(w[i, 0] * w[j, 1])
                gv = grid[node[0], node[1], :2]
                new_v += weight * gv
                new_B += np.outer(weight * gv, dpos)
        v[p] = new_v
        B[p] = new_B
        cdg = np.eye(2, dtype=np.float32) - 4.0 * dt * inv_dx * new_B
        Fn = (cdg @ F[p]).astype(np.float32)
        u, s, vt = np.linalg.svd(Fn)
        s_c = np.clip(s, 1 - _THETA_C, 1 + _THETA_S)
        F[p] = (u @ np.diag(s_c) @ vt).astype(np.float32)
        Jp[p] = np.clip(Jp[p] * s.prod() / s_c.prod(), 0.6, 20.0)
        x[p] = x[p] + dt * v[p]
    return x, v, F, B, Jp


# -- measurements behind the dense path's bounds, run as a script -------------


def dense_noise():
    """The one-ulp noise of chip_smoke.py's dense_check frames on the CPU,
    per material: each frame (``chip_smoke.dense_all8`` at orders 1-3, 6
    substeps) against the same frame from ``chip_smoke.nudged`` (every F
    of the input moved by one ulp up or down, directions from seeds
    0-2). ``dense_check`` prints the sand lanes' noise of seed 0 on the
    card and on the CPU in each run."""
    import chip_smoke

    for order in (1, 2, 3):
        base = chip_smoke.dense_all8("cpu", order)
        base.step()
        mat = base.particles.mat.numpy()
        noise = {}
        for seed in range(3):
            moved = chip_smoke.nudged(chip_smoke.dense_all8("cpu", order), seed)
            moved.step()
            for m, name in enumerate(chip_smoke.ALL8):
                for f, e in chip_smoke.lane_errors(base, moved, mat == m).items():
                    noise[name, f] = max(noise.get((name, f), 0.0), e)
        print(f"dense all8 order {order}, frame - frame(F +-1 ulp, seeds 0-2): "
              + ", ".join(f"{m} {f} {v:.2e}" for (m, f), v in noise.items() if v))


def jax_dense_vs_blocked(make, jcol=(), frames=1):
    """The JAX package's own two paths on the CPU, on the port's scene
    `make()` (finalized, particles tagged by id) with `jcol` its colliders
    in the JAX package: its dense substeps against
    ``packed_frame(fused=True)`` (the Pallas kernels in interpret mode),
    `frames` frames of the scene's substeps, particles matched by id;
    the differences chip_smoke.py's dense_vs_blocked phase is set beside.
    The dense substeps run op by op: jitted on the CPU, XLA fuses
    x * inv_dx - 0.5 into one rounding for the stencil's floor but not
    for its weights, so a particle at an exact half-cell gets the weights
    of the stencil one node over (oscillating_jello at res 50 has one at
    its first frame). Returns the largest difference of each field."""
    import jax.numpy as jnp

    from taichi_mpm_tpu.config import SimConfig as JConfig
    from taichi_mpm_tpu.core import solver as jsolver
    from taichi_mpm_tpu.ops import packed as jpacked

    sim = make()
    sim._ensure_finalized()
    cap = sim._active_block_cap()
    p = jax_particles(tag_ids(convert.particles_to_numpy(sim.particles)))
    cfg = JConfig(**{f.name: getattr(sim.cfg, f.name) for f in dataclasses.fields(JConfig)})
    n = round(sim.frame_dt / cfg.base_dt)
    dense, blocked, t = p, p, jnp.float32(0)
    for _ in range(frames):
        blocked, *_ = jpacked.packed_frame(blocked, t, cfg, jcol, cfg.base_dt, n, cap,
                                           interpret=True, fused=True)
        for _ in range(n):
            dense, t = jsolver.substep(dense, t, cfg, jcol, cfg.base_dt)
    a, b = by_id(dense), by_id(blocked)
    return {f: max_err(a[f], b[f]) for f in ("x", "v", "F", "C", "aux")}


def jax_dense_vs_blocked_report():
    """jax_dense_vs_blocked on chip_smoke.py's dense_vs_blocked scenes."""
    import chip_smoke
    from taichi_mpm_tpu.core import levelset as jls
    from taichi_mpm_torch import scenes

    def jello():
        sim = scenes.oscillating_jello(res=50, device="cpu")
        sim.optimized = True
        return sim

    box = (jls.box_domain((0.32,) * 3, (0.7,) * 3, friction=-1.0),)
    cases = {"cube25": (lambda: chip_smoke.cube(25, "cpu", 3), ()),
             "all8_order2": (lambda: chip_smoke.dense_all8("cpu", 2, optimized=True), box),
             "jello50": (jello, ())}
    for label, (make, jcol) in cases.items():
        errs = jax_dense_vs_blocked(make, jcol)
        print(f"JAX {label}, one frame, dense - blocked: "
              + ", ".join(f"{f} {e:.3e}" for f, e in errs.items()), flush=True)


def _jax_check_wheel():
    """chip_smoke.py's cpic_check scene (``chip_smoke.cpic_check_scene``:
    the 10k water wheel, res 96) built by the JAX package's MPM from the
    port's seeding, with id tags. Returns (JAX solver, tagged arrays)."""
    import chip_smoke
    from taichi_mpm_tpu.core.solver import MPM as JMPM
    from taichi_mpm_tpu.rigid import mesh as jmesh

    port = chip_smoke.cpic_check_scene("cpu")
    port._ensure_finalized()
    a = tag_ids(convert.particles_to_numpy(port.particles))
    sim = JMPM(res=port.cfg.res, base_delta_t=port.cfg.base_dt, gravity=port.cfg.gravity,
               penalty=port.cfg.penalty)
    sim.add_particles("water", pos=a["x"], vel=a["v"][0], density=1000.0)
    body = dict(density=1.0, friction=0.2, codimensional=True, angular_damping=3.0,
                scripted_position=lambda t: scenes.WHEEL_CENTER, rotation_axis=(0, 0, 1))
    hub = sim.add_particles("rigid", mesh=jmesh.cylinder_mesh(radius=0.04, half_height=0.06,
                                                              n=16, axis=2), **body)
    wheel = sim.add_particles("rigid", mesh=jmesh.paddle_wheel_mesh(), **body)
    sim.add_articulation("rotation", hub, wheel)
    sim._finalize()
    return sim, a


def _pair_errors(pa, ba, pb, bb):
    x, y = by_id(pa), by_id(pb)
    errs = {f: max_err(x[f], y[f]) for f in ("x", "v", "F")}
    errs["states_differ"] = int((x["states"] != y["states"]).sum())
    errs.update({f"body_{f}": max_err(getattr(ba, f), getattr(bb, f)) for f in ("omega", "vel")})
    return errs


def _jax_packed_wheel_frame(sim, p0, substeps):
    import jax.numpy as jnp

    from taichi_mpm_tpu.rigid.cpic_packed import cpic_packed_frame

    cfg = sim.cfg
    sim.particles = p0
    near, b1, Kr = sim._near_budget_cap()
    return cpic_packed_frame(p0, sim.bodies, jnp.float32(0.0), cfg, sim.rigid_scene,
                             cfg.base_dt, substeps, sim._active_block_cap(), near, b1, Kr,
                             interpret=True, two_d=True)


def jax_cpic_dense_vs_blocked(substeps=4):
    """The JAX package's own two CPIC paths on the CPU, on chip_smoke.py's
    dense_cpic_vs_fused scene (``_jax_check_wheel``): its oracle
    ``cpic_substep`` (jitted, dt the scene's base_dt, the body of its MPM's
    dense CPIC frame) against its packed CPIC frame ``cpic_packed_frame``
    (the Pallas kernels in interpret mode, the MPM's own capacities),
    `substeps` substeps, particles matched by id. Returns the largest
    difference of x, v, F, states (count of differing lanes) and the
    bodies' omega and vel."""
    import jax
    import jax.numpy as jnp

    from taichi_mpm_tpu.rigid.cpic import cpic_substep

    sim, a = _jax_check_wheel()
    p0 = jax_particles(a)
    cfg, scene, dt = sim.cfg, sim.rigid_scene, sim.cfg.base_dt
    step = jax.jit(lambda p, b, t: cpic_substep(p, b, t, cfg, scene, dt))
    po, bo, t = p0, sim.bodies, jnp.float32(0.0)
    for _ in range(substeps):
        po, bo, t = step(po, bo, t)
    out = _jax_packed_wheel_frame(sim, p0, substeps)
    return _pair_errors(po, bo, out[0], out[1])


def jax_cpic_unfused_vs_fused(substeps=6):
    """The JAX package's pytree CPIC frame (``cpic_blocked_frame``, its
    TMT_FUSED=0 route) against its packed one (``cpic_packed_frame``) on
    the CPU, on chip_smoke.py's cpic_unfused_check scene
    (``_jax_check_wheel``), `substeps` substeps at the MPM's own
    capacities, the Pallas kernels in interpret mode, particles matched
    by id: the errors of ``jax_cpic_dense_vs_blocked``."""
    import jax.numpy as jnp

    from taichi_mpm_tpu.rigid.cpic_blocked import cpic_blocked_frame

    sim, a = _jax_check_wheel()
    p0 = jax_particles(a)
    cfg = sim.cfg
    sim.particles = p0
    near, b1, Kr = sim._near_budget_cap()
    pytree = cpic_blocked_frame(p0, sim.bodies, jnp.float32(0.0), cfg, sim.rigid_scene,
                                cfg.base_dt, substeps, sim._active_block_cap(), near, b1, Kr,
                                interpret=True)
    out = _jax_packed_wheel_frame(sim, p0, substeps)
    return _pair_errors(pytree[0], pytree[1], out[0], out[1])


def cos_sin_against_xla(n=200_000, seed=0):
    """How often float32 cos and sin differ from XLA's on the CPU, on n
    angles uniform in [-10, 10] from default_rng(seed): torch's float32
    ones, and ``math.quat.cos_sin`` (float64 rounded); with the largest
    difference in ulps."""
    import jax.numpy as jnp

    from taichi_mpm_torch.math.quat import cos_sin

    a = np.random.default_rng(seed).uniform(-10, 10, n).astype(np.float32)
    t = torch.as_tensor(a)
    ref = (np.asarray(jnp.cos(a)), np.asarray(jnp.sin(a)))
    for label, got in (("torch float32", (torch.cos(t), torch.sin(t))),
                       ("float64 rounded", cos_sin(t))):
        for name, g, r in zip(("cos", "sin"), got, ref):
            g = g.numpy()
            ulps = np.abs(g.astype(np.float64) - r) / np.spacing(np.abs(r))
            print(f"{label} {name}: {np.mean(g != r):.4f} of the angles differ, "
                  f"at most {ulps.max():.0f} ulp", flush=True)


def hub_wheel_witness(substeps=2):
    """The hub and wheel of the CPIC benchmark (``jax_hub_wheel_scene``, a
    colliding pair with a degenerate contact) after `substeps` of the JAX
    package's dense CPIC substep: both packages' rigid-rigid detect and
    rigidify from that state. The contact's effective inverse mass is 0,
    so an impulse of ~1e28 meets the witness point's arm: XLA's sum of the
    witness vertices rounds the point off the bodies' axis by one ulp,
    the port's on it. Prints both witness points and the angular
    velocities after rigidify and after the rotation articulation."""
    import jax
    import jax.numpy as jnp

    from taichi_mpm_tpu.rigid import articulation as jart
    from taichi_mpm_tpu.rigid import collision as jcoll
    from taichi_mpm_tpu.rigid.cpic import cpic_substep
    from taichi_mpm_torch.rigid import collision as tcoll
    from taichi_mpm_torch.rigid.cpic_blocked import _solve_bodies

    sim = jax_hub_wheel_scene()
    cfg, sc, dt = sim.cfg, sim.rigid_scene, sim.cfg.base_dt
    step = jax.jit(lambda p, b, t: cpic_substep(p, b, t, cfg, sc, dt))
    p, b, t = sim.particles, sim.bodies, jnp.float32(0.0)
    for _ in range(substeps):
        p, b, t = step(p, b, t)
    dirs = jcoll.icosphere_directions()
    ts = convert.scene_from_jax(sc)
    tb = convert.bodies_from_jax(b)
    jr = jcoll.rigidify(b, sc.hull_verts, sc.collision, jnp.asarray(dirs), dt)
    print("witness point: JAX", np.asarray(jcoll.detect(b, sc.hull_verts, sc.collision.pairs,
                                                          jnp.asarray(dirs))[3])[0],
          "port", tcoll.detect(tb, ts.hull_verts_host(), ts.collision.pairs, dirs)[3][0])
    print("omega after rigidify: JAX", np.asarray(jr.omega)[1:].tolist(), "port",
          tcoll.rigidify(tb, ts.hull_verts_host(), ts.collision, dirs, dt).omega.numpy()[1:].tolist())
    print("omega after the prologue: JAX",
          np.asarray(jart.articulate(jr, sc.articulations, dt).omega)[1:].tolist(), "port",
          _solve_bodies(tb, ts, dt).omega.numpy()[1:].tolist(), flush=True)


def dense_cpic_profile():
    """On the card: ``scenes.cpic_wheel()`` (100k water, res 96) with
    optimized=False, a 1-substep warm-up frame and a timed 2-substep
    frame, then one substep under ``torch.profiler``: the ms per substep
    and the operators by device time and by host time."""
    import time

    from torch.profiler import ProfilerActivity, profile

    sim = scenes.cpic_wheel(device="cuda", optimized=False)
    sim.step(frame_dt=sim.cfg.base_dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(frame_dt=2 * sim.cfg.base_dt)
    torch.cuda.synchronize()
    print("ms/substep", (time.perf_counter() - t0) * 500, flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.step(frame_dt=sim.cfg.base_dt)
        torch.cuda.synchronize()
    table = prof.key_averages()
    print(table.table(sort_by="cuda_time_total", row_limit=30, max_name_column_width=60))
    print(table.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=60))


# the 2-D CPIC scripts' coupled snapshots: script -> (path, frames of 1e-3 s)
WHEEL_2D_SNAPSHOTS = {
    "sand_wheel_2d": ("tests/fixtures/sand_wheel_2d_coupled.npz", 190),
    "async_wheel": ("tests/fixtures/async_wheel_coupled.npz", 150),
}


def wheel_2d_snapshot(name, frame_dt=1e-3):
    """``scripts/mls-cpic/sand_wheel_2D.py`` (its source emitting each
    frame) or ``scripts/async/wheel.py`` on the port (CPU), frames of
    `frame_dt` until its sand lies on the wheel (WHEEL_2D_SNAPSHOTS),
    saved as a snapshot. Prints the particles, the grains near the wheel
    and those with a CPIC state."""
    from taichi_mpm_torch import scenes

    path, frames = WHEEL_2D_SNAPSHOTS[name]
    sim = getattr(scenes, name)(device="cpu")
    sim.frame_dt = frame_dt
    for f in range(frames):
        if name == "sand_wheel_2d":
            scenes.sand_wheel_2d_source(sim, f)
        sim.step()
    p = sim.particles
    print(f"{name}: t={float(sim.t):.4f} particles={sim.particle_count()} "
          f"near={int(p.near_b.sum())} states={int((p.states != 0).sum())}", flush=True)
    sim.save(path)


def energy_curves(res=40, frames=10):
    """``scripts/benchmark/colliding_balls_energy.py`` in both packages on
    the CPU at `res`, `frames` frames (the JAX script built by ``runpy``,
    its sampler on the shipped tiles; the port's runner scene): each
    frame's mechanical energy in both, their relative difference, and
    each curve's drift over frames 7-10 (E at frame 10 against frame 7)."""
    import runpy
    import sys

    from taichi_mpm_tpu.sampling import poisson as jpoisson
    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.sampling import poisson as tpoisson

    jpoisson._periodic_cache = {d: tpoisson.periodic_tile(d) for d in (2, 3)}
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "scripts/benchmark/colliding_balls_energy.py")
    argv, sys.argv = sys.argv, [path, "--res", str(res)]
    try:
        jsim = runpy.run_path(path, run_name="scene")["sim"]
    finally:
        sys.argv = argv
    tsim = scenes.colliding_balls_energy(res=res, device="cpu")
    curves = {"jax": [], "port": []}
    for f in range(frames):
        for name, sim in (("jax", jsim), ("port", tsim)):
            sim.step()
            curves[name].append(float(sim.energy()))
        j, t = curves["jax"][-1], curves["port"][-1]
        print(f"frame {f:02d}  E jax {j:.7e}  port {t:.7e}  rel {abs(t - j) / abs(j):.2e}",
              flush=True)
    if frames >= 10:
        for name, c in curves.items():
            print(f"{name}: E(10) / E(7) - 1 = {c[9] / c[6] - 1:+.4%}", flush=True)
    return curves


if __name__ == "__main__":
    # from the repo's root: PYTHONPATH=. python tests/port/port_helpers.py dense-noise
    import argparse

    ap = argparse.ArgumentParser(description="the measurements behind the dense path's bounds")
    ap.add_argument("what", choices=("dense-noise", "jax-dense-vs-blocked",
                                     "jax-cpic-dense-vs-blocked", "jax-cpic-unfused-vs-fused",
                                     "dense-cpic-profile", "hub-wheel-witness", "cos-sin",
                                     "wheel-2d-snapshot", "energy-curves"))
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.what == "dense-cpic-profile":  # on the card
        dense_cpic_profile()
    elif args.what == "energy-curves":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        energy_curves()
    elif args.what == "wheel-2d-snapshot":
        for name in WHEEL_2D_SNAPSHOTS:
            wheel_2d_snapshot(name)
    elif args.what == "dense-noise":
        dense_noise()
    elif args.what == "jax-dense-vs-blocked":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        jax_dense_vs_blocked_report()
    elif args.what == "cos-sin":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        cos_sin_against_xla()
    elif args.what == "hub-wheel-witness":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        hub_wheel_witness()
    elif args.what == "jax-cpic-unfused-vs-fused":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        print("JAX, cpic_check's 10k wheel, 6 substeps, pytree - packed:",
              jax_cpic_unfused_vs_fused(), flush=True)
    else:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        print("JAX, cpic_check's 10k wheel, 4 substeps, oracle - packed:",
              jax_cpic_dense_vs_blocked(), flush=True)
