"""Shared inputs of the port's CPU tests: scenes built once in numpy and
handed to both packages (the JAX reference and the torch port)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichi_mpm_torch import convert
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


def configs(mats, res=(32, 32, 32), base_dt=2e-4, **kw):
    """(JAX SimConfig, port SimConfig) with the same fields."""
    from taichi_mpm_tpu.config import SimConfig as JConfig

    jcfg = JConfig(res=res, base_dt=base_dt, gravity=(0.0, -10.0, 0.0),
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
