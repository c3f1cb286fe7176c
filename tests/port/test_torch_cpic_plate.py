"""Port vs JAX: the CPIC frame on the plate scene of
``tests/test_cpic_packed.py`` (jelly over a scripted plate), with the
dense CDF (Kr = 0) and particles fast enough to re-sort inside the frame.

The port's ``cpic_packed_frame`` (on the CPU: the kernels' plain twins)
and the port's ``MPM`` solver against the JAX package's
``cpic_packed_frame`` with its Pallas kernels in interpret mode, from the
same numpy state, at the bounds that file holds the JAX paths to: x 5e-6,
v 5e-4, F 5e-5, states and near_b exactly, body vel and omega 1e-5, pos
1e-6; the frame's counts must be equal. ``MPM`` estimates its own
capacities (and keeps the rigid page map, Kr > 0): the result must not
depend on them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.rigid.cpic_packed import cpic_packed_frame as jax_frame
from taichi_mpm_tpu.rigid.mesh import plate_mesh
from taichi_mpm_torch import MPM
from taichi_mpm_torch.rigid import cpic_packed as tcp

from port_helpers import assert_cpic_close, jax_plate_scene, port_inputs

torch.set_num_threads(1)

N_SUB, K, NEAR, B1, KR = 8, 128, 256, 1024, 0
VDRIFT = 0.1 / (2e-4 * 16.0)  # ~0.1 cell per substep: a re-sort inside the frame
SEED = 7


@pytest.fixture(scope="module")
def frames():
    sim = jax_plate_scene(vel=(VDRIFT, -0.5, 0.0), seed=SEED)
    cfg = sim.cfg
    jout = jax_frame(sim.particles, sim.bodies, jnp.float32(0.0), cfg, sim.rigid_scene,
                     cfg.base_dt, N_SUB, K, NEAR, B1, KR, interpret=True, two_d=True)
    tp, tb, ts, tcfg = port_inputs(sim)
    tout = tcp.cpic_packed_frame(tp, tb, np.float32(0.0), tcfg, ts, tcfg.base_dt, N_SUB, K,
                                 tcp.Capacities(KR))
    return sim, jout, tout


def test_plate_frame_matches_jax(frames):
    _, jout, tout = frames
    assert_cpic_close(jout[0], jout[1], tout[0], tout[1])
    # max n_act, n_near, n_coarse, n_r, sorts (one inside the frame), plasticity
    assert [int(v) for v in jout[3:]] == [int(v) for v in tout[3:]]
    assert int(tout[7]) == 2


def test_plate_mpm_matches_jax(frames):
    """The port's own scene API and solver (own capacities, Kr > 0)."""
    sim, jout, _ = frames
    rng = np.random.default_rng(SEED)
    pos = rng.uniform(0.3, 0.7, size=(220, 3)).astype(np.float32)
    tsim = MPM(res=(16, 16, 16), base_delta_t=2e-4, gravity=(0, -10.0, 0), penalty=1e3,
               device="cpu")
    tsim.add_particles("jelly", pos=pos, vel=(VDRIFT, -0.5, 0.0), E=1e4, nu=0.3, density=1000)
    rid = tsim.add_particles(
        "rigid", mesh=plate_mesh(half_u=0.25, half_v=0.25, axis=1),
        scripted_position=lambda t: (0.5, 0.45, 0.5),
        scripted_rotation=lambda t: (0.0, 0.0, 0.0), codimensional=True, friction=0.2)
    assert rid == 1
    tsim.frame_dt = N_SUB * tsim.cfg.base_dt
    tsim.step()
    assert tsim.cpic_caps.Kr > 0 and tsim.cpic_stats["n_near"] == int(jout[4])
    assert_cpic_close(jout[0], jout[1], tsim.particles, tsim.bodies)
