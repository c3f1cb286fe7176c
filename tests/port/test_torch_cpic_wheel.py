"""Port vs JAX: the CPIC frame on the wheel scene of
``tests/test_cpic_packed.py`` (water falling beside the axis of a free
4-paddle wheel), with the record-sparse CDF over the lazy rigid page map
(Kr = 128).

The port's ``cpic_packed_frame`` (on the CPU: the kernels' plain twins)
against the JAX package's ``cpic_packed_frame`` with its Pallas kernels
in interpret mode, from the same numpy state, at the bounds that file
holds the JAX paths to: x 5e-6, v 5e-4, F 5e-5, states and near_b
exactly, body vel and omega 1e-5, pos 1e-6; the frame's counts must be
equal. Then the port alone: the frame must give the same bits with twice
the capacities, and with capacities too small (grown where they are
used), and the ``MPM`` solver must run it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.rigid.cpic_packed import cpic_packed_frame as jax_frame
from taichi_mpm_torch import convert
from taichi_mpm_torch.rigid import cpic_packed as tcp

from port_helpers import assert_cpic_close, jax_wheel_scene, port_inputs

torch.set_num_threads(1)

N_SUB, K, NEAR, B1, KR = 6, 128, 256, 1024, 128


def _port_frame(sim, K, caps):
    tp, tb, ts, tcfg = port_inputs(sim)
    return tcp.cpic_packed_frame(tp, tb, np.float32(0.0), tcfg, ts, tcfg.base_dt, N_SUB, K, caps)


@pytest.fixture(scope="module")
def frames():
    sim = jax_wheel_scene()
    cfg = sim.cfg
    jout = jax_frame(sim.particles, sim.bodies, jnp.float32(0.0), cfg, sim.rigid_scene,
                     cfg.base_dt, N_SUB, K, NEAR, B1, KR, interpret=True, two_d=True)
    return sim, jout, _port_frame(sim, K, tcp.Capacities(KR))


def test_wheel_frame_matches_jax(frames):
    _, jout, tout = frames
    assert_cpic_close(jout[0], jout[1], tout[0], tout[1])
    assert [int(v) for v in jout[3:]] == [int(v) for v in tout[3:]]
    assert int(tout[4]) > 0 and int(tout[6]) > 0  # a near set and a rigid page map


@pytest.mark.parametrize("K2,caps", [
    (256, tcp.Capacities(2 * KR)),
    (64, tcp.Capacities(64)),  # K and Kr overflow and grow
], ids=["twice", "too_small"])
def test_capacity_independence(frames, K2, caps):
    """One frame with other capacities gives the same bits: the near set
    is sized to its counts, Kr and K only size maps."""
    sim, _, tout = frames
    other = _port_frame(sim, K2, caps)
    a, b = convert.particles_to_numpy(tout[0]), convert.particles_to_numpy(other[0])
    for name in ("x", "v", "F", "C", "aux", "states", "bdist", "bnormal", "near_b", "active"):
        assert a[name].tobytes() == b[name].tobytes(), name
    for name in ("pos", "vel", "rot", "omega"):
        assert torch.equal(getattr(tout[1], name), getattr(other[1], name)), name
    assert [int(v) for v in tout[4:]] == [int(v) for v in other[4:]]
    if K2 == 64:
        assert caps.Kr > 64  # it grew


def test_wheel_mpm_frames(frames):
    """``MPM`` over three frames of the same scene: the lazy re-sort
    and the rigid page map carried across frames, the state finite."""
    sim, jout, _ = frames
    from taichi_mpm_torch import MPM
    from taichi_mpm_torch.rigid.mesh import paddle_wheel_mesh

    tp, _, _, _ = port_inputs(sim)
    n = int(tp.active.sum())
    tsim = MPM(res=(16, 16, 16), base_delta_t=2e-4, gravity=(0, -10.0, 0), penalty=1e3,
               device="cpu")
    tsim.add_particles("water", pos=tp.x[:n].numpy(), vel=(0, -1.0, 0), density=1000)
    tsim.add_particles("rigid", mesh=paddle_wheel_mesh(n_paddles=4, outer=0.18),
                       initial_position=(0.5, 0.4, 0.5), rotation_axis=(0, 0, 1),
                       codimensional=True, friction=0.1, density=40.0)
    tsim.frame_dt = N_SUB * tsim.cfg.base_dt
    tsim.step()
    assert_cpic_close(jout[0], jout[1], tsim.particles, tsim.bodies)
    for _ in range(2):
        tsim.step()
    assert bool(torch.isfinite(tsim.particles.x).all())
    assert int(tsim.particles.active.sum()) == n
