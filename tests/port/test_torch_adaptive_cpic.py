"""Port vs JAX: global adaptive dt on a CPIC scene.

The wheel scene of ``tests/test_cpic_packed.py`` (water falling beside
the axis of a free 4-paddle wheel, res 16): its water's sound speed
binds, so dt is snapped to 1.28e-4 below the 2e-4 maximum and the last
substep lands on the frame's end. The port's
``cpic_packed_adaptive_frame_carry`` (on the CPU, the kernels' plain
twins) against the JAX package's, with its Pallas kernels in interpret
mode, from the same numpy state, at the bounds ``tests/test_cpic_packed.py``
holds the JAX paths to: x 5e-6, v 5e-4, F 5e-5, states and near_b
exactly, body vel and omega 1e-5, pos 1e-6; the substep count and the
frame's counts equal. Then ``AsyncMPM`` built through the port's scene
API: its frame is that frame, and with TMT_FUSED=0 it runs the dense
CPIC frame."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_tpu.rigid.cpic_packed import (
    cpic_packed_adaptive_frame_carry as jax_frame,
    cpic_packed_pack_carry as jax_pack,
)
from taichi_mpm_torch.core.adaptive import AsyncMPM
from taichi_mpm_torch.ops import packed as tpacked
from taichi_mpm_torch.rigid import cpic_packed as tcp
from taichi_mpm_torch.rigid.mesh import paddle_wheel_mesh

from port_helpers import assert_cpic_close, jax_wheel_scene, port_inputs

torch.set_num_threads(1)

FRAME_DT, UNIT, K, NEAR, B1, KR = 1e-3, 1e-6, 128, 256, 1024, 128


@pytest.fixture(scope="module")
def frames():
    sim = jax_wheel_scene()
    cfg = sim.cfg
    carry = jax_pack(sim.particles, cfg, K, two_d=True)
    jc, jb, jt, *jcounts = jax_frame(carry, sim.bodies, jnp.float32(0.0), cfg, sim.rigid_scene,
                                      FRAME_DT, UNIT, cfg.base_dt, K, NEAR, B1, KR,
                                      interpret=True)
    jp = jpacked.unpack_particles(jc[0], sim.particles.capacity)
    tp, tb, ts, tcfg = port_inputs(sim)
    dts = []
    tc, tb2, tt, *tcounts = tcp.cpic_packed_adaptive_frame_carry(
        tpacked.pack_carry(tp, tcfg, K), tb, np.float32(0.0), tcfg, ts, FRAME_DT, UNIT,
        tcfg.base_dt, tcp.Capacities(KR), dts=dts)
    tout = (tpacked.unpack_particles(tc[0], tp.capacity), tb2, tt, tcounts, dts)
    return sim, (jp, jb, jt, [int(v) for v in jcounts]), tout


def test_adaptive_cpic_frame_matches_jax(frames):
    _, (jp, jb, jt, jcounts), (tp, tb, tt, tcounts, dts) = frames
    assert_cpic_close(jp, jb, tp, tb)
    assert jcounts == [int(v) for v in tcounts]  # n_act, n_near, n_coarse, n_r, sorts, plast, n
    assert np.float32(jt) == tt
    assert tcounts[-1] == 8 and tcounts[1] > 0  # 7 x 1.28e-4 and the rest; a near set
    assert max(dts) == np.float32(1.28e-4) and min(dts) < max(dts)


def test_async_mpm_runs_the_adaptive_cpic_frame(frames, monkeypatch):
    """The scene of jax_wheel_scene built with the port's AsyncMPM: one
    frame is the JAX frame, within the same bounds."""
    sim, (jp, jb, _, jcounts), _ = frames
    monkeypatch.delenv("TMT_FUSED", raising=False)
    tsim = AsyncMPM(res=(16, 16, 16), base_delta_t=2e-4, frame_dt=FRAME_DT, unit_delta_t=UNIT,
                    gravity=(0, -10.0, 0), penalty=1e3, device="cpu")
    pos = np.asarray(sim.particles.x)[np.asarray(sim.particles.active)]
    tsim.add_particles("water", pos=pos, vel=(0, -1.0, 0), density=1000)
    tsim.add_particles("rigid", mesh=paddle_wheel_mesh(n_paddles=4, outer=0.18),
                       initial_position=(0.5, 0.4, 0.5), rotation_axis=(0, 0, 1),
                       codimensional=True, friction=0.1, density=40.0)
    tsim.step()
    assert_cpic_close(jp, jb, tsim.particles, tsim.bodies)
    assert tsim.last_substeps == jcounts[-1]
    assert tsim.update_counter == jcounts[-1] * 200
    assert tsim.cpic_stats["n_near"] == jcounts[1]

    monkeypatch.setenv("TMT_FUSED", "0")
    unfused = AsyncMPM(res=(16, 16, 16), device="cpu")
    unfused.add_particles("water", pos=pos, density=1000)
    unfused.add_particles("rigid", mesh=paddle_wheel_mesh(n_paddles=4, outer=0.18),
                          initial_position=(0.5, 0.4, 0.5), codimensional=True)
    unfused.step()  # the dense CPIC frame (tests/port/test_torch_cpic_dense.py holds it)
    assert unfused.packed_carry is None and unfused.last_substeps > 0
