"""Port vs JAX: the scene API builds the same particles.

``add_particles`` (with a texture-modulated parameter and the reference's
silently dropped non-callable ``*_tex``), ``_finalize`` and the emission
of later batches into free slots (``_inject``) must give exactly the
particle arrays and configuration of the JAX package's ``MPM``. Then the
port steps the scene on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from taichi_mpm_tpu.core.solver import MPM as JMPM
from taichi_mpm_torch import MPM as TMPM
from taichi_mpm_torch import convert

torch.set_num_threads(1)


def _assert_same(jsim, tsim):
    assert dataclasses.asdict(tsim.cfg) == dataclasses.asdict(
        convert.config_from_dict(dataclasses.asdict(jsim.cfg)))
    j = convert.particles_to_numpy(jsim.particles)
    for name, arr in convert.particles_to_numpy(tsim.particles).items():
        assert np.array_equal(arr, j[name]), name


def test_scene_construction_matches_jax():
    rng = np.random.default_rng(51)
    pos = rng.uniform(0.3, 0.6, (260, 3)).astype(np.float32)
    kw = dict(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=4e-4, capacity=300)
    sims = (JMPM(**kw), TMPM(device="cpu", **kw))
    for sim in sims:
        sim.add_particles("jelly", pos=pos[:150], vel=(0.1, -0.2, 0.0),
                          E=2e4, nu=0.35, density=1000.0)
        sim.add_particles("sand", pos=pos[150:200],
                          cohesion_tex=lambda x: 0.1 * x[:, 1],
                          beta_tex=0.5)  # not callable: dropped, as in the reference
        sim._finalize()
    _assert_same(*sims)
    assert np.allclose(sims[1].particles.params[150:200, 3].numpy(), 0.1 * pos[150:200, 1])

    for sim in sims:  # emission into free slots
        sim.add_particles("water", pos=pos[200:], density=500.0)
    _assert_same(*sims)
    for sim in sims:
        with pytest.raises(RuntimeError, match="capacity exhausted"):
            sim.add_particles("water", pos=pos[:41])

    tsim = sims[1]
    tsim.step()
    assert tsim.block_capacity is not None
    assert tsim.particles.count() == 260
    assert np.isfinite(tsim.positions()).all()
    assert tsim.velocities().shape == (260, 3)
    # a later emission invalidates the carry; the next frame re-packs
    tsim.add_particles("jelly", pos=pos[:5] + 0.01)
    tsim.step()
    assert tsim.particles.count() == 265 and tsim.n_sorts == 2
