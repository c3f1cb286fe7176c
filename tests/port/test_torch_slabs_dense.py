"""The dense slab frames on two gloo ranks on the CPU (one spawned group,
``slab_ranks.dense_slabs``) against the JAX package's on 2 of the 8
virtual CPU devices, from the same particles (ids tagged):

* ``parallel.spatial.build_spatial_frame`` (node windows with a halo
  sum, migration every substep) on tests/test_spatial.py's 2-D strip at
  res 64, 4 frames of 10 substeps, against JAX's ``build_spatial_frame``;
* ``parallel.sharding.build_sharded_frame`` (the grids summed over the
  ranks) on tests/test_sharding.py's cube, benchmark_cube(cells=4,
  res=16), 5 substeps, against JAX's ``build_sharded_frame``;
* the fast strip (vel_x = 4, 10 frames): every particle kept (the port's
  migration is sized to its counts, so its frame drops none and returns
  dropped = 0) and each in its owning slab.

Bounds: the port's dense frames differ from JAX's in the order their
sums round. The port's P2G is one ordered scatter per grid; a halo node
of the slab frame, and every node of the data-parallel frame, is the
sum of two ranks' partial sums. The strip is held to the port's frame
bounds (``port_helpers.FRAME_BOUNDS``: x 5e-6, v 5e-5, F 5e-6, C 5e-4,
aux 5e-6) and the cube to tests/test_sharding.py's (x 1e-6, v 1e-5, F
1e-5). Measured on the CPU: the strip x 0, v 6.6e-7, F 1.8e-7 from
JAX's slabs (and v 4.2e-7 from the port's one-device frame, so not its
bits); the cube x 0, v 5.1e-9."""

import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from port_helpers import FRAME_BOUNDS, ID_SLOT, assert_close_by_id, tag_ids
from slab_ranks import dense_slabs
from taichi_mpm_torch import convert, scenes
from taichi_mpm_torch.parallel import comm
from taichi_mpm_tpu.core.solver import MPM as JMPM
from taichi_mpm_tpu.parallel.sharding import build_sharded_frame, shard_particles
from taichi_mpm_tpu.parallel.spatial import build_spatial_frame, shard_spatially
from taichi_mpm_tpu.scenes import benchmark_cube as jbenchmark_cube

torch.set_num_threads(1)

STRIP_BOUNDS = FRAME_BOUNDS
CUBE_BOUNDS = dict(x=1e-6, v=1e-5, F=1e-5)  # tests/test_sharding.py's


def _numpy(p):
    return {k: np.asarray(v) for k, v in vars(p).items()}


def _jax(arrays, like):
    return type(like)(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _global(ranks, key):
    """The ranks' particles of one run, concatenated."""
    return {k: np.concatenate([r[key][k] for r in ranks]) for k in ranks[0][key]
            if isinstance(ranks[0][key][k], np.ndarray)}


@pytest.fixture(scope="module")
def runs():
    """The ranks' results and, made while the ranks work, JAX's frames."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("x",))
    shard_mesh = Mesh(np.asarray(jax.devices()[:2]), ("shard",))
    strips = {}
    for vel in (1.0, 4.0):
        sim = scenes.spatial_strip(JMPM, vel_x=vel)
        sim._finalize()
        strips[vel] = (sim, tag_ids(_numpy(sim.particles)))
    cube = jbenchmark_cube(cells=4, res=16, material="jelly", E=2e4, nu=0.35)
    cube._finalize(capacity=512)
    cube_in = tag_ids(_numpy(cube.particles))
    out = {}

    def ranks():
        try:
            out["ranks"] = comm.run_ranks(dense_slabs, 2, "gloo",
                                          args=(strips[1.0][1], strips[4.0][1], cube_in),
                                          timeout_s=240)
        except Exception as e:  # re-raised below, in the test's thread
            out["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    sim, a = strips[1.0]
    ps = shard_spatially(_jax(a, sim.particles), sim.cfg, mesh, slack=2.0)
    frame = build_spatial_frame(sim.cfg, (), 10, mesh, budget=64)
    t = jnp.float32(0.0)
    for _ in range(4):
        ps, t, dropped = frame(ps, t)
        assert int(dropped) == 0
    strip = dict(_numpy(ps), t=float(t))
    p = shard_particles(_jax(cube_in, cube.particles), shard_mesh)
    p, t = build_sharded_frame(cube.cfg, tuple(cube.colliders), 5, shard_mesh)(
        p, jnp.float32(0.0))
    th.join(timeout=300)
    assert not th.is_alive(), "the ranks outlived their timeout"
    if "error" in out:
        raise out["error"]
    return dict(ranks=out["ranks"], strip=strip, cube=dict(_numpy(p), t=float(t)))


def _close(a, b, bounds):
    assert_close_by_id(SimpleNamespace(**a), SimpleNamespace(**b), bounds)


def test_spatial_frame_matches_jax(runs):
    """The dense slab frame, 4 frames of the strip on two ranks, against
    JAX's on two devices: every particle kept, t equal, x, v, F within
    the strip bounds; nothing dropped."""
    r0, r1 = runs["ranks"]
    got = _global(runs["ranks"], "strip")
    assert got["active"].sum() == runs["strip"]["active"].sum() == 400
    assert r0["strip"]["dropped"] == r1["strip"]["dropped"] == 0
    assert r0["strip"]["t"] == r1["strip"]["t"] == runs["strip"]["t"]
    _close(runs["strip"], got, STRIP_BOUNDS)


def test_spatial_frame_fast_drift_keeps_particles(runs):
    """vel_x = 4 for 10 frames: particles cross the slab boundary every few
    substeps; all 400 stay, each in its owning slab."""
    Wc = 32
    for s, r in enumerate(runs["ranks"]):
        a = r["fast"]
        act = a["active"]
        assert r["fast"]["dropped"] == 0
        cx = (a["x"][act, 0] / (1.0 / 64)).astype(int)
        assert np.all(np.clip(cx // Wc, 0, 1) == s)
    assert sum(r["fast"]["active"].sum() for r in runs["ranks"]) == 400
    ids = np.concatenate([r["fast"]["params"][r["fast"]["active"], ID_SLOT]
                          for r in runs["ranks"]])
    assert sorted(ids.astype(int).tolist()) == list(range(400))


def test_sharded_frame_matches_jax(runs):
    """The data-parallel frame, 5 substeps of the cube on two ranks, each
    rank its half of the lanes, against JAX's on two devices lane for
    lane: x, v, F within tests/test_sharding.py's bounds, t equal."""
    got = _global(runs["ranks"], "cube")
    want = runs["cube"]
    assert np.array_equal(got["active"], want["active"]) and got["active"].sum() == 512
    assert runs["ranks"][0]["cube"]["t"] == want["t"]
    for name, bound in CUBE_BOUNDS.items():
        err = float(np.abs(got[name] - want[name]).max())
        assert err <= bound, (name, err)
