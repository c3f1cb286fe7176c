"""Port vs JAX: the whole slice, frames of the blocked fixed-dt path.

The port's ``packed_frame`` (on the CPU through the kernels' plain twins)
against the JAX package's ``packed_frame(fused=True)`` with its Pallas
kernels in interpret mode, on the same numpy particles. Held to the
bounds the reference sets between its own paths
(``tests/test_fused.py``): x 5e-6, v 5e-5, F 5e-6, C 5e-4, aux 5e-6
absolute, after 6 substeps; the sort count and the plasticity count must
be equal. The high-velocity scene re-sorts inside the frame; v there is
30x larger, so its v bound scales with it (5e-4, as the reference's own
mid-frame test). Then the port's ``MPM`` on ``benchmark_cube`` against
the JAX carry driven frame by frame, and page-map growth from a K that
is too small.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taichi_mpm_tpu import scenes as jscenes
from taichi_mpm_tpu.core import levelset as jls
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import convert
from taichi_mpm_torch import scenes as tscenes
from taichi_mpm_torch.core import levelset as tls
from taichi_mpm_torch.ops import packed as tpacked

from port_helpers import configs, jax_particles, max_err, scene_arrays

torch.set_num_threads(1)

BOUNDS = dict(x=5e-6, v=5e-5, F=5e-6, C=5e-4, aux=5e-6)


def _assert_particles_close(jp, tp, v_bound=BOUNDS["v"]):
    ja = np.asarray(jp.active)
    ta = tp.active.numpy()
    assert np.array_equal(ja, ta)  # same lanes alive, in the same order
    for name, bound in BOUNDS.items():
        if name == "v":
            bound = v_bound
        err = max_err(np.asarray(getattr(jp, name))[ja], getattr(tp, name).numpy()[ta])
        assert err <= bound, (name, err)


def _both_frames(arrays, jcfg, tcfg, jcol, tcol, n_sub, K):
    jp, _, jnmax, jns, jpl = jpacked.packed_frame(
        jax_particles(arrays), jnp.float32(0.0), jcfg, jcol, jcfg.base_dt, n_sub, K,
        interpret=True, fused=True)
    tp, _, tnmax, tns, tpl = tpacked.packed_frame(
        convert.particles_from_numpy(arrays), np.float32(0.0), tcfg, tcol,
        tcfg.base_dt, n_sub, K)
    return (jp, int(jnmax), int(jns), int(jpl)), (tp, tnmax, tns, int(tpl))


@pytest.mark.parametrize("mats,extra", [
    (("jelly",), {}),
    (("jelly", "water"), dict(particle_collision=True, clean_boundary=True)),
])
def test_frame_matches_jax(mats, extra):
    """A sticky box and a frictional floor that cuts through the block, so
    both the grid projection and the per-particle collision act."""
    a, mids = scene_arrays(1200, seed=41, mats=mats)
    jcfg, tcfg = configs(mids, **extra)
    lo, hi = (0.12,) * 3, (0.88,) * 3
    jcol = (jls.box_domain(lo, hi, friction=-1.0),
            jls.plane((0.0, 0.39, 0.0), (0.0, 1.0, 0.0), friction=0.3))
    tcol = (tls.box_domain(lo, hi, friction=-1.0),
            tls.plane((0.0, 0.39, 0.0), (0.0, 1.0, 0.0), friction=0.3))
    (jp, jnmax, jns, jpl), (tp, tnmax, tns, tpl) = _both_frames(
        a, jcfg, tcfg, jcol, tcol, n_sub=6, K=192)
    assert (jnmax, jns, jpl) == (tnmax, tns, tpl)
    if "water" in mats:
        assert tpl > 0  # the plasticity count is exercised, not only zero
    _assert_particles_close(jp, tp)


@pytest.fixture(scope="module")
def fast_scene():
    """High velocities: the drift bound forces re-sorts inside the frame
    (the scene of the reference's test_fused_midframe_resort)."""
    a, mids = scene_arrays(1200, seed=3, v_scale=30.0)
    jcfg, tcfg = configs(mids)
    jp, _, jnmax, jns, jpl = jpacked.packed_frame(
        jax_particles(a), jnp.float32(0.0), jcfg, (), jcfg.base_dt, 6, 192,
        interpret=True, fused=True)
    return a, tcfg, (jp, int(jnmax), int(jns), int(jpl))


def test_frame_midframe_resort(fast_scene):
    a, tcfg, (jp, jnmax, jns, jpl) = fast_scene
    tp, _, tnmax, tns, tpl = tpacked.packed_frame(
        convert.particles_from_numpy(a), np.float32(0.0), tcfg, (), tcfg.base_dt, 6, 192)
    assert jns >= 2  # the initial sort and at least one inside the frame
    assert (jnmax, jns, jpl) == (tnmax, tns, int(tpl))
    _assert_particles_close(jp, tp, v_bound=5e-4)


def test_page_map_grows_at_the_sort(fast_scene):
    """Start from K = 64: the first sort fits, the re-sort inside the
    frame overflows and grows the map at once. Growing changes only the
    capacity, so the frame equals the JAX frame run with a large K."""
    a, tcfg, (jp, jnmax, jns, jpl) = fast_scene
    carry = tpacked.pack_carry(convert.particles_from_numpy(a), tcfg, 64)
    assert carry[2]["ids"].shape[0] == 64
    carry, _, tnmax, tns, tpl = tpacked.packed_frame_carry(
        carry, np.float32(0.0), tcfg, (), tcfg.base_dt, 6)
    assert tnmax == jnmax > 64
    assert carry[2]["ids"].shape[0] == tpacked.grown_capacity(jnmax, tcfg)
    assert (tns + 1, int(tpl)) == (jns, jpl)
    tp = tpacked.unpack_particles(carry[0], a["x"].shape[0])
    _assert_particles_close(jp, tp, v_bound=5e-4)


def test_mpm_benchmark_cube_matches_jax_carry():
    """The port's MPM on benchmark_cube(cells=5, res=32): 1000 jelly
    particles in a sticky box, 2 frames of 3 substeps, against the JAX
    carry (pack_carry, then packed_frame_carry once per frame) on the
    same particles with the same K."""
    kw = dict(cells=5, res=32, material="jelly", E=2e4, nu=0.35)
    sim = tscenes.benchmark_cube(device="cpu", **kw)
    jsim = jscenes.benchmark_cube(**kw)
    jsim._finalize()
    jcfg = jsim.cfg
    K = jsim._active_block_cap()
    n_sub = 3
    sim.frame_dt = n_sub * sim.cfg.base_dt

    # same seeding, same configuration
    p0 = convert.particles_to_numpy(jsim.particles)
    sim._ensure_finalized()
    assert dataclasses.asdict(sim.cfg) == dataclasses.asdict(
        convert.config_from_dict(dataclasses.asdict(jcfg)))
    for name, arr in convert.particles_to_numpy(sim.particles).items():
        assert np.array_equal(arr, p0[name]), name

    carry = jpacked.pack_carry(jsim.particles, jcfg, K, two_d=True)
    frame = jax.jit(lambda c, t: jpacked.packed_frame_carry(
        c, t, jcfg, tuple(jsim.colliders), jcfg.base_dt, n_sub, K,
        interpret=True, fused=True))  # traced once for both frames
    t = jnp.float32(0.0)
    jsorts, jplast = 1, 0
    for _ in range(2):
        sim.step()
        carry, t, _, ns, pl = frame(carry, t)
        jsorts += int(ns)
        jplast += int(pl)
    jax.block_until_ready(carry)

    assert sim.block_capacity == K
    assert (sim.n_sorts, sim.plasticity_counter) == (jsorts, jplast)
    assert abs(float(sim.t) - float(t)) <= 1e-9
    jp = jpacked.unpack_particles(carry[0], p0["x"].shape[0])
    _assert_particles_close(jp, sim.particles)
    assert int(sim.particles.active.sum()) == 1000
    assert sim.positions().shape == (1000, 3)
