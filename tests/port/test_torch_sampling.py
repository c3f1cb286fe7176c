"""Port vs JAX: particle seeding.

Textures and their transforms give JAX's values exactly on random
points. ``bridson`` gives JAX's points bit for bit on small boxes,
periodic or not, in 2-D and 3-D. The shipped periodic tiles are the
port's ``bridson`` over [0, bound)^d from ``default_rng(12345)``, the
generation of JAX's ``periodic_tile`` (whose loop of numpy scalars makes
the 3-D one take tens of seconds, ten times the port's): so JAX's
functions below are given the shipped tiles instead of generating their
own. ``sample_from_periodic_data``, ``sample_from_source`` and
``sample_packed`` give JAX's points exactly; ``add_particles`` with a
density texture gives JAX's positions, vol and mass exactly, on the
periodic-tile, Bridson and rejection paths (``scripts/async/water.py``'s
dam at res 32 among them); and an emitter over three frames, after the
scene is finalized, fills the same slots, until the capacity runs out
and both raise."""

import numpy as np
import pytest
import torch

from taichi_mpm_tpu.core.solver import MPM as JMPM
from taichi_mpm_tpu.sampling import poisson as jpoisson
from taichi_mpm_tpu.sampling import texture as jtex
from taichi_mpm_torch import MPM as TMPM
from taichi_mpm_torch import convert
from taichi_mpm_torch.sampling import poisson as tpoisson
from taichi_mpm_torch.sampling import texture as ttex

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def shipped_tiles(monkeypatch):
    """JAX's sampler on the port's shipped tiles (see the module
    docstring), not on a slow generation or a cache outside the repo."""
    monkeypatch.setattr(jpoisson, "_periodic_cache",
                        {d: tpoisson.periodic_tile(d) for d in (2, 3)})


def _textures(m):
    """Each texture of module `m` and its transforms, in 3-D."""
    from taichi_mpm_torch.rigid.mesh import box_mesh

    box = m.box((0.2, 0.1, 0.3), (0.6, 0.5, 0.7))
    return {
        "sphere": m.sphere((0.5, 0.4, 0.5), 0.2),
        "box_x5": box * 5,
        "ring": m.ring((0.5, 0.5, 0.5), 0.1, 0.3, axis=1),
        "slab": m.slab(2, 0.25, 0.75) * 3.0,
        "bound": m.constant(2.0).bound(0, 0.4, 0.6, outside=0.5),
        "translate": box.translate((0.1, -0.05, 0.2)),
        "scale": box.scale((1.5, 0.5, 2.0)),
        "rotate": box.rotate(1, 3),
        "sum_product": m.sphere((0.4, 0.4, 0.4), 0.3) * box + m.slab(1, 0.0, 0.3),
        "mesh": m.mesh(box_mesh((0.15, 0.1, 0.2)), translate=(0.5, 0.5, 0.5)),
    }


@pytest.mark.parametrize("name", list(_textures(jtex)))
def test_textures_match_jax(name):
    pts = np.random.default_rng(4).uniform(-0.1, 1.1, (4000, 3))
    want = _textures(jtex)[name](pts)
    got = _textures(ttex)[name](pts)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert want.max() > 0 and want.min() < want.max()  # both sides of the texture


def test_textures_2d_match_jax():
    pts = np.random.default_rng(5).uniform(0.0, 1.0, (3000, 2))
    for m_name in ("ring", "box"):
        j = jtex.ring((0.5, 0.5), 0.05, 0.2) if m_name == "ring" else jtex.box((0.2, 0.2), (0.4, 0.7))
        t = ttex.ring((0.5, 0.5), 0.05, 0.2) if m_name == "ring" else ttex.box((0.2, 0.2), (0.4, 0.7))
        assert np.array_equal(t.rotate(0, 1)(pts), j.rotate(0, 1)(pts))


@pytest.mark.parametrize("lo,hi,r,periodic,seed", [
    ((0.0, 0.0), (1.0, 1.0), 0.08, False, 0),
    ((0.0, 0.0), (3.0, 3.0), 0.2, True, 1),
    ((0.1, 0.0, 0.2), (0.7, 0.8, 0.6), 0.12, False, 3),
    ((0.0, 0.0, 0.0), (4.0, 4.0, 4.0), 1.0, True, 12345),
], ids=["2d", "2d_periodic", "3d", "3d_periodic"])
def test_bridson_matches_jax(lo, hi, r, periodic, seed):
    want = jpoisson.bridson(np.asarray(lo), np.asarray(hi), r,
                            rng=np.random.default_rng(seed), periodic=periodic)
    got = tpoisson.bridson(np.asarray(lo), np.asarray(hi), r,
                           rng=np.random.default_rng(seed), periodic=periodic)
    assert len(want) > 30
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("dim,n", [(2, 993), (3, 2399)])
def test_shipped_tile_is_the_generation(dim, n):
    pts, bound = tpoisson.periodic_tile(dim)
    assert bound == (40.0 if dim == 2 else 16.0) and pts.shape == (n, dim)
    assert np.array_equal(tpoisson.generate_tile(dim), pts)
    assert tpoisson.min_distance_for_ppc(1 / 64, 8.0, dim) == \
        jpoisson.min_distance_for_ppc(1 / 64, 8.0, dim)


LO3, HI3 = np.zeros(3), np.ones(3)


def test_sample_from_periodic_data_matches_jax():
    for m, dx in ((ttex, 1 / 32), (ttex, 1 / 48)):
        tex_t = m.box((0.1, 0.08, 0.1), (0.35, 0.5, 0.9)) * 6
        tex_j = jtex.box((0.1, 0.08, 0.1), (0.35, 0.5, 0.9)) * 6
        want = jpoisson.sample_from_periodic_data(tex_j, LO3, HI3, dx, 3)
        got = tpoisson.sample_from_periodic_data(tex_t, LO3, HI3, dx, 3)
        assert len(want) > 1000 and np.array_equal(got, want)
    want = jpoisson.sample_from_periodic_data(jtex.ring((0.5, 0.5), 0.05, 0.2) * 4,
                                              np.zeros(2), np.ones(2), 1 / 64, 2)
    got = tpoisson.sample_from_periodic_data(ttex.ring((0.5, 0.5), 0.05, 0.2) * 4,
                                             np.zeros(2), np.ones(2), 1 / 64, 2)
    assert np.array_equal(got, want)


def test_sample_from_source_matches_jax():
    """The sand source of scripts/mls-cpic/sand_paddles.py at res 64 over
    three frames of 1e-3 s: each frame's layer as JAX's."""
    tex_j = jtex.sphere((0.5, 0.85, 0.5), 0.05) * 8
    tex_t = ttex.sphere((0.5, 0.85, 0.5), 0.05) * 8
    v, g, dt, base = np.array([0.0, -0.8, 0.0]), np.array([0.0, -10.0, 0.0]), 1e-3, 5e-5
    adv = v * dt + 0.5 * g * (dt + base) * dt
    total = 0
    for f in range(3):
        off = v * float(np.float32(f * dt))
        want = jpoisson.sample_from_source(tex_j, LO3, HI3, 1 / 64, 3, off, adv)
        got = tpoisson.sample_from_source(tex_t, LO3, HI3, 1 / 64, 3, off, adv)
        assert np.array_equal(got, want)
        total += len(want)
    assert total > 20


def test_sample_packed_matches_jax():
    args = (LO3, HI3, 1 / 32, 3, 0.04, 0.01)
    want = jpoisson.sample_packed(jtex.box((0.3, 0.3, 0.3), (0.7, 0.5, 0.7)),
                                  jtex.sphere((0.5, 0.5, 0.5), 0.04) * 8, *args)
    got = tpoisson.sample_packed(ttex.box((0.3, 0.3, 0.3), (0.7, 0.5, 0.7)),
                                 ttex.sphere((0.5, 0.5, 0.5), 0.04) * 8, *args)
    assert len(want) > 100 and np.array_equal(got, want)


def _same_particles(jsim, tsim):
    j = convert.particles_to_numpy(jsim.particles)
    for name, arr in convert.particles_to_numpy(tsim.particles).items():
        assert np.array_equal(arr, j[name]), name
    assert tsim.cfg.active_materials == tuple(jsim.cfg.active_materials)


@pytest.mark.parametrize("path", ["water_script", "bridson", "rejection"])
def test_add_particles_texture_matches_jax(path):
    """water.py's dam (the periodic tile, 16,544 particles at res 32), a
    Bridson-seeded sphere (pd_periodic=False) and a rejection-sampled box
    (pd=False) through add_particles."""
    kw = dict(res=(32, 32, 32), base_delta_t=1e-3, frame_dt=0.01)
    sims = (JMPM(**kw), TMPM(device="cpu", **kw))
    for sim, m in zip(sims, (jtex, ttex)):
        if path == "water_script":
            n = sim.add_particles("water", density=1000,
                                  density_tex=m.box((0.1, 0.08, 0.1), (0.35, 0.5, 0.9)) * 6)
            assert n == 16544
        elif path == "bridson":
            sim.add_particles("jelly", density_tex=m.sphere((0.5, 0.5, 0.5), 0.05) * 2,
                              pd_periodic=False, vel=(0.0, -1.0, 0.0))
        else:
            sim.add_particles("sand", density_tex=m.box((0.3, 0.2, 0.3), (0.5, 0.4, 0.6)) * 3,
                              pd=False, density=2000, friction_angle=35.0)
        sim._finalize()
    assert sims[1].particles.count() > 30
    _same_particles(*sims)


def test_source_emission_matches_jax():
    """A source after the scene is finalized, at the time of frames 1-3
    of 2e-3 s: each frame's batch fills the same free slots with the same
    particles as JAX's, until the capacity runs out and both raise."""
    kw = dict(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=2e-3, capacity=200)
    sims = (JMPM(**kw), TMPM(device="cpu", **kw))
    for sim, m in zip(sims, (jtex, ttex)):
        sim.add_particles("water", density=1000,
                          density_tex=m.box((0.45, 0.2, 0.45), (0.55, 0.25, 0.55)) * 4)
        sim._finalize()
    srcs = (jtex.sphere((0.3, 0.8, 0.5), 0.08) * 8, ttex.sphere((0.3, 0.8, 0.5), 0.08) * 8)
    counts = []
    for f in range(1, 4):
        sims[0].t = np.float32(f * 2e-3)
        sims[1].t = np.float32(f * 2e-3)
        batch = [sim.add_particles("water", density=1000, density_tex=src, pd_source=True,
                                   vel=(0.0, -3.0, 0.0), delta_t=sim.frame_dt)
                 for sim, src in zip(sims, srcs)]
        assert batch[0] == batch[1] > 0
        counts.append(batch[1])
        _same_particles(*sims)
    for sim, src in zip(sims, srcs):
        with pytest.raises(RuntimeError, match="capacity exhausted"):
            for f in range(4, 40):
                sim.t = np.float32(f * 2e-3)
                sim.add_particles("water", density=1000, density_tex=src, pd_source=True,
                                  vel=(0.0, -3.0, 0.0), delta_t=sim.frame_dt)
    assert sims[1].particles.count() == sims[0].particles.active.sum() <= 200
