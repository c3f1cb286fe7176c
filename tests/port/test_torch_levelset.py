"""Port vs JAX: the level-set constructors ``cylinder``, ``union`` and
``dirichlet_slab``, and a Dirichlet region on the blocked path.

The cylinder's SDF and the slab's mask and pinned velocity equal JAX's
on random points (the SDF within 2e-7, the mask and velocity exactly);
the cylinder's central-difference normal within 1e-5 (an ulp of the SDF
over the difference's 2 eps = 1/32 is 2e-6). Then a frame of the
blocked fused path with a Dirichlet slab through the falling block and a
cylinder obstacle under it: the port's ``packed_frame`` against JAX's (Pallas kernels in
interpret mode), within the bounds of ``tests/test_fused.py``; the
grid velocity the slab pins shows in the particles it holds."""

import numpy as np
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.core import levelset as jls
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import convert
from taichi_mpm_torch.core import levelset as tls
from taichi_mpm_torch.ops import packed as tpacked

from port_helpers import assert_frame_close, configs, jax_particles, max_err, scene_arrays

torch.set_num_threads(1)


def _points(n=5000, seed=2):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, 3)).astype(np.float32)


def test_cylinder_matches_jax():
    x = _points()
    for axis in range(3):
        j = jls.cylinder((0.5, 0.4, 0.6), axis, 0.15, friction=0.3)
        t = tls.cylinder((0.5, 0.4, 0.6), axis, 0.15, friction=0.3)
        assert t.friction == j.friction == 0.3
        assert max_err(t.sdf(torch.as_tensor(x), 0.0), j.sdf(jnp.asarray(x), 0.0)) <= 2e-7
        assert max_err(t.normal(torch.as_tensor(x), 0.0, 1 / 64),
                       j.normal(jnp.asarray(x), 0.0, 1 / 64)) <= 1e-5


def test_union_and_dirichlet_slab_match_jax():
    a, b = tls.plane((0, 0.1, 0), (0, 1, 0)), tls.sphere((0.5, 0.5, 0.5), 0.1)
    assert tls.union(a, b) == (a, b) and len(jls.union(1, 2)) == 2
    x = _points()
    for vel in ((), (0.0, 0.5, -1.0)):
        j = jls.dirichlet_slab(1, 0.3, 0.6, velocity=vel)
        t = tls.dirichlet_slab(1, 0.3, 0.6, velocity=vel)
        mask = t.mask(torch.as_tensor(x), 0.0).numpy()
        assert np.array_equal(mask, np.asarray(j.mask(jnp.asarray(x), 0.0)))
        assert 0 < mask.sum() < len(x) and t.velocity == j.velocity == vel


def test_dirichlet_scene_matches_jax():
    a, mids = scene_arrays(1200, seed=71, v_scale=0.3)
    jcfg, tcfg = configs(mids)
    slab = dict(axis=0, lo=0.42, hi=0.46, velocity=(0.0, 1.0, 0.0))
    jcol = (jls.box_domain((0.1,) * 3, (0.9,) * 3, friction=-1.0),
            jls.cylinder((0.45, 0.34, 0.45), 2, 0.03, friction=0.2), jls.dirichlet_slab(**slab))
    tcol = (tls.box_domain((0.1,) * 3, (0.9,) * 3, friction=-1.0),
            tls.cylinder((0.45, 0.34, 0.45), 2, 0.03, friction=0.2), tls.dirichlet_slab(**slab))
    jp, _, jnmax, jns, jpl = jpacked.packed_frame(
        jax_particles(a), jnp.float32(0.0), jcfg, jcol, jcfg.base_dt, 6, 192,
        interpret=True, fused=True)
    tp, _, tnmax, tns, tpl = tpacked.packed_frame(
        convert.particles_from_numpy(a), np.float32(0.0), tcfg, tcol, tcfg.base_dt, 6, 192)
    assert (int(jnmax), int(jns), int(jpl)) == (tnmax, tns, int(tpl))
    assert_frame_close(jp, tp)
    x, v = tp.x.numpy(), tp.v.numpy()
    held = tp.active.numpy() & (x[:, 0] > 0.435) & (x[:, 0] < 0.445)
    assert held.sum() > 10 and v[held, 1].mean() > 0.5  # the slab lifts what it holds
