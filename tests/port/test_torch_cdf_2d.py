"""Port vs JAX: the dense grid CDF of the CPIC slice in 2-D.

``rasterize_rigid_boundary`` (the in-range test of a segment, the
``cdf_expand`` tag dilation) and the dense ``gather_cdf`` over
``dense_node_lookup``, on the same numpy inputs through both packages
(the JAX functions jitted, once per configuration). The dense gather in
3-D (and again in 2-D) is held by test_torch_cpic_dense.py on the CDF of
each substep it runs, at the same bounds.

The rasterize's rigid ids and colour tags are integer work and equal.
Its distance is a float32 element-frame coordinate quantized to 2^-20
grid units: XLA forms the frame's matrix-vector product in another
rounding than the port's products and sums (and jitted in another than
op by op), and the quantum is a quarter to an eighth of a float32 ulp of
the scaled distance, so a node's distance may sit one quantum off (a few
percent of the written nodes of the turned wheel). The gather's affinity bits
and near-boundary flags are equal, its boundary distance within 5e-6 dx
and its unit normal within 1e-5 (``port_helpers.assert_gather_close``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taichi_mpm_tpu.config import SimConfig as JConfig
from taichi_mpm_tpu.rigid import body as jbody
from taichi_mpm_tpu.rigid import cdf as jcdf
from taichi_mpm_tpu.rigid import mesh as jmesh
from taichi_mpm_tpu.rigid.scene import RigidSceneBuilder as JBuilder
from taichi_mpm_torch import convert
from taichi_mpm_torch.rigid import body as tbody
from taichi_mpm_torch.rigid import cdf as tcdf

from port_helpers import assert_gather_close, max_err, np_of

torch.set_num_threads(1)

DIST_QUANTUM = 2.0 ** -20  # grid units: the rasterize key's distance step


def _builder_2d(kind, res):
    """A 2-D rigid scene built by the JAX package: the scripted segment
    of tests/test_cpic.py::test_cdf_expand_dilates_2d_tags, or the
    scripts' 6-spoke wheel turned by 17 degrees."""
    b = JBuilder(2, 1.0 / res)
    if kind == "segment":
        b.add_rigid(jmesh.segment_mesh_2d((0.3, 0.5), (0.7, 0.5)), codimensional=True,
                    scripted_position=lambda t: (0.5, 0.5), scripted_rotation=lambda t: 0.0)
    else:
        b.add_rigid(jmesh.wheel_mesh_2d(radius=0.12, n_spokes=6, spoke_width=0.03),
                    codimensional=True, initial_position=(0.5, 0.45), initial_rotation=17.0)
    return b.build(())


def _world(bodies, scene):
    return jbody.boundary_particle_world(bodies, scene.bp_rid, scene.bp_offset,
                                         scene.bp_normal, scene.bp_elem)


def _port_world(bodies, scene):
    tb = convert.bodies_from_jax(bodies)
    return tbody.boundary_particle_world(
        tb, *(torch.as_tensor(np.array(getattr(scene, n))) for n in
              ("bp_rid", "bp_offset", "bp_normal", "bp_elem")))


@functools.lru_cache(maxsize=None)
def _rasterize_both(kind, res, expand):
    jcfg = JConfig(res=(res, res), gravity=(0, -10.0), cdf_expand=expand)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    bodies, scene = _builder_2d(kind, res)
    R = bodies.num
    xb, _, elem = _world(bodies, scene)
    jout = jax.jit(lambda x, e: jcdf.rasterize_rigid_boundary(x, e, scene.bp_rid, R, jcfg))(
        xb, elem)
    # the world frames within an ulp (cos and sin of the angle, see
    # test_torch_rigid_2d.py); the rasterize itself from the same points
    txb, _, telem = _port_world(bodies, scene)
    assert max_err(xb, txb) <= 1e-7 and max_err(elem, telem) <= 1e-7
    tout = tcdf.rasterize_rigid_boundary(torch.as_tensor(np.array(xb)),
                                         torch.as_tensor(np.array(elem)),
                                         torch.as_tensor(np.array(scene.bp_rid)), R, tcfg)
    return jcfg, tcfg, bodies, jout, tout


@pytest.mark.parametrize("expand", [0, 2])
@pytest.mark.parametrize("kind,res", [("segment", 32), ("wheel", 128)])
def test_rasterize_2d_matches_jax(kind, res, expand):
    """grid_rid and grid_states equal, grid_dist within one quantum, with
    and without two passes of the tag dilation."""
    jcfg, *_, jout, tout = _rasterize_both(kind, res, expand)
    for name, a, b in zip(("rid", "states"), jout[1:], tout[1:]):
        assert np.array_equal(np.asarray(a), np_of(b)), name
    assert int((np_of(tout[2]) != 0).sum()) > 0
    assert max_err(jout[0], tout[0]) <= DIST_QUANTUM * jcfg.dx * (1 + 1e-6)


def test_cdf_expand_dilates_2d_tags():
    """tests/test_cpic.py's check of the dilation on the port: more nodes
    tagged, every first-pass tag kept, the reach within Manhattan 4."""
    s0 = np_of(_rasterize_both("segment", 32, 0)[4][2])
    jcfg, _, _, _, tout = _rasterize_both("segment", 32, 2)
    s2 = np_of(tout[2])
    assert int((s2 != 0).sum()) > int((s0 != 0).sum())
    assert np.all((s0 & s2) == s0)
    g0 = (s0 != 0).reshape(jcfg.grid_nodes)
    g2 = (s2 != 0).reshape(jcfg.grid_nodes)
    grown = g0.copy()
    for _ in range(4):
        grown = (grown | np.roll(grown, 1, 0) | np.roll(grown, -1, 0)
                 | np.roll(grown, 1, 1) | np.roll(grown, -1, 1))
    assert np.all(~g2 | grown)


def _gather_both(jcfg, tcfg, R, planes, x, states):
    jout = jax.jit(lambda x, s, d, r, g: jcdf.gather_cdf(x, s, d, r, g, R, jcfg))(
        jnp.asarray(x), jnp.asarray(states), *(jnp.asarray(np.asarray(a)) for a in planes))
    tout = tcdf.gather_cdf(torch.as_tensor(x), torch.as_tensor(states),
                           *(torch.as_tensor(np.asarray(a)) for a in planes), R, tcfg)
    return jout, tout


@pytest.mark.parametrize("kind,res", [("segment", 32), ("wheel", 128)])
def test_gather_cdf_2d_matches_jax(kind, res):
    """Particles scattered over the rigid's band, with affinity bits from
    none to both sides: the same states, flags, distances and normals."""
    jcfg, tcfg, bodies, jplanes, _ = _rasterize_both(kind, res, 0)
    rng = np.random.default_rng(7)
    c = np.asarray(bodies.pos[1])
    x = (c + rng.uniform(-0.2, 0.2, (3000, 2))).astype(np.float32)
    states = rng.choice([0, 2, 3], 3000).astype(np.int32) << 2  # rigid 1's bits
    jout, tout = _gather_both(jcfg, tcfg, bodies.num, jplanes, x, states)
    assert_gather_close(jout, tout, jcfg.dx)
    assert int(np.asarray(jout[3]).sum()) > 20 and len(set(np.asarray(jout[0]).tolist())) > 2
