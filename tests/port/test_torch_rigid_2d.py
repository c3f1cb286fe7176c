"""Port vs JAX: the 2-D rigid bodies of the dense CPIC slice.

Same numpy inputs through both packages. ``rot2d``'s cos and sin: XLA's
float32 cos and sin on the CPU are not torch's, and the port takes them
in float64 rounded to float32; the test measures how often and by how
much they differ from XLA's and bounds it (one ulp, on at most 2% of the
angles). The 2-D body functions, the scene build and the articulations
are float32 scalar algebra held to 1e-6 of their values' scale (a body's
angle goes through cos and sin); the scene build's integers and angles
are equal, its floats within 1e-7.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.math import quat as jquat
from taichi_mpm_tpu.rigid import articulation as jart
from taichi_mpm_tpu.rigid import body as jbody
from taichi_mpm_tpu.rigid import mesh as jmesh
from taichi_mpm_tpu.rigid.scene import RigidSceneBuilder as JBuilder
from taichi_mpm_torch.math import quat as tquat
from taichi_mpm_torch.rigid import articulation as tart
from taichi_mpm_torch.rigid import body as tbody
from taichi_mpm_torch.rigid import mesh as tmesh
from taichi_mpm_torch.rigid.scene import RigidSceneBuilder as TBuilder

from port_helpers import max_err, np_of

torch.set_num_threads(1)

# the share of float32 angles in [-10, 10] whose cos or sin differs from
# XLA's (measured 1.3%), and by how many ulps at most
COS_SIN_SHARE, COS_SIN_ULPS = 0.02, 1


def test_rot2d_cos_sin_against_xla():
    """cos and sin of 200,000 angles: within one ulp of XLA's everywhere,
    and different on at most 2% of them; rot2d then within two ulps of
    the vectors' scale."""
    a = np.random.default_rng(0).uniform(-10, 10, 200_000).astype(np.float32)
    c, s = tquat.cos_sin(torch.as_tensor(a))
    worst, share = 0.0, 0.0
    for port, ref in ((c, jnp.cos(a)), (s, jnp.sin(a))):
        port, ref = np_of(port), np.asarray(ref)
        ulps = np.abs(port.astype(np.float64) - ref) / np.spacing(np.abs(ref))
        worst = max(worst, float(ulps.max()))
        share = max(share, float(np.mean(port != ref)))
    assert worst <= COS_SIN_ULPS and share <= COS_SIN_SHARE, (worst, share)
    v = np.random.default_rng(1).normal(size=(200_000, 2)).astype(np.float32)
    err = max_err(jquat.rot2d(a[:, None], v), tquat.rot2d(torch.as_tensor(a[:, None]),
                                                           torch.as_tensor(v)))
    assert err <= 2 * np.spacing(np.float32(np.abs(v).max())), err


def _random_bodies(seed, R=4):
    """2-D bodies: angles, spins, finite and infinite masses."""
    rng = np.random.default_rng(seed)
    vals = dict(
        pos=rng.uniform(0.3, 0.7, (R, 2)), vel=rng.normal(size=(R, 2)),
        rot=rng.uniform(-3, 3, (R, 1)), omega=rng.normal(size=(R, 1)) * 3,
        mass_inv=[0.0, 2.0, 0.0, 5.0], inertia_inv=[[0.0], [40.0], [7.0], [120.0]],
        friction=rng.uniform(0, 0.5, (R, 2)), restitution=rng.uniform(0, 0.5, R),
        rotation_axis=np.zeros((R, 3)), linear_damping=rng.uniform(0, 1, R),
        angular_damping=rng.uniform(0, 3, R))
    vals = {k: np.asarray(v, np.float32) for k, v in vals.items()}
    return jbody.RigidBodies(**{k: jnp.asarray(v) for k, v in vals.items()}), \
        tbody.RigidBodies(**{k: torch.as_tensor(v) for k, v in vals.items()})


def _assert_bodies_close(jb, tb, rel=1e-6):
    for f in dataclasses.fields(jb):
        a = np.asarray(getattr(jb, f.name))
        assert getattr(tb, f.name).shape == a.shape, f.name
        scale = max(1.0, float(np.abs(a).max()))
        assert max_err(a, getattr(tb, f.name)) <= rel * scale, f.name


def test_body_functions_2d():
    """rotate, the scalar inverse inertia, omega x r, velocity_at (both
    forms), the torque, the impulse sums (both forms), apply_impulses,
    impulse_contribution, the axis constraint (a no-op in 2-D) and the
    boundary particles' world frame."""
    jb, tb = _random_bodies(0)
    rng = np.random.default_rng(1)
    n = 300
    rid = rng.integers(-1, 4, n).astype(np.int32)
    x = rng.uniform(0.2, 0.8, (n, 2)).astype(np.float32)
    J = rng.normal(size=(n, 2)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7
    r = np.clip(rid, 0, 3)
    jr, tr = jnp.asarray(r), torch.as_tensor(r).long()
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    assert max_err(jbody.rotate(jb.rot[jr], jx), tbody.rotate(tb.rot[tr], tx)) <= 1e-6
    assert max_err(jbody.world_inertia_inv(jb), tbody.world_inertia_inv(tb)) == 0.0
    assert max_err(jbody.cross_omega(jb.omega[jr], jx), tbody.cross_omega(tb.omega[tr], tx)) == 0.0
    assert max_err(jbody._torque_of(jx, jnp.asarray(J)),
                   tbody._torque_of(tx, torch.as_tensor(J))) == 0.0
    assert max_err(jbody.velocity_at(jb, jr, jx), tbody.velocity_at(tb, tr, tx)) <= 1e-6
    assert max_err(jbody.velocity_at_masked(jb, jnp.asarray(rid), jx),
                   tbody.velocity_at_masked(tb, torch.as_tensor(rid), tx)) <= 1e-6
    d = rng.normal(size=(n, 2)).astype(np.float32)
    assert max_err(jbody.impulse_contribution(jb, jr, jx - jb.pos[jr], jnp.asarray(d)),
                   tbody.impulse_contribution(tb, tr, tx - tb.pos[tr], torch.as_tensor(d))) <= 1e-5
    for jf, tf, ids in ((jbody.accumulate_impulses, tbody.accumulate_impulses, r),
                        (jbody.accumulate_impulses_masked, tbody.accumulate_impulses_masked, rid)):
        jo = jf(jb, jnp.asarray(ids), jnp.asarray(J), jx, jnp.asarray(valid))
        to = tf(tb, torch.as_tensor(ids), torch.as_tensor(J), tx, torch.as_tensor(valid))
        for a, b in zip(jo, to):
            assert b.shape == a.shape
            assert max_err(a, b) <= 1e-5 * max(1.0, float(np.abs(np.asarray(a)).max()))
        _assert_bodies_close(jbody.apply_impulses(jb, *jo), tbody.apply_impulses(tb, *to))
    _assert_bodies_close(jbody.enforce_rotation_axis(jb), tbody.enforce_rotation_axis(tb))
    elem = rng.normal(size=(n, 2, 2)).astype(np.float32)
    for a, b in zip(jbody.boundary_particle_world(jb, jr, jx, jnp.asarray(d), jnp.asarray(elem)),
                    tbody.boundary_particle_world(tb, tr, tx, torch.as_tensor(d),
                                                  torch.as_tensor(elem))):
        assert max_err(a, b) <= 1e-6


def test_body_advance_2d():
    """The damped advance (rot += dt omega), gravity on the finite bodies,
    scripted positions and a scripted angle in degrees with their forward
    differences (power-of-two scripts, exact in float32 and in double)."""
    jb, tb = _random_bodies(2)
    pos_funcs = (None, None, lambda t: (0.5, 0.25 + 2.0 * t), None)
    rot_funcs = (None, None, lambda t: 20.0 + 64.0 * t, lambda t: 0.0)
    for step in range(3):
        t = np.float32(step * 2e-4)
        jb = jbody.advance(jb, jnp.float32(t), 2e-4, pos_funcs, rot_funcs, (0.0, -10.0))
        tb = tbody.advance(tb, t, 2e-4, pos_funcs, rot_funcs, (0.0, -10.0))
    _assert_bodies_close(jb, tb)


def _scene(B, mesh):
    b = B(2, 1 / 32)
    b.add_rigid(mesh.wheel_mesh_2d(radius=0.12, n_spokes=6, spoke_width=0.03),
                codimensional=True, friction=0.3, density=5.0,
                scripted_position=lambda t: (0.5, 0.45))
    b.add_rigid(mesh.polygon_mesh_2d([[-0.05, -0.1], [0.05, -0.1], [0.05, 0.1], [-0.05, 0.1]]),
                initial_position=(0.7, 0.5), initial_rotation=30.0,
                initial_angular_velocity=2.0, codimensional=False, density=500, friction0=0.1,
                friction1=0.4, linear_damping=0.5)
    b.add_rigid(mesh.segment_mesh_2d((-0.2, 0.0), (0.2, 0.0)),
                scripted_position=lambda t: (0.3, 0.3), scripted_rotation=lambda t: 15.0)
    return b


def test_scene_build_2d():
    """Three bodies (a scripted-position wheel, a solid rotated box with
    an initial spin, a fully scripted segment): the same arrays, the
    angle in radians from degrees, the scalar inverse inertias, no
    rigid-rigid collision (2-D)."""
    jbodies, jscene = _scene(JBuilder, jmesh).build()
    tbodies, tscene = _scene(TBuilder, tmesh).build()
    for f in dataclasses.fields(jbodies):
        a = np.asarray(getattr(jbodies, f.name))
        assert getattr(tbodies, f.name).shape == a.shape, f.name
        assert max_err(a, getattr(tbodies, f.name)) <= 1e-7 * max(1.0, np.abs(a).max()), f.name
    assert np.array_equal(np.asarray(jbodies.rot), np_of(tbodies.rot))
    assert np.array_equal(np.asarray(jscene.bp_rid), np_of(tscene.bp_rid))
    for name in ("bp_offset", "bp_normal", "bp_elem", "hull_verts"):
        assert max_err(getattr(jscene, name), getattr(tscene, name)) <= 1e-7, name
    assert jscene.collision is None and tscene.collision is None


@pytest.mark.parametrize("kind", ["rotation", "frozen", "distance", "axial_rotation", "motor",
                                  "stepper"])
def test_articulations_2d(kind):
    """Each kind between two free bodies (and, for rotation, a chain with
    a frozen one): the body-frame parameters equal and the articulated
    velocities within 1e-6 of their scale."""
    jb, tb = _random_bodies(5)
    np_b = {"pos": np.asarray(jb.pos), "rot": np.asarray(jb.rot)}
    kw = dict(offset0=(0.05, 0.02), power=2.0, angular_velocity=1.5)
    if kind in ("rotation", "frozen"):
        kw = {}
    elif kind == "distance":
        kw = dict(offset0=(0.05, 0.02), offset1=(0.0, 0.1))
    ja = (jart.build_articulation(kind, 1, 3, np_b, 2, **kw),)
    ta = (tart.build_articulation(kind, 1, 3, np_b, 2, **kw),)
    assert dataclasses.asdict(ja[0]) == dataclasses.asdict(ta[0])
    _assert_bodies_close(jart.articulate(jb, ja, 2e-4), tart.articulate(tb, ta, 2e-4))
    if kind == "rotation":
        chain_j = ja + (jart.build_articulation("frozen", 2, 0, np_b, 2),)
        chain_t = ta + (tart.build_articulation("frozen", 2, 0, np_b, 2),)
        _assert_bodies_close(jart.articulate(jb, chain_j, 2e-4, iterations=7),
                             tart.articulate(tb, chain_t, 2e-4, iterations=7))
