"""Port vs JAX: the rigid-body modules of the CPIC slice.

Same numpy inputs through both packages. Meshes, mass properties and
boundary-particle sampling are numpy in both and must be equal; the scene
build must give equal integers and floats within 1e-7; the body dynamics
(impulses, velocities, advance, the axis constraint), the articulations
and the rigid-rigid collision are float32 small-matrix algebra held to
1e-6 of their values' scale (the products and sums round in other orders
in XLA).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.core import levelset as jls
from taichi_mpm_tpu.math import quat as jquat
from taichi_mpm_tpu.rigid import articulation as jart
from taichi_mpm_tpu.rigid import body as jbody
from taichi_mpm_tpu.rigid import collision as jcoll
from taichi_mpm_tpu.rigid import mesh as jmesh
from taichi_mpm_tpu.rigid.scene import RigidSceneBuilder as JBuilder
from taichi_mpm_torch import convert
from taichi_mpm_torch.core import levelset as tls
from taichi_mpm_torch.math import quat as tquat
from taichi_mpm_torch.rigid import articulation as tart
from taichi_mpm_torch.rigid import body as tbody
from taichi_mpm_torch.rigid import collision as tcoll
from taichi_mpm_torch.rigid import mesh as tmesh
from taichi_mpm_torch.rigid.scene import RigidSceneBuilder as TBuilder

from port_helpers import WHEEL_CENTER, hub_wheel_kw, max_err, np_of

torch.set_num_threads(1)

MESHES = [
    ("paddle_wheel", dict()), ("paddle_wheel", dict(n_paddles=4, outer=0.18)),
    ("cylinder", dict(radius=0.04, half_height=0.06, n=16, axis=2)),
    ("plate", dict(half_u=0.25, half_v=0.25, axis=1)), ("box", dict(half_extents=(0.1, 0.05, 0.2))),
    ("sphere", dict(radius=0.1, subdiv=2)),
]


@pytest.mark.parametrize("name,kw", MESHES, ids=[f"{m}{i}" for i, (m, _) in enumerate(MESHES)])
def test_mesh_and_sampling_equal(name, kw):
    jm = getattr(jmesh, f"{name}_mesh")(**kw)
    tm = getattr(tmesh, f"{name}_mesh")(**kw)
    assert np.array_equal(jm, tm)
    for codim in (True, False) if name != "plate" else (True,):  # a plate has no volume
        for a, b in zip(jmesh.mass_properties(jm, 40.0, codim),
                        tmesh.mass_properties(tm, 40.0, codim)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jmesh.sample_boundary_particles(jm, 1 / 16),
                    tmesh.sample_boundary_particles(tm, 1 / 16)):
        assert np.array_equal(a, b)


def _scene_parts():
    """The CPIC benchmark's two bodies and a scripted plate, built by
    both packages."""
    out = []
    for B, mesh in ((JBuilder, jmesh), (TBuilder, tmesh)):
        b = B(3, 1 / 16)
        hub = b.add_rigid(mesh.cylinder_mesh(radius=0.04, half_height=0.06, n=16, axis=2),
                          **hub_wheel_kw())
        wheel = b.add_rigid(mesh.paddle_wheel_mesh(), **hub_wheel_kw())
        b.add_rigid(mesh.plate_mesh(half_u=0.1, half_v=0.1, axis=1),
                    scripted_position=lambda t: (0.5, 0.8, 0.5),
                    scripted_rotation=lambda t: (0.0, 0.0, 30.0), friction=0.3)
        b.add_articulation("rotation", hub, wheel)
        out.append(b)
    return out


def test_scene_build_matches_jax():
    jb, tb = _scene_parts()
    jbodies, jscene = jb.build()
    tbodies, tscene = tb.build()
    for f in dataclasses.fields(jbodies):
        assert max_err(getattr(jbodies, f.name), getattr(tbodies, f.name)) <= 1e-7, f.name
    assert np.array_equal(np.asarray(jscene.bp_rid), np_of(tscene.bp_rid))
    for name in ("bp_offset", "bp_normal", "bp_elem", "hull_verts"):
        assert max_err(getattr(jscene, name), getattr(tscene, name)) <= 1e-7, name
    assert jscene.collision.pairs == tscene.collision.pairs == ((1, 2), (1, 3), (2, 3))
    assert [a.kind for a in tscene.articulations] == ["rotation"]


def _random_bodies(seed, R=4):
    """Bodies with random state (rotated, spinning, finite and infinite
    masses, two of them axis-constrained)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(R, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    A = rng.normal(size=(R, 3, 3)).astype(np.float32)
    inertia_inv = (A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)) * 10
    vals = dict(
        pos=rng.uniform(0.3, 0.7, (R, 3)), vel=rng.normal(size=(R, 3)), rot=q,
        omega=rng.normal(size=(R, 3)) * 3, mass_inv=[0.0, 2.0, 0.0, 5.0],
        inertia_inv=inertia_inv, friction=rng.uniform(0, 0.5, (R, 2)),
        restitution=rng.uniform(0, 0.5, R), rotation_axis=[[0, 0, 0], [0, 0, 1], [0, 0, 0],
                                                           [1, 1, 0]],
        linear_damping=rng.uniform(0, 1, R), angular_damping=rng.uniform(0, 3, R))
    vals = {k: np.asarray(v, np.float32) for k, v in vals.items()}
    return jbody.RigidBodies(**{k: jnp.asarray(v) for k, v in vals.items()}), \
        tbody.RigidBodies(**{k: torch.as_tensor(v) for k, v in vals.items()})


def _assert_bodies_close(jb, tb, rel=1e-6):
    for f in dataclasses.fields(jb):
        a = np.asarray(getattr(jb, f.name))
        scale = max(1.0, float(np.abs(a).max()))
        assert max_err(a, getattr(tb, f.name)) <= rel * scale, f.name


def test_body_impulses_and_velocities():
    jb, tb = _random_bodies(0)
    rng = np.random.default_rng(1)
    n = 300
    rid = rng.integers(-1, 4, n).astype(np.int32)
    x = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    J = rng.normal(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7
    jr, tr = jnp.asarray(np.clip(rid, 0, 3)), torch.as_tensor(np.clip(rid, 0, 3)).long()
    assert max_err(jbody.velocity_at(jb, jr, jnp.asarray(x)),
                   tbody.velocity_at(tb, tr, torch.as_tensor(x))) <= 1e-6
    assert max_err(jbody.velocity_at_masked(jb, jnp.asarray(rid), jnp.asarray(x)),
                   tbody.velocity_at_masked(tb, torch.as_tensor(rid), torch.as_tensor(x))) <= 1e-6
    for jf, tf, r in ((jbody.accumulate_impulses, tbody.accumulate_impulses, np.clip(rid, 0, 3)),
                      (jbody.accumulate_impulses_masked, tbody.accumulate_impulses_masked, rid)):
        jo = jf(jb, jnp.asarray(r), jnp.asarray(J), jnp.asarray(x), jnp.asarray(valid))
        to = tf(tb, torch.as_tensor(r), torch.as_tensor(J), torch.as_tensor(x),
                torch.as_tensor(valid))
        for a, b in zip(jo, to):
            assert max_err(a, b) <= 1e-5 * max(1.0, float(np.abs(np.asarray(a)).max()))
        _assert_bodies_close(jbody.apply_impulses(jb, *jo), tbody.apply_impulses(tb, *to))


def test_body_advance_with_scripts():
    jb, tb = _random_bodies(2)
    # both packages call the scripts with float32 values, so a script that
    # is not exact in float32 (0.4 + t, a factor 60) rounds alike in both,
    # and the forward differences (ulp / dt) agree
    pos_funcs = (None, None, lambda t: (0.5, 0.4 + t, 0.5), None)
    rot_funcs = (None, None, lambda t: (0.0, 8.0 * t, 20.0 + 60.0 * t), None)
    for step in range(3):
        t = np.float32(step * 2e-4)
        jb = jbody.advance(jb, jnp.float32(t), 2e-4, pos_funcs, rot_funcs, (0.0, -10.0, 0.0))
        tb = tbody.advance(tb, t, 2e-4, pos_funcs, rot_funcs, (0.0, -10.0, 0.0))
    _assert_bodies_close(jb, tb)


def test_quaternions():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    e = rng.uniform(-3, 3, (50, 3)).astype(np.float32)
    pairs = [
        (jquat.quat_mul(q, q[::-1]),
         tquat.quat_mul(torch.as_tensor(q), torch.as_tensor(q[::-1].copy()))),
        (jquat.quat_to_mat(q), tquat.quat_to_mat(torch.as_tensor(q))),
        (jquat.quat_rotate(q, v), tquat.quat_rotate(torch.as_tensor(q), torch.as_tensor(v))),
        (jquat.quat_from_euler_xyz(e), tquat.quat_from_euler_xyz(torch.as_tensor(e))),
        (jquat.quat_integrate(q, v, 1e-3),
         tquat.quat_integrate(torch.as_tensor(q), torch.as_tensor(v), 1e-3)),
    ]
    for a, b in pairs:
        assert max_err(a, b) <= 2e-6


def test_friction_project_dense_form():
    """All friction encodings, including a zero tangential velocity (the
    1e-30 divisor of the dense form)."""
    rng = np.random.default_rng(4)
    n = 400
    v = rng.normal(size=(n, 3)).astype(np.float32)
    base = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    v[:20] = base[:20] + 2.0 * nrm[:20]  # no tangential part
    fric = rng.choice([-1.0, -2.0, -2.5, 0.0, 0.3], n).astype(np.float32)
    a = jls.friction_project(jnp.asarray(v), jnp.asarray(base), jnp.asarray(nrm), jnp.asarray(fric))
    b = tls.friction_project(*(torch.as_tensor(t) for t in (v, base, nrm, fric)))
    assert max_err(a, b) <= 1e-6


@pytest.mark.parametrize("kind", ["rotation", "frozen", "distance", "axial_rotation", "motor",
                                  "stepper"])
def test_articulations(kind):
    jb, tb = _random_bodies(5)
    np_b = {"pos": np.asarray(jb.pos), "rot": np.asarray(jb.rot)}
    kw = dict(offset0=(0.05, 0.0, 0.02), axis=(0.0, 0.3, 1.0), power=2.0, angular_velocity=1.5)
    if kind in ("rotation", "frozen"):
        kw = {}
    elif kind == "distance":
        kw = dict(offset0=(0.05, 0.0, 0.02), offset1=(0.0, 0.1, 0.0))
    ja = (jart.build_articulation(kind, 1, 3, np_b, 3, **kw),)
    ta = (tart.build_articulation(kind, 1, 3, np_b, 3, **kw),)
    assert dataclasses.asdict(ja[0]) == dataclasses.asdict(ta[0])
    # a lone articulation of these kinds takes one projection pass, the
    # others 100; the chain of two takes 100 either way
    _assert_bodies_close(jart.articulate(jb, ja, 2e-4), tart.articulate(tb, ta, 2e-4))
    if kind == "rotation":
        chain_j = ja + (jart.build_articulation("frozen", 2, 0, np_b, 3),)
        chain_t = ta + (tart.build_articulation("frozen", 2, 0, np_b, 3),)
        _assert_bodies_close(jart.articulate(jb, chain_j, 2e-4, iterations=7),
                             tart.articulate(tb, chain_t, 2e-4, iterations=7))


def test_hub_wheel_rigidify_and_rotation():
    """The CPIC benchmark's two free-rotating bodies (a colliding pair),
    turned and spinning: detect, rigidify and the rotation articulation,
    as the prologue runs them; then the level-set collision of their
    boundary particles against a floor through the wheel."""
    jb_, tb_ = _scene_parts()
    jbodies, jscene = jb_.build()
    tbodies, tscene = tb_.build()
    rng = np.random.default_rng(6)
    q = np.array([[1, 0, 0, 0], [0.99, 0.1, 0.05, 0.02], [0.98, -0.1, 0.1, 0.1], [1, 0, 0, 0]],
                 np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    omega = rng.normal(0, 2, (4, 3)).astype(np.float32)
    jbodies = dataclasses.replace(jbodies, rot=jnp.asarray(q), omega=jnp.asarray(omega))
    tbodies = tbodies.replace(rot=torch.as_tensor(q), omega=torch.as_tensor(omega))
    jdirs = jnp.asarray(jcoll.icosphere_directions())
    tdirs = tcoll.icosphere_directions()
    assert np.array_equal(np.asarray(jdirs), tdirs)
    jd = jcoll.detect(jbodies, jscene.hull_verts, jscene.collision.pairs, jdirs)
    td = tcoll.detect(tbodies, tscene.hull_verts_host(), tscene.collision.pairs, tdirs)
    assert np.array_equal(np.asarray(jd[0]), np_of(td[0]))
    assert np.array_equal(np.asarray(jd[2]), np_of(td[2]))  # same sampled normal
    for a, b in zip(jd[1:], td[1:]):
        assert max_err(a, b) <= 1e-6
    jb = jcoll.rigidify(jbodies, jscene.hull_verts, jscene.collision, jdirs, 2e-4)
    tb = tcoll.rigidify(tbodies, tscene.hull_verts_host(), tscene.collision, tdirs, 2e-4)
    _assert_bodies_close(jb, tb)
    jb = jart.articulate(jb, jscene.articulations, 2e-4)
    tb = tart.articulate(tb, tscene.articulations, 2e-4)
    _assert_bodies_close(jb, tb)
    assert np.allclose(np_of(tb.omega[1]), np_of(tb.omega[2]))  # hub and wheel share omega

    jx, _, _ = jbody.boundary_particle_world(jb, jscene.bp_rid, jscene.bp_offset,
                                             jscene.bp_normal, jscene.bp_elem)
    tx, _, _ = tbody.boundary_particle_world(tb, tscene.bp_rid, tscene.bp_offset,
                                             tscene.bp_normal, tscene.bp_elem)
    assert max_err(jx, tx) <= 1e-6
    jfloor = (jls.plane((0.0, 0.3, 0.0), (0.0, 1.0, 0.0)),)
    tfloor = (tls.plane((0.0, 0.3, 0.0), (0.0, 1.0, 0.0)),)
    jb = dataclasses.replace(jb, restitution=jnp.full((4,), 0.3, jnp.float32))
    tb = tb.replace(restitution=torch.full((4,), 0.3))
    _assert_bodies_close(
        jcoll.rigid_levelset_collision(jb, jx, jscene.bp_rid, jfloor, 0.0, 2e-4),
        tcoll.rigid_levelset_collision(tb, tx, tscene.bp_rid, tfloor, 0.0, 2e-4))


@pytest.mark.parametrize("n", [1, 7, 32, 33, 34, 100, 512, 600])
def test_xla_sum_order(n):
    """collision.xla_sum adds in XLA's CPU order: equal bits to a jitted
    jnp.sum over the middle axis."""
    import jax

    a = (np.random.default_rng(n).standard_normal((2, n, 3)) + 0.4).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jnp.sum(x, 1))(jnp.asarray(a)))
    assert np.array_equal(tcoll.xla_sum(a, 1), want)


def test_detect_witness_of_turned_hub_wheel():
    """The CPIC benchmark's hub and wheel (a degenerate contact: its
    effective inverse mass is 0) turned about their axis as after two
    dense CPIC substeps: the witness point is JAX's to the bit (one ulp
    off the axis), so rigidify's ~1e28 impulse gives JAX's angular
    velocities."""
    from port_helpers import jax_hub_wheel_scene

    sim = jax_hub_wheel_scene()
    q = np.array([[1, 0, 0, 0], [0.99999958, 0, 0, 9.3863427e-04],
                  [1.0, 0, 0, -1.2365292e-04]], np.float32)
    omega = np.array([[0, 0, 0], [0, 0, 2.9856822], [0, 0, -0.6311019]], np.float32)
    jb = dataclasses.replace(sim.bodies, rot=jnp.asarray(q), omega=jnp.asarray(omega))
    tb = convert.bodies_from_jax(jb)
    sc, ts = sim.rigid_scene, convert.scene_from_jax(sim.rigid_scene)
    dirs = tcoll.icosphere_directions()
    jd = jcoll.detect(jb, sc.hull_verts, sc.collision.pairs, jnp.asarray(dirs))
    td = tcoll.detect(tb, ts.hull_verts_host(), ts.collision.pairs, dirs)
    assert np.array_equal(np.asarray(jd[3]), td[3]) and float(td[3][0, 1]) != 0.4
    _assert_bodies_close(jcoll.rigidify(jb, sc.hull_verts, sc.collision, jnp.asarray(dirs), 2e-4),
                         tcoll.rigidify(tb, ts.hull_verts_host(), ts.collision, dirs, 2e-4))


def test_convert_round_trip():
    jb_, _ = _scene_parts()
    jbodies, jscene = jb_.build()
    tb = convert.bodies_from_jax(jbodies)
    ts = convert.scene_from_jax(jscene)
    _assert_bodies_close(jbodies, tb, rel=0.0)
    assert ts.collision.pairs == jscene.collision.pairs
    assert ts.pos_funcs[1](0.0) == WHEEL_CENTER


def test_friction_of_both_forms_match_jax():
    """The side-dependent friction of a node's owner body: the indexed
    and the masked form of both packages give the same values."""
    from taichi_mpm_tpu.rigid import cpic as jcpic
    from taichi_mpm_torch.rigid import cpic as tcpic

    jb, tb = _random_bodies(7)
    rng = np.random.default_rng(8)
    rid = rng.integers(-1, 4, 500).astype(np.int32)
    states = rng.integers(0, 256, 500).astype(np.int32)
    want = np.asarray(jcpic._friction_of(jb, jnp.asarray(rid), jnp.asarray(states)))
    assert np.array_equal(want, np.asarray(
        jcpic._friction_of_masked(jb, jnp.asarray(rid), jnp.asarray(states))))
    for fn in (tcpic._friction_of, tcpic._friction_of_masked):
        assert np.array_equal(want, np_of(fn(tb, torch.as_tensor(rid), torch.as_tensor(states))))
