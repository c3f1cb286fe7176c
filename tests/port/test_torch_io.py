"""Port vs JAX: BGEO output and checkpoints.

BGEO: the port's native writer and its numpy twin write the JAX
package's bytes for the same arrays (with attributes, 2-D embedded in
z = 0, more than 2^16 points with int indices, none at all), read back
exactly; a native writer that cannot be built raises and names the numpy
writer. Checkpoints: each package resumes the other's snapshot (the same
npz format): the loaded arrays equal the saved ones exactly, and one
6-substep frame from them (the port's ``MPM.step``; JAX's
``packed_frame`` with its Pallas kernels in interpret mode) stays within
the bounds of ``tests/test_fused.py`` (x 5e-6, v 5e-5, F 5e-6, C 5e-4,
aux 5e-6), with the same time. Two scenes that load one snapshot give the
same bits (a resume restarts the lazy sort, so it is held to a resume,
not to the run it was cut from). A snapshot larger than the scene raises;
into a larger scene it resumes with the same bits. A CPIC scene's
snapshot carries its bodies across both ways, and the frame output of a
CPIC scene (the rigid meshes as OBJ, the grid and particle CDF dumps, the
verbose BGEO) equals JAX's on the same state."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.core import levelset as jls
from taichi_mpm_tpu.core.solver import MPM as JMPM
from taichi_mpm_tpu.io import bgeo as jbgeo
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_tpu.rigid.mesh import plate_mesh
from taichi_mpm_torch import MPM as TMPM
from taichi_mpm_torch import convert
from taichi_mpm_torch.core import levelset as tls
from taichi_mpm_torch.io import bgeo as tbgeo

from port_helpers import (
    BODY_BOUNDS, CPIC_BOUNDS, FRAME_BOUNDS, assert_close_by_id, assert_frame_close,
    jax_plate_scene, max_err, np_of, scene_arrays, tag_ids,
)

torch.set_num_threads(1)


# -- BGEO ---------------------------------------------------------------------


def _bgeo_cases():
    rng = np.random.default_rng(7)
    return {
        "attributes": (rng.random((1000, 3)).astype(np.float32),
                       {"v": rng.normal(size=(1000, 3)).astype(np.float32),
                        "mass": rng.random(1000).astype(np.float32),
                        "pair": rng.random((1000, 2)).astype(np.float32)}),
        "2d": (rng.random((10, 2)).astype(np.float32), None),
        "int_indices": (rng.random(((1 << 16) + 10, 3)).astype(np.float32),
                        {"id": np.arange((1 << 16) + 10, dtype=np.float32)}),
        "empty": (np.zeros((0, 3), np.float32), {}),
    }


@pytest.mark.parametrize("writer", tbgeo.WRITERS)
@pytest.mark.parametrize("case", list(_bgeo_cases()))
def test_bgeo_bytes_match_jax(tmp_path, writer, case):
    pos, attrs = _bgeo_cases()[case]
    jbgeo.write_bgeo(str(tmp_path / "j.bgeo"), pos, attrs)
    tbgeo.write_bgeo(str(tmp_path / "t.bgeo"), pos, attrs, writer=writer)
    assert (tmp_path / "t.bgeo").read_bytes() == (tmp_path / "j.bgeo").read_bytes()
    rpos, rattrs = tbgeo.read_bgeo(str(tmp_path / "t.bgeo"))
    assert rpos.shape == (len(pos), 3)
    assert np.array_equal(rpos[:, :pos.shape[1]], pos) and not rpos[:, pos.shape[1]:].any()
    for name, a in (attrs or {}).items():
        assert np.array_equal(rattrs[name], a), name


def test_bgeo_native_build_failure_raises(tmp_path, monkeypatch):
    broken = tmp_path / "bgeo.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tbgeo, "SOURCE", broken)
    monkeypatch.setattr(tbgeo, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tbgeo, "_native", None)
    pos = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="writer='numpy'"):
        tbgeo.write_bgeo(str(tmp_path / "a.bgeo"), pos)
    assert not (tmp_path / "a.bgeo").exists()
    tbgeo.write_bgeo(str(tmp_path / "a.bgeo"), pos, writer="numpy")
    assert np.array_equal(tbgeo.read_bgeo(str(tmp_path / "a.bgeo"))[0], pos)
    with pytest.raises(ValueError, match="writer"):
        tbgeo.write_bgeo(str(tmp_path / "b.bgeo"), pos, writer="python")


# -- checkpoints of plain scenes ------------------------------------------------

N_SUB, BASE_DT, K = 6, 2e-4, 192
LO, HI = (0.12,) * 3, (0.88,) * 3
JCOL = (jls.box_domain(LO, HI, friction=-1.0),)


def _scene(cls, a, capacity=None, **kw):
    n = int(a["active"].sum())
    sim = cls(res=(32, 32, 32), base_delta_t=BASE_DT, frame_dt=N_SUB * BASE_DT,
              capacity=capacity or a["x"].shape[0], **kw)
    sim.add_particles("jelly", pos=a["x"][:n], vel=a["v"][:n], mass=1e-3, vol=1e-6)
    sim.add_collider((tls if cls is TMPM else jls).box_domain(LO, HI, friction=-1.0))
    return sim


def _port_scene(a, **kw):
    return _scene(TMPM, a, device="cpu", **kw)


def _jax_frame(jsim):
    """JAX's resume: its blocked fused frame (interpret mode) from the
    loaded scene's particles and time."""
    jp, jt, _, _, _ = jpacked.packed_frame(jsim.particles, jnp.asarray(jsim.t, jnp.float32),
                                           jsim.cfg, JCOL, BASE_DT, N_SUB, K,
                                           interpret=True, fused=True)
    return jp, np.float32(jt)


def _assert_same_arrays(p, q):
    a, b = convert.particles_to_numpy(p), convert.particles_to_numpy(q)
    for name in a:
        assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name


@pytest.fixture(scope="module")
def arrays():
    return scene_arrays(1200, seed=61)[0]


def test_each_package_resumes_the_others_snapshot(tmp_path, arrays):
    a = arrays
    jsim = _scene(JMPM, a)
    jsim._finalize()
    jsim.t = jnp.float32(3 * BASE_DT)
    jsim.save(str(tmp_path / "jax.npz"))
    jt = np.float32(jsim.t)

    # the port resumes JAX's snapshot, twice with the same bits
    ports = [_port_scene(a) for _ in range(2)]
    for sim in ports:
        sim.load(str(tmp_path / "jax.npz"))
        _assert_same_arrays(sim.particles, jsim.particles)
        assert sim.t == jt
        sim.step()
    _assert_same_arrays(*[sim.particles for sim in ports])
    # against JAX's resume of its own snapshot
    jsim2 = _scene(JMPM, a)
    jsim2.load(str(tmp_path / "jax.npz"))
    jp, jt2 = _jax_frame(jsim2)
    assert ports[0].t == jt2
    assert_frame_close(jp, ports[0].particles, FRAME_BOUNDS)

    # JAX resumes the port's snapshot
    ports[0].save(str(tmp_path / "port.npz"))
    jsim3 = _scene(JMPM, a)
    jsim3.load(str(tmp_path / "port.npz"))
    _assert_same_arrays(jsim3.particles, ports[0].particles)
    assert np.float32(jsim3.t) == ports[0].t and jsim3.frame_dt == ports[0].frame_dt
    jp3, jt3 = _jax_frame(jsim3)
    tsim = _port_scene(a)
    tsim.load(str(tmp_path / "port.npz"))
    tsim.step()
    assert tsim.t == jt3
    assert_frame_close(jp3, tsim.particles, FRAME_BOUNDS)


def test_snapshot_capacity_rules(tmp_path, arrays):
    a = arrays
    sim = _port_scene(a)
    sim.step()
    sim.save(str(tmp_path / "s.npz"))
    sim.step()
    for small in (TMPM(res=(32, 32, 32), device="cpu"), JMPM(res=(32, 32, 32))):
        small.add_particles("jelly", pos=np.full((5, 3), 0.5, np.float32))
        with pytest.raises(ValueError, match="capacity"):
            small.load(str(tmp_path / "s.npz"))

    cap = a["x"].shape[0]
    same, grown = _port_scene(a), _port_scene(a, capacity=2 * cap)
    for s in (same, grown):
        s.load(str(tmp_path / "s.npz"))
        s.step()
    assert grown.particles.capacity == 2 * cap
    assert grown.particles.count() == sim.particles.count() == 1200
    assert not grown.particles.active[cap:].any()
    assert np.array_equal(grown.positions(), same.positions())
    assert np.array_equal(grown.velocities(), same.velocities())


# -- CPIC scenes -------------------------------------------------------------------


def _port_plate_scene(seed=3, n=220, vel=(0.0, -0.5, 0.0)):
    """port_helpers.jax_plate_scene, built by the port."""
    rng = np.random.default_rng(seed)
    sim = TMPM(res=(16, 16, 16), base_delta_t=2e-4, gravity=(0, -10.0, 0), penalty=1e3,
               device="cpu")
    pos = rng.uniform(0.3, 0.7, size=(n, 3)).astype(np.float32)
    sim.add_particles("jelly", pos=pos, vel=vel, E=1e4, nu=0.3, density=1000)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.25, half_v=0.25, axis=1),
                      scripted_position=lambda t: (0.5, 0.45, 0.5),
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0),
                      codimensional=True, friction=0.2)
    sim.frame_dt = 4 * sim.cfg.base_dt
    return sim


def _assert_same_bodies(b, c):
    from taichi_mpm_torch.rigid.body import BODY_FIELDS

    for name in BODY_FIELDS:
        assert np.array_equal(np_of(getattr(b, name)), np_of(getattr(c, name))), name


@pytest.fixture(scope="module")
def cpic_states(tmp_path_factory):
    """JAX's plate scene saved by JAX, resumed by the port and stepped one
    CPIC frame, and that state saved by the port."""
    d = tmp_path_factory.mktemp("cpic")
    jsim = jax_plate_scene()
    params = tag_ids(convert.particles_to_numpy(jsim.particles))["params"]
    jsim.particles = dataclasses.replace(jsim.particles, params=jnp.asarray(params))
    jsim.save(str(d / "jax.npz"))
    tsim = _port_plate_scene()
    tsim.load(str(d / "jax.npz"))
    _assert_same_arrays(tsim.particles, jsim.particles)
    _assert_same_bodies(tsim.bodies, jsim.bodies)
    tsim.step()
    tsim.save(str(d / "port.npz"))
    return d, tsim


def test_cpic_snapshot_with_bodies(cpic_states):
    d, tsim = cpic_states
    assert int(tsim.particles.states.ne(0).sum()) > 0  # the coupling acted
    resumed = [_port_plate_scene() for _ in range(2)]
    for sim in resumed:
        sim.load(str(d / "port.npz"))
        _assert_same_bodies(sim.bodies, tsim.bodies)
        sim.step()
    _assert_same_arrays(*[s.particles for s in resumed])
    _assert_same_bodies(*[s.bodies for s in resumed])
    ref = _port_plate_scene()  # the uninterrupted run, one frame further
    ref.load(str(d / "jax.npz"))
    ref.step()
    ref.step()
    assert_close_by_id(ref.particles, resumed[0].particles, CPIC_BOUNDS,
                       equal=("states", "near_b"))
    for name, bound in BODY_BOUNDS.items():
        assert max_err(getattr(ref.bodies, name), getattr(resumed[0].bodies, name)) <= bound
    jsim = jax_plate_scene()
    jsim.load(str(d / "port.npz"))
    _assert_same_arrays(jsim.particles, tsim.particles)
    _assert_same_bodies(jsim.bodies, tsim.bodies)


def _read_obj(path):
    lines = path.read_text().splitlines()
    v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
    f = [ln for ln in lines if ln.startswith("f ")]
    return v, f


def test_frame_output_matches_jax(tmp_path, cpic_states):
    """visualize (verbose, with the rigid meshes), visualize_cdf and
    visualize_particle_cdf of the port's CPIC state against JAX's on the
    same state (JAX's scene loads the port's snapshot)."""
    d, tsim = cpic_states
    jsim = jax_plate_scene()
    jsim.load(str(d / "port.npz"))
    for sim, tag in ((jsim, "j"), (tsim, "t")):
        sim.visualize(str(tmp_path / f"{tag}.bgeo"), verbose=True)
        sim.visualize_particle_cdf(str(tmp_path / f"{tag}_pcdf.bgeo"))
        sim.visualize_cdf(str(tmp_path / f"{tag}_cdf.bgeo"))
    for name in ("", "_pcdf"):
        assert (tmp_path / f"t{name}.bgeo").read_bytes() == (tmp_path / f"j{name}.bgeo").read_bytes()
    assert len(tbgeo.read_bgeo(str(tmp_path / "t_pcdf.bgeo"))[0]) > 0
    jv, jf = _read_obj(tmp_path / "j_rigid_1.obj")
    tv, tf = _read_obj(tmp_path / "t_rigid_1.obj")
    assert tf == jf and len(tv) == len(jv) > 3
    assert np.abs(tv - jv).max() <= 1e-6
    jpos, jattr = tbgeo.read_bgeo(str(tmp_path / "j_cdf.bgeo"))
    tpos, tattr = tbgeo.read_bgeo(str(tmp_path / "t_cdf.bgeo"))
    assert len(tpos) > 100 and np.array_equal(tpos, jpos)
    for name in ("states", "rigid_id"):
        assert np.array_equal(tattr[name], jattr[name]), name
    assert np.abs(tattr["distance"] - jattr["distance"]).max() <= 1e-6
