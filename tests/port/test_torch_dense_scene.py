"""The scene API on the dense path: which path a scene takes, and what
runs on it.

``MPM``'s choice of path mirrors the JAX package's ``_use_blocked``
(``tests/test_misc_features.py``'s kernel-order cases): a 3-D scene of
another order warns and takes the dense path, ``optimized=True`` with
one raises ``ValueError``; 2-D scenes and ``optimized=False`` take the
dense path; rigid bodies on it raise, citing ROADMAP.md. On the dense
path the read-out and I/O work as on the blocked one, against the JAX
package's: the energy (2e-6 relative), 2-D texture seeding (bit for
bit), BGEO (2-D embedded at z = 0), snapshots in both directions (the
arrays exactly, a resumed frame within the frame bounds), emission into
free slots after a frame, ``general_action`` and the runner's dense
scenes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.core import levelset as jls
from taichi_mpm_tpu.core.solver import MPM as JMPM
from taichi_mpm_tpu.core.solver import mechanical_energy as jenergy
from taichi_mpm_tpu.sampling import texture as jtexture
from taichi_mpm_torch import MPM, convert, runner, scenes
from taichi_mpm_torch.core import levelset as tls
from taichi_mpm_torch.core.adaptive import AsyncMPM
from taichi_mpm_torch.io import bgeo
from taichi_mpm_torch.rigid.mesh import plate_mesh
from taichi_mpm_torch.sampling import texture as ttexture

from port_helpers import assert_frame_close, jax_particles, jax_substeps, max_err

torch.set_num_threads(1)


def _scene3d(**kw):
    # tests/test_misc_features.py's scene
    sim = MPM(res=(16, 16, 16), base_delta_t=1e-4, frame_dt=1e-3, device="cpu", **kw)
    pos = np.stack(np.meshgrid(*[np.linspace(0.4, 0.6, 4)] * 3), -1).reshape(-1, 3)
    sim.add_particles("jelly", pos=pos, E=1e4, nu=0.3)
    return sim


@pytest.mark.parametrize("order", [1, 3])
def test_explicit_optimized_raises(order):
    sim = _scene3d(optimized=True, kernel_order=order)
    with pytest.raises(ValueError, match="kernel_order"):
        sim.step()


@pytest.mark.parametrize("order", [1, 3])
def test_auto_falls_back_with_warning(order):
    sim = _scene3d(kernel_order=order)
    with pytest.warns(UserWarning, match="kernel_order"):
        assert sim._use_blocked() is False
    with pytest.warns(UserWarning, match="kernel_order"):
        sim.step()
    assert sim.packed_carry is None and sim.particles.count() == 64


@pytest.mark.parametrize("kw,blocked", [
    ({}, True), (dict(optimized=True), True), (dict(optimized=False), False)])
def test_quadratic_takes_the_asked_path(kw, blocked):
    sim = _scene3d(**kw)
    assert sim._use_blocked() is blocked
    sim.step()
    assert (sim.packed_carry is not None) is blocked


@pytest.mark.parametrize("optimized", [None, True, False])
def test_2d_takes_the_dense_path(optimized):
    sim = scenes.mpm88(device="cpu", optimized=optimized)
    assert sim._use_blocked() is False
    sim.step()
    assert sim.packed_carry is None and sim.particles.x.shape == (192, 2)


def test_rigid_bodies_on_the_dense_path_raise(monkeypatch):
    """Rigid bodies on the dense path run the dense CPIC frame (2-D, 3-D
    with optimized=False, AsyncMPM at order 3 with the order's warning);
    and fixed-dt CPIC on the blocked path with TMT_FUSED=0, which raised
    before the pytree CPIC frame was ported, runs that frame (its carry a
    Particles set)."""
    sim = MPM(res=(16, 16), device="cpu")
    sim.add_particles("jelly", pos=[[0.5, 0.6]])
    sim.add_particles("rigid", mesh=np.asarray([[[-0.2, 0.0], [0.2, 0.0]]], np.float32),
                      scripted_position=lambda t: (0.5, 0.5))
    sim.step()
    sim = _scene3d(optimized=False)
    sim.add_particles("rigid", mesh=plate_mesh(0.1, 0.1), scripted_position=lambda t: (0.5, 0.3, 0.5))
    sim.step()
    assert sim.packed_carry is None and sim.particles.count() == 64
    sim = AsyncMPM(res=(16, 16, 16), kernel_order=3, device="cpu")
    sim.add_particles("water", pos=[[0.5, 0.5, 0.5]])
    sim.add_particles("rigid", mesh=plate_mesh(0.1, 0.1), scripted_position=lambda t: (0.5, 0.3, 0.5))
    with pytest.warns(UserWarning):
        sim.step()
    assert sim.packed_carry is None and sim.last_substeps > 0
    monkeypatch.setenv("TMT_FUSED", "0")
    sim = _scene3d()
    sim.add_particles("rigid", mesh=plate_mesh(0.1, 0.1), scripted_position=lambda t: (0.5, 0.3, 0.5))
    sim.step()
    assert isinstance(sim.packed_carry[0], type(sim.particles)) and sim.particles.count() == 64


def _pair_2d():
    """A 2-D scene of both packages: jelly and snow blocks over a floor."""
    out = []
    for cls, ls, dev in ((JMPM, jls, {}), (MPM, tls, dict(device="cpu"))):
        sim = cls(res=(32, 32), base_delta_t=2e-4, frame_dt=1e-3, **dev)
        rng = np.random.default_rng(5)
        sim.add_particles("jelly", pos=rng.uniform(0.3, 0.45, (150, 2)), vel=(0.5, -1.0),
                          E=2e4, nu=0.3)
        sim.add_particles("snow", pos=rng.uniform(0.5, 0.65, (150, 2)), vel=(-0.5, 0.0))
        sim.add_collider(ls.Collider(sdf=lambda x, t: x[..., 1] - 0.2, friction=0.5))
        out.append(sim)
    return out


def test_energy_2d_matches_jax():
    jsim, tsim = _pair_2d()
    jsim._finalize()
    tsim._ensure_finalized()
    p = convert.particles_to_numpy(jsim.particles)
    p["F"] = p["F"] + 0.05 * np.random.default_rng(1).standard_normal(p["F"].shape).astype(np.float32)
    want = float(jenergy(jax_particles(p), jsim.cfg))
    tsim._set_particles(convert.particles_from_numpy(p))
    assert abs(tsim.energy() - want) <= 2e-6 * abs(want)


def test_density_texture_seeding_2d_matches_jax():
    jsim = JMPM(res=(64, 64))
    tsim = MPM(res=(64, 64), device="cpu")
    jsim.add_particles("water", density_tex=jtexture.sphere((0.5, 0.5), 0.2) * 4, density=1000)
    tsim.add_particles("water", density_tex=ttexture.sphere((0.5, 0.5), 0.2) * 4, density=1000)
    jb, tb = jsim._pending[0], tsim._pending[0]
    assert len(tb["x"]) > 100
    for name in ("x", "mass", "vol"):
        assert np.array_equal(jb[name], tb[name]), name


def test_snapshots_2d_both_ways(tmp_path):
    jsim, tsim = _pair_2d()
    jsim.step()
    jsim.save(str(tmp_path / "j.npz"))
    tsim.load(str(tmp_path / "j.npz"))
    jp = convert.particles_to_numpy(jsim.particles)
    for name, a in convert.particles_to_numpy(tsim.particles).items():
        assert np.array_equal(a, jp[name]), name
    assert tsim.t == np.float32(jsim.t)
    jsim.step()
    tsim.step()
    assert_frame_close(jsim.particles, tsim.particles)
    tsim.general_action("save", file_name=str(tmp_path / "t.npz"))
    jsim2 = _pair_2d()[0]
    jsim2.load(str(tmp_path / "t.npz"))
    for name, a in convert.particles_to_numpy(jsim2.particles).items():
        assert np.array_equal(a, convert.particles_to_numpy(tsim.particles)[name]), name


def test_visualize_2d_and_emission(tmp_path):
    _, tsim = _pair_2d()
    tsim.capacity = 400
    tsim.step()
    tsim.add_particles("water", pos=np.full((20, 2), 0.5, np.float32), density=1000)
    assert tsim.particles.count() == 320
    tsim.step()
    assert tsim.particles.count() == 320 and tsim.cfg.active_materials == (1, 2, 3)
    path = str(tmp_path / "f.bgeo")
    tsim.visualize(path, verbose=True, writer="numpy")
    pos, attrs = bgeo.read_bgeo(path)
    assert pos.shape == (320, 3) and (pos[:, 2] == 0).all()
    assert np.array_equal(pos[:, :2], tsim.positions())
    assert np.array_equal(attrs["v"][:, :2], tsim.velocities())
    assert tsim.general_action("calculate_energy") == tsim.energy()


def test_convert_2d_state_and_config_both_ways():
    jsim, _ = _pair_2d()
    jsim._finalize()
    a = convert.particles_to_numpy(jsim.particles)
    tp = convert.particles_from_numpy(a)
    assert tp.dim == 2 and tp.F.shape == (300, 2, 2)
    back = jax_particles(convert.particles_to_numpy(tp))
    assert max_err(back.x, jsim.particles.x) == 0.0
    import dataclasses

    from taichi_mpm_tpu.config import SimConfig as JConfig

    tcfg = convert.config_from_dict(dataclasses.asdict(jsim.cfg))
    assert tcfg.dim == 2 and tcfg.grid_nodes == jsim.cfg.grid_nodes
    assert JConfig(**dataclasses.asdict(tcfg)) == jsim.cfg


def test_mpm_2d_frames_match_jax():
    """The 2-D pair: two frames of the port's MPM against the JAX
    package's dense substeps, within the frame bounds."""
    jsim, tsim = _pair_2d()
    jsim._finalize()
    jp, jt = jsim.particles, 0.0
    for _ in range(2):
        jp, jt = jax_substeps(jp, jsim.cfg, tuple(jsim.colliders), 5, t=jt)
        tsim.step()
        assert_frame_close(jp, tsim.particles)
    assert float(jnp.float32(jt)) == float(tsim.t)


@pytest.mark.parametrize("scene,extra", [
    ("colliding_balls_energy", ["--res", "16"]), ("oscillating_jello", ["--res", "16"]),
    ("tetris", ["--res", "32"]), ("mpm88", [])])
def test_runner_dense_scenes(scene, extra, tmp_path, capsys):
    sim = runner.main([scene, "--frames", "1", "--cpu", "--frame-dt", "1e-3",
                       "--out", str(tmp_path)] + extra)
    out = capsys.readouterr().out
    assert ("E=" in out) is (scene in runner.ENERGY_SCENES)
    assert sim.packed_carry is None and sim.particles.count() > 0
    pos, _ = bgeo.read_bgeo(str(tmp_path / "00000.bgeo"))
    assert len(pos) == sim.particles.count()
