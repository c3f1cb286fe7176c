"""The 2-D CPIC scene scripts on the port, against the JAX package.

``scenes.sand_wheel_2d`` (``scripts/mls-cpic/sand_wheel_2D.py``, its sand
source emitting each frame) and ``scenes.async_wheel``
(``scripts/async/wheel.py``, global adaptive dt) at the scripts' own res
128 and capacity 100,000, a few frames with frame_dt cut to 1e-3,
against the JAX package running the same scripts (``runpy``, their
``__main__`` left out): the same particles alive, x 5e-6, v 5e-4, F
5e-5, states equal, bodies 1e-5 / 1e-6, equal substep counts. A 2-D CPIC
snapshot saved by each package resumes in the other within the same
bounds of the run that was not cut. Three frames from a snapshot with
the sand on the wheel hold the coupling there. Then tests/test_cpic.py's physical
checks of the 2-D scenes on the port alone: particles rest on a thin
plate, momentum passes both ways, a cutter gives two sides, a scripted
wheel drags particles.
"""

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from taichi_mpm_torch import MPM, scenes
from taichi_mpm_torch.rigid.mesh import polygon_mesh_2d, segment_mesh_2d, wheel_mesh_2d

from port_helpers import WHEEL_2D_SNAPSHOTS, assert_cpic_close

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
FRAME_DT = 1e-3
SCRIPTS = {
    "sand_wheel_2d": ("scripts/mls-cpic/sand_wheel_2D.py", 3,
                      lambda: scenes.sand_wheel_2d(device="cpu"), scenes.sand_wheel_2d_source),
    "async_wheel": ("scripts/async/wheel.py", 2, lambda: scenes.async_wheel(device="cpu"), None),
}


def jax_script(path):
    """The JAX package's scene script at its default res, built but not
    run: its module globals (``sim``, ``frame_update``)."""
    argv = sys.argv
    sys.argv = [path]
    try:
        return runpy.run_path(str(ROOT / path), run_name="scene")
    finally:
        sys.argv = argv


@pytest.fixture(scope="module", params=sorted(SCRIPTS))
def pair(request):
    """Both packages' scene after the script's first frames."""
    path, frames, make, source = SCRIPTS[request.param]
    g = jax_script(path)
    jsim, jsource = g["sim"], g.get("frame_update")
    tsim = make()
    jsim.frame_dt = tsim.frame_dt = FRAME_DT
    counts = []
    for f in range(frames):
        if source is not None:
            jsource(jsim, f)
            source(tsim, f)
        jsim.step()
        tsim.step()
        counts.append((getattr(jsim, "last_substeps", None), getattr(tsim, "last_substeps", None)))
    return dict(name=request.param, jsim=jsim, tsim=tsim, make=make, source=source,
                jsource=jsource, frames=frames, counts=counts)


def test_script_frames_match_jax(pair):
    jsim, tsim = pair["jsim"], pair["tsim"]
    assert tsim.particles.count() == int(np.asarray(jsim.particles.active).sum()) > 0
    assert_cpic_close(jsim.particles, jsim.bodies, tsim.particles, tsim.bodies)
    assert tsim.t == np.float32(jsim.t)
    for jn, tn in pair["counts"]:
        assert jn == tn
    if pair["name"] == "async_wheel":
        assert tsim.particles.count() == 2361 and tsim.last_substeps == 5


def test_snapshots_resume_across_packages(pair, tmp_path):
    """Each package's snapshot after the first frames, resumed by the
    other for one more frame, against the run that was not cut."""
    jsim, tsim, f = pair["jsim"], pair["tsim"], pair["frames"]
    jsim.save(str(tmp_path / "jax.npz"))
    tsim.save(str(tmp_path / "port.npz"))
    resumed = pair["make"]()
    resumed.frame_dt = FRAME_DT
    resumed.load(str(tmp_path / "jax.npz"))
    for sim, source in ((jsim, pair["jsource"]), (tsim, pair["source"]),
                        (resumed, pair["source"])):
        if source is not None:
            source(sim, f)
        sim.step()
    assert_cpic_close(jsim.particles, jsim.bodies, resumed.particles, resumed.bodies)
    jsim.load(str(tmp_path / "port.npz"))  # the port's snapshot in the JAX package's scene
    if pair["jsource"] is not None:
        pair["jsource"](jsim, f)
    jsim.step()
    assert_cpic_close(jsim.particles, jsim.bodies, tsim.particles, tsim.bodies)


COUPLED_FRAMES = 3


def test_coupled_frames_match_jax(pair):
    """Each script from a snapshot with its sand on the wheel (the port's
    run of the script, frames of 1e-3 s, to 0.19 s or 0.15 s:
    ``port_helpers.wheel_2d_snapshot``), resumed by both packages (the
    JAX scene already compiled for such frames) for three coupled frames:
    the CPIC bounds, with grains near the wheel and acting on it. It runs
    after the tests above on this pair, which it leaves resumed."""
    jsim, tsim = pair["jsim"], pair["make"]()
    tsim.frame_dt = FRAME_DT
    path, first = WHEEL_2D_SNAPSHOTS[pair["name"]]
    for sim in (jsim, tsim):
        sim.load(str(ROOT / path))
    n = tsim.particles.count()
    assert tsim.particles.near_b.sum() > 40
    for f in range(first, first + COUPLED_FRAMES):
        if pair["source"] is not None:
            pair["jsource"](jsim, f)
            pair["source"](tsim, f)
        jsim.step()
        tsim.step()
    assert tsim.particles.count() == int(np.asarray(jsim.particles.active).sum()) == n
    assert tsim.t == np.float32(jsim.t)
    assert tsim.particles.near_b.sum() > 40 and (tsim.particles.states != 0).sum() > 100
    assert_cpic_close(jsim.particles, jsim.bodies, tsim.particles, tsim.bodies)


# -- tests/test_cpic.py's physical checks of the 2-D scenes, on the port ----------


def test_particles_rest_on_thin_plate():
    sim = MPM(res=(32, 32), base_delta_t=1e-4, frame_dt=2e-3, gravity=(0, -10.0), device="cpu")
    xs, ys = np.linspace(0.4, 0.6, 8), np.linspace(0.53, 0.6, 4)
    pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    sim.add_particles("jelly", pos=pos, vel=(0.0, -0.5), E=1e4, nu=0.3)
    sim.add_particles("rigid", mesh=segment_mesh_2d((-0.3, 0.0), (0.3, 0.0)),
                      scripted_position=lambda t: (0.5, 0.5), codimensional=True, friction=0.0)
    for _ in range(50):
        sim.step()
    x = sim.positions()
    assert x[:, 1].min() > 0.51  # free fall would reach ~0.43
    assert sim.particles.count() == len(pos)


def test_two_way_momentum_transfer():
    sim = MPM(res=(32, 32), base_delta_t=1e-4, frame_dt=2e-3, gravity=(0, 0.0), device="cpu")
    xs, ys = np.linspace(0.2, 0.3, 6), np.linspace(0.45, 0.55, 6)
    pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    sim.add_particles("jelly", pos=pos, vel=(2.0, 0.0), E=1e4, nu=0.3, density=1000)
    sq = polygon_mesh_2d([[-0.05, -0.1], [0.05, -0.1], [0.05, 0.1], [-0.05, 0.1]])
    rid = sim.add_particles("rigid", mesh=sq, initial_position=(0.55, 0.5), codimensional=False,
                            density=500, friction=0.0)
    for _ in range(60):
        sim.step()
    b, p = sim.bodies, sim.particles
    assert float(b.vel[rid, 0]) > 0.01
    mom_r = float(b.vel[rid, 0]) / float(b.mass_inv[rid])
    assert mom_r > 0.5 * float(p.mass[p.active].sum()) * 2.0
    assert abs(float(b.vel[rid, 1])) < 0.05


def test_cutting_assigns_two_sides():
    sim = MPM(res=(32, 32), base_delta_t=1e-4, frame_dt=1e-3, gravity=(0, 0.0), device="cpu")
    xs = ys = np.linspace(0.4, 0.6, 10)
    pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    sim.add_particles("jelly", pos=pos, E=1e4, nu=0.3)
    sim.add_particles("rigid", mesh=segment_mesh_2d((0.0, -0.2), (0.0, 0.2)),
                      scripted_position=lambda t: (0.5, 0.5), codimensional=True, friction=-1.0)
    sim.step()
    p = sim.particles
    st, x = p.states.numpy(), p.x.numpy()
    near = p.active.numpy() & (np.abs(x[:, 0] - 0.5) < 0.05)
    assert len(set(st[near][st[near] != 0].tolist())) == 2


def test_scripted_wheel_drags_particles():
    sim = MPM(res=(32, 32), base_delta_t=1e-4, frame_dt=1e-3, gravity=(0, 0.0), device="cpu")
    ang = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    pos = 0.5 + np.stack([0.16 * np.cos(ang), 0.16 * np.sin(ang)], -1)
    sim.add_particles("jelly", pos=pos, E=5e3, nu=0.3)
    sim.add_particles("rigid", mesh=wheel_mesh_2d(radius=0.14, n_spokes=6, spoke_width=0.03),
                      scripted_position=lambda t: (0.5, 0.5),
                      scripted_rotation=lambda t: 360.0 * t, codimensional=True, friction=0.3)
    for _ in range(30):
        sim.step()
    assert np.isclose(float(sim.bodies.rot[1, 0]), np.deg2rad(360.0 * float(sim.t)), atol=1e-3)
    assert sim.particles.count() == len(pos)
