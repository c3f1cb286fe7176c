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

from port_helpers import (CPIC_BOUNDS, WHEEL_2D_SNAPSHOTS, assert_cpic_close, max_err,
                          np_of)

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


# JAX's stage functions run op by op here (nothing new is compiled as a
# whole); each takes the port's inputs of its stage, so each stage's
# difference is its own: grid records to 1e-6 of their
# scale, impulse and torque totals to 1e-5 (test_torch_cpic_dense.py's
# bounds), particles at the CPIC bounds
GRID_REL, IMPULSE_REL = 1e-6, 1e-5


def _close_rel(want, got, rel):
    want = np.asarray(want)
    assert max_err(want, got) <= rel * max(1.0, float(np.abs(want).max()))


def test_coupled_substep_stages_match_jax(pair):
    """One dense CPIC substep (base_dt) from each coupled snapshot, stage by
    stage (``diagnostics.substep_stages``, the stages the card is held to
    in chip_smoke.py's wheel_2d_coupled), against the JAX package's own
    coloured transfers, each from the port's inputs of its stage: P2G's
    grid and impulse totals from the port's CDF and bodies, G2P's
    particles and penalty totals from the port's gathered particles,
    bodies and grid velocities. The other stages are held to JAX's
    elsewhere, where they cost no extra compiles: the CDF in
    test_torch_cdf_2d.py, the grid update in test_torch_dense_transfer.py,
    the bodies' advance in test_torch_rigid_2d.py."""
    import dataclasses

    import jax.numpy as jnp

    from taichi_mpm_tpu.rigid import body as jbody
    from taichi_mpm_tpu.rigid import cpic as jcpic
    from taichi_mpm_torch import diagnostics

    jsim, tsim = pair["jsim"], pair["make"]()
    path, _ = WHEEL_2D_SNAPSHOTS[pair["name"]]
    for sim in (jsim, tsim):
        sim.load(str(ROOT / path))
    cfg = jsim.cfg
    dt = np.float32(cfg.base_dt)
    st = diagnostics.substep_stages(tsim, dt)
    pc = st["cdf_particles"]
    n = pc.x.shape[0]
    assert int(pc.near_b.sum()) > 40 and int((st["p2g_rows"][0] >= 0).sum()) > 0

    def jax_bodies(b):
        return jbody.RigidBodies(**{f.name: jnp.asarray(np_of(getattr(b, f.name)))
                                    for f in dataclasses.fields(b)})

    def jax_particles(p):  # the port's live lanes, then JAX's own (inactive) lanes
        jp = jsim.particles
        return dataclasses.replace(jp, **{
            f: jnp.concatenate([jnp.asarray(np_of(getattr(p, f))), getattr(jp, f)[n:]])
            for f in ("x", "v", "F", "C", "aux", "states", "bdist", "bnormal", "near_b",
                      "active")})

    _, grid_rid, grid_states = (jnp.asarray(np_of(a)) for a in st["cdf_planes"])
    grid, J1, tau1 = jcpic.p2g_cpic(jax_particles(pc), jax_bodies(st["cdf_bodies"]), grid_rid,
                                    grid_states, cfg, dt)
    _close_rel(grid, st["p2g_grid"], GRID_REL)
    assert bool((np.asarray(J1) != 0).any())  # the wheel takes impulses
    _close_rel(J1, st["p2g_totals"][0], IMPULSE_REL)
    _close_rel(tau1, st["p2g_totals"][1], IMPULSE_REL)
    b1 = jax_bodies(st["p2g_bodies"])
    pg, J2, tau2 = jcpic.g2p_cpic(jax_particles(pc), b1, jnp.asarray(np_of(st["grid_v"])),
                                  grid_rid, grid_states, cfg, dt)
    pg = dataclasses.replace(pg, **{f: getattr(pg, f)[:n] for f in ("x", "v", "F", "active")})
    for name, bound in CPIC_BOUNDS.items():
        assert max_err(getattr(pg, name), getattr(st["g2p_particles"], name)) <= bound, name
    _close_rel(J2, st["g2p_totals"][0], IMPULSE_REL)
    _close_rel(tau2, st["g2p_totals"][1], IMPULSE_REL)


def test_body_totals_twin_matches_ordered_rows():
    """The plain twin of the kernel ``body_totals`` (``ops.body_sums``) on
    its edge inputs (``diagnostics.body_totals_edge_inputs``: several
    offsets and bodies, lanes of no body, some of them NaN, a body with no
    lane, a row one body crowds, one lane, no valid lane, N about the
    kernels' word, tile, batch and chunk, hits on the first and last lane
    only, one body on every lane of a 100,000-lane row, 8 bodies, the 2-D
    and G2P shapes), in bits against
    ``index_add_ordered`` into per-offset rows with every lane added (the
    lanes of no body as zeros into body 0's row, as the CPU path summed
    before) and against JAX's scatter-add of each offset
    (``accumulate_impulses``' sums; every case's rows in one scatter, so
    that JAX compiles one)."""
    import jax.numpy as jnp

    from taichi_mpm_torch import diagnostics
    from taichi_mpm_torch.ops import body_sums
    from taichi_mpm_torch.utils import index_add_ordered

    got, rows, vals, base = {}, [], [], 0
    for label, (rid, J, tau, R) in diagnostics.body_totals_edge_inputs().items():
        L = rid.shape[0]
        out = body_sums.body_totals(*(torch.as_tensor(a) for a in (rid, J, tau)), R)
        assert not any(bool(torch.isnan(g).any()) for g in out), label
        flat = (np.arange(L)[:, None] * R + np.clip(rid, 0, R - 1)).reshape(-1)
        for v, g in zip((J, tau), out):
            zeroed = np.where((rid >= 0)[..., None], v, 0.0).astype(np.float32).reshape(
                -1, v.shape[-1])
            want = index_add_ordered(torch.zeros((L * R, v.shape[-1])), torch.as_tensor(flat),
                                     torch.as_tensor(zeroed))
            assert np.array_equal(np_of(g).reshape(L * R, -1), np_of(want)), label
            got[label, base] = np_of(g).reshape(L * R, -1)
            rows.append(base + flat)
            vals.append(np.pad(zeroed, ((0, 0), (0, 3 - v.shape[-1]))))
            base += L * R
    jax_rows = np.asarray(jnp.zeros((base, 3)).at[np.concatenate(rows)].add(
        np.concatenate(vals)))
    for (label, start), g in got.items():
        assert np.array_equal(g, jax_rows[start:start + g.shape[0], :g.shape[1]]), label


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
