"""The 3-D scene scripts on the port, against the JAX package's scripts.

Build parity: each of the 14 runner entries (``runner.SCENES``) that
build ``scripts/async/{combo,sand,slope,stork}.py``,
``scripts/mls-cpic/{banana,bunny_split,buoyancy,goo_blocks,robot,
robot_reversed,sand_stir,sand_sweep}.py``, ``scripts/sand_layers.py`` and
``scripts/benchmark/colliding_balls_3d_test.py``, built at res 48 (the
CPIC scripts) or 32 (the rest), against the JAX script built by
``runpy`` with its ``__main__`` left out (``robot_reversed.py`` runs its
simulation when loaded, so JAX's reversed robot is ``robot.py`` under
ROBOT_REVERSED=1): the particles in bits (sand_layers' cohesion bands
among the parameters), the bodies, boundary particles and hulls in bits,
the scripted motions at t = 0 and 0.37 s in bits (within one float32 ulp
where XLA's cos and sin enter), the articulations' fields, each
collider's SDF at seeded points within one float32 ulp, and the
configuration (dt, frame_dt, penalty, cfl, rpic_damping, pushing force,
capacity, gravity, strength_dt_mul, unit dt).

Frames against JAX, one JAX compile each (the JAX frames run in processes
of their own, ``script_frames.py``, started with the first test):
``robot`` at res 48 (the
stepper articulation in a coupled 3-D frame over sand), a frame of 6
substeps on the fused route, within the CPIC bounds, and the wheels
spinning at the stepper's +12 rad/s relative to the body;
``sand_layers`` at res 32 (per-particle cohesion in the fused kernels'
twins), 6 substeps, within the sand column's bounds, plastic events
equal but for sand's knife edges; ``stork`` at res 32, one frame at
global adaptive dt (strength_dt_mul 0.8, no gravity), its substep count
and every dt equal in bits, the fields within the frame bounds. The
robot's snapshots after that frame load across packages: JAX's
``MPM.save`` into the port's rebuilt robot and the port's into the JAX
script's, particles and bodies in bits.

The port alone: every entry through ``runner.main`` on the CPU, one
frame of a few substeps; its particles finite and in the domain, its
frame line printed, buoyancy's count growing, the robot and the
reversed robot spinning their wheels in opposite senses.
"""

import dataclasses
import functools
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from taichi_mpm_torch import convert, diagnostics, runner, scenes
from taichi_mpm_torch.rigid.body import BODY_FIELDS
from taichi_mpm_torch.rigid.scene import SCENE_ARRAYS
from taichi_mpm_torch.sampling import poisson as tpoisson

import script_frames
from port_helpers import BODY_BOUNDS, CPIC_BOUNDS, FRAME_BOUNDS, by_id, max_err

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
CPIC_RES, PLAIN_RES = script_frames.CPIC_RES, script_frames.PLAIN_RES
# runner entry -> (the JAX script, the res of the tests, environment of its build)
SCRIPTS = {
    "combo": ("scripts/async/combo.py", PLAIN_RES, {}),
    "sand": ("scripts/async/sand.py", PLAIN_RES, {}),
    "slope": ("scripts/async/slope.py", PLAIN_RES, {}),
    "stork": ("scripts/async/stork.py", PLAIN_RES, {}),
    "banana": ("scripts/mls-cpic/banana.py", CPIC_RES, {}),
    "bunny_split": ("scripts/mls-cpic/bunny_split.py", CPIC_RES, {}),
    "buoyancy": ("scripts/mls-cpic/buoyancy.py", CPIC_RES, {}),
    "goo_blocks": ("scripts/mls-cpic/goo_blocks.py", CPIC_RES, {}),
    "robot": ("scripts/mls-cpic/robot.py", CPIC_RES, {}),
    "robot_reversed": ("scripts/mls-cpic/robot.py", CPIC_RES, {"ROBOT_REVERSED": "1"}),
    "sand_stir": ("scripts/mls-cpic/sand_stir.py", CPIC_RES, {}),
    "sand_sweep": ("scripts/mls-cpic/sand_sweep.py", CPIC_RES, {}),
    "sand_layers": ("scripts/sand_layers.py", PLAIN_RES, {}),
    "colliding_balls_3d_test": ("scripts/benchmark/colliding_balls_3d_test.py", PLAIN_RES, {}),
}
XLA_COS_SIN = ("sand_stir",)  # scripted motions through XLA's float32 cos and sin
SCRIPT_TIMES = (0.0, 0.37, 0.42, 0.8, 0.95, 1.5)  # every segment of the cutter's path


@pytest.fixture(autouse=True)
def script_env(monkeypatch):
    """The JAX scripts' solver is MPM (no SHARDS, no ASYNC) and their
    sampler takes the port's shipped periodic tiles (the generation of
    JAX's, which takes tens of seconds in 3-D)."""
    from taichi_mpm_tpu.sampling import poisson as jpoisson

    for name in ("SHARDS", "ASYNC", "ROBOT_REVERSED"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jpoisson, "_periodic_cache",
                        {d: tpoisson.periodic_tile(d) for d in (2, 3)})


def jax_script(name, res):
    """The JAX package's scene script at `res`, built but not run: its
    module globals (``sim``, ``frame_update``)."""
    path, _, env = SCRIPTS[name]
    saved_argv, saved_env = sys.argv, {k: os.environ.get(k) for k in env}
    sys.argv = [path, "--res", str(res)]
    os.environ.update(env)
    try:
        return runpy.run_path(str(ROOT / path), run_name="scene")
    finally:
        sys.argv = saved_argv
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def port_script(name, res, argv=()):
    """The port's runner entry at `res` on the CPU: (sim, frame_update)."""
    args = runner.parse_args([name, "--res", str(res), "--cpu", *argv], scene=True)
    return runner.SCENES[name](args)


def within_ulp(a, b, ulps=1):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all(np.abs(a - b) <= ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))))


def jax_scripted(fn):
    """A JAX scene's scripted motion as its rigid advance evaluates it:
    traced on a float32 time under jit."""
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda s: jnp.asarray(fn(s), jnp.float32))


CONFIG_FIELDS = ("base_dt", "penalty", "cfl", "rpic_damping", "pushing_force", "gravity", "res",
                 "dx", "active_materials", "num_rigids")
SIM_FIELDS = ("frame_dt", "capacity", "strength_dt_mul", "unit_delta_t")


@pytest.mark.usefixtures("jax_frames")  # the JAX frames start computing with the first test
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_build_matches_jax_script(name):
    import jax.numpy as jnp

    res = SCRIPTS[name][1]
    g = jax_script(name, res)
    jsim, jsource = g["sim"], g.get("frame_update")
    tsim, source = port_script(name, res)
    assert type(tsim).__name__ == type(jsim).__name__
    assert (jsource is None) == (source is None)
    for sim in (jsim, tsim):
        sim._finalize()
        if source is not None:  # the first frame's emission too
            (jsource if sim is jsim else source)(sim, 0)
    for field in CONFIG_FIELDS:
        assert getattr(tsim.cfg, field) == getattr(jsim.cfg, field), field
    for field in SIM_FIELDS:
        assert getattr(tsim, field, None) == getattr(jsim, field, None), field

    j = convert.particles_to_numpy(jsim.particles)
    t = convert.particles_to_numpy(tsim.particles)
    assert t["active"].sum() > 100
    for field, arr in t.items():
        assert arr.dtype == j[field].dtype and np.array_equal(arr, j[field]), field
    if name == "sand_layers":  # the cohesion bands reach the parameters
        assert len(np.unique(t["params"][t["active"]], axis=0)) == 2

    pts = np.random.default_rng(7).uniform(0.0, 1.0, (4000, 3)).astype(np.float32)
    assert len(tsim.colliders) == len(jsim.colliders) > 0
    for jc, tc in zip(jsim.colliders, tsim.colliders):
        assert tc.friction == jc.friction
        want = np.asarray(jc.sdf(jnp.asarray(pts), 0.0))
        got = tc.sdf(torch.from_numpy(pts), 0.0).numpy()
        assert got.dtype == np.float32 and within_ulp(got, want)
        assert (want < 0).any() and (want > 0).any()

    assert (jsim.bodies is None) == (tsim.bodies is None)
    if tsim.bodies is None:
        return
    for field in BODY_FIELDS:
        assert np.array_equal(getattr(tsim.bodies, field).numpy(),
                              np.asarray(getattr(jsim.bodies, field))), field
    js, ts = jsim.rigid_scene, tsim.rigid_scene
    for field in SCENE_ARRAYS:
        assert np.array_equal(getattr(ts, field).numpy(), np.asarray(getattr(js, field))), field
    for funcs in ("pos_funcs", "rot_funcs"):
        jf, tf = getattr(js, funcs), getattr(ts, funcs)
        assert [f is None for f in jf] == [f is None for f in tf]
        for a, b in zip(jf, tf):
            if a is None:
                continue
            jitted = jax_scripted(a)
            for when in SCRIPT_TIMES:
                want = np.asarray(jitted(np.float32(when)))
                got = np.asarray(b(np.float32(when)), np.float32)
                if name in XLA_COS_SIN:
                    assert within_ulp(got, want), (funcs, when)
                else:
                    assert np.array_equal(got, want), (funcs, when, got, want)
    assert len(ts.articulations) == len(js.articulations)
    for ja, ta in zip(js.articulations, ts.articulations):
        assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    assert (ts.collision is None) == (js.collision is None)
    if ts.collision is not None:
        assert dataclasses.asdict(ts.collision) == dataclasses.asdict(js.collision)


# -- the port alone, through the runner --------------------------------------------

# entry -> (res, --frame-dt): a frame of a few substeps (the stork 16, at its adaptive dt)
RUNS = {name: (res, 1e-3 if name in ("combo", "sand", "slope", "stork") else
               (4e-4 if name in ("sand_layers", "colliding_balls_3d_test") else 1.5e-4))
        for name, (_, res, _) in SCRIPTS.items()}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_runner_runs_the_script(name, capsys):
    res, frame_dt = RUNS[name]
    sim = runner.main([name, "--cpu", "--frames", "1", "--res", str(res),
                       "--frame-dt", str(frame_dt)])
    out = capsys.readouterr().out
    n = sim.particle_count()
    assert f"frame 00000  t={float(sim.t):.4f}  particles={n}" in out
    x = sim.positions()
    assert n > 100 and np.isfinite(x).all() and (x > 0).all() and (x < 1).all()
    if name == "buoyancy":  # the jets emitted into the pool
        assert n > scenes.buoyancy(res=res, device="cpu").particle_count()
    if name.startswith("robot"):  # the steppers spin the wheels about z
        spin = np.asarray([float(sim.bodies.omega[w, 2] - sim.bodies.omega[b, 2])
                           for w, b in (a.obj for a in sim.rigid_scene.articulations)])
        assert len(spin) == 2
        assert np.all(np.sign(spin) == (-1 if name == "robot_reversed" else 1)), spin


# -- frames against JAX: one JAX compile each, in processes of their own
# (script_frames.py), started with the first test of the file --------------------

SAND_BOUNDS = dict(x=5e-6, v=5e-5, F=2.5e-5, C=5e-4, aux=1.5e-5)  # the sand column's
FRAME_SCRIPTS = ("robot", "sand_layers", "stork")


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    """The JAX frames of FRAME_SCRIPTS, computed in processes started
    here; each item a function that waits for its result."""
    out = tmp_path_factory.mktemp("script_frames")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {name: (subprocess.Popen([sys.executable, str(ROOT / "tests/port/script_frames.py"),
                                      name, str(out / f"{name}.npz")], cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                    out / f"{name}.npz")
             for name in FRAME_SCRIPTS}

    def result(name):
        proc, path = procs[name]
        log = proc.communicate(timeout=600)[0].decode()
        assert proc.returncode == 0, log[-3000:]
        return dict(np.load(path), snapshot=script_frames.snapshot_path(path))

    yield {name: functools.partial(result, name) for name in FRAME_SCRIPTS}
    for proc, _ in procs.values():
        proc.kill()
        proc.communicate()


def assert_by_id(ref, p, bounds, equal=()):
    """The active particles of `p` by id against `ref` (a JAX frame's
    p_<field> arrays, by id)."""
    got = by_id(p)
    assert np.array_equal(got["params"][:, scenes.ID_SLOT], ref["p_params"][:, scenes.ID_SLOT])
    for name, bound in bounds.items():
        err = max_err(ref[f"p_{name}"], got[name])
        assert err <= bound, (name, err)
    for name in equal:
        assert np.array_equal(ref[f"p_{name}"], got[name]), name


def test_sand_layers_frame_matches_jax(jax_frames):
    """sand_layers.py at res 32: the port's column after 24 substeps (its
    loose layers start to yield), then 6 substeps from that state in both
    packages, the banded cohesion in the fused kernels' twins; plastic
    events equal but for the lanes at sand's knife edges."""
    tsim = script_frames.settled_sand()
    ref = jax_frames["sand_layers"]()
    start = convert.particles_to_numpy(tsim.particles)
    for name, arr in start.items():  # the state JAX was given
        assert np.array_equal(ref[f"start_{name}"], arr), name
    before = tsim.plasticity_counter
    with diagnostics.sand_edges_per_substep() as edges:
        tsim.step(frame_dt=script_frames.FRAME_SUBSTEPS * tsim.cfg.base_dt)
    events = tsim.plasticity_counter - before
    assert len(edges) == script_frames.FRAME_SUBSTEPS and ref["plast"] > 0
    assert abs(int(ref["plast"]) - events) <= sum(edges), (int(ref["plast"]), events, edges)
    assert ref["nmax"] <= ref["cap"] and tsim.t == ref["t"]
    assert_by_id(ref, tsim.particles, SAND_BOUNDS)


def test_stork_frame_matches_jax(jax_frames):
    """stork.py at res 32, one 0.01 s frame at global adaptive dt
    (strength_dt_mul 0.8, no gravity): the same substeps, every dt in
    bits, the fields within the frame bounds."""
    tsim, _ = port_script("stork", PLAIN_RES)
    scenes.tag_pending(tsim)
    dts = []
    record = tsim._record

    def recorded(n, step_dts, n_active):
        dts.extend(np.float32(d) for d in step_dts)
        return record(n, step_dts, n_active)

    tsim._record = recorded
    tsim.step()
    ref = jax_frames["stork"]()
    assert tsim.last_substeps == ref["n"] == len(ref["dts"]) == len(dts) > 1
    assert np.array_equal(np.asarray(dts, np.float32), ref["dts"])
    assert ref["nmax"] <= ref["cap"] and tsim.t == ref["t"]
    assert_by_id(ref, tsim.particles, FRAME_BOUNDS)


@pytest.fixture(scope="module")
def port_robot():
    """The port's robot.py at res 48 after a frame of 6 substeps on the
    fused route, ids tagged."""
    tsim, _ = port_script("robot", CPIC_RES)
    scenes.tag_pending(tsim)
    tsim.step(frame_dt=script_frames.FRAME_SUBSTEPS * tsim.cfg.base_dt)
    return tsim


def test_robot_frame_matches_jax(jax_frames, port_robot):
    """robot.py at res 48, a frame of 6 substeps on the fused route
    against the JAX script's own frame on the CPU: the stepper
    articulation drives the wheels over the sand bed. The wheels turn
    at the steppers' 12 rad/s relative to the body, less what the sand
    takes from them after the articulation's solve (12.0041 and 11.9490
    in both packages after this frame)."""
    tsim = port_robot
    ref = jax_frames["robot"]()
    assert tsim.t == ref["t"]
    assert_by_id(ref, tsim.particles, CPIC_BOUNDS, equal=("states", "near_b"))
    assert ref["p_near_b"].any() and (ref["p_states"] != 0).any()
    for name, bound in BODY_BOUNDS.items():
        assert max_err(ref[f"body_{name}"], getattr(tsim.bodies, name)) <= bound, name
    wheels = [a.obj for a in tsim.rigid_scene.articulations]
    spin = np.asarray([float(tsim.bodies.omega[w, 2] - tsim.bodies.omega[b, 2])
                       for w, b in wheels])
    assert np.all(np.abs(spin / scenes.ROBOT_SPIN - 1.0) < 5e-3), spin


def assert_same_state(got, bodies, t, want, want_bodies, want_t):
    """Particles (by id, every field) and bodies (every field) in bits,
    and the time."""
    assert got.keys() == want.keys()
    for name, arr in got.items():
        assert arr.dtype == want[name].dtype and np.array_equal(arr, want[name]), name
    for field in BODY_FIELDS:
        assert np.array_equal(np.asarray(getattr(bodies, field)),
                              np.asarray(want_bodies[field])), field
    assert np.float32(t) == np.float32(want_t)


def test_robot_snapshots_load_across_packages(jax_frames, port_robot, tmp_path):
    """A 3-D CPIC script's snapshot in the other package: the JAX robot's
    ``MPM.save`` after its frame, loaded into the port's rebuilt robot,
    and the port's after the same frame, loaded into the JAX script's
    rebuilt robot; each holds the saved particles and bodies in bits."""
    ref = jax_frames["robot"]()
    resumed, _ = port_script("robot", CPIC_RES)
    resumed.load(ref["snapshot"])
    assert_same_state(by_id(resumed.particles), resumed.bodies, resumed.t,
                      {k[2:]: v for k, v in ref.items() if k.startswith("p_")},
                      {k: ref[f"body_{k}"] for k in BODY_FIELDS}, ref["t"])

    port_robot.save(str(tmp_path / "port.npz"))
    jsim = jax_script("robot", CPIC_RES)["sim"]
    jsim.load(str(tmp_path / "port.npz"))
    assert_same_state(by_id(jsim.particles), jsim.bodies, jsim.t, by_id(port_robot.particles),
                      {k: getattr(port_robot.bodies, k).numpy() for k in BODY_FIELDS},
                      port_robot.t)
