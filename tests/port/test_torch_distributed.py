"""``DistributedMPM`` on slabs, the slice as a whole: the port's on two
gloo ranks on the CPU (one spawned group for the file,
``slab_ranks.scenes``) against the JAX package's ``DistributedMPM`` on
2 of the 8 virtual CPU devices (one run: the default route, balanced
and fused), and the port's other routes against its own ``MPM``.

The scene (``slab_ranks.crossing_scene``): two jelly blobs across the
middle of a res-32 box moving +x and -x at 8 m/s, one frame of 12
substeps: particles cross the slab boundary both ways, and the frame
re-sorts in its middle. Particles are matched by an index tag.

Bounds: the port's frame bounds (``port_helpers.FRAME_BOUNDS``, x 5e-6,
v 5e-5, F 5e-6, C 5e-4, aux 5e-6), for the port against JAX's slabs and
against its own one-device frame. The slabs sum a boundary node's two
halves after each merge, where one device merges the tiles in one sum,
so their bits differ from one device's."""

import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_helpers import FRAME_BOUNDS, assert_close_by_id
from slab_ranks import ROUTES, crossing_scene, scenes
from taichi_mpm_torch import MPM, convert
from taichi_mpm_torch.io.checkpoint import load_checkpoint
from taichi_mpm_torch.parallel import comm
from taichi_mpm_tpu import DistributedMPM as JDistributedMPM
from taichi_mpm_tpu.core import levelset as jlevelset

torch.set_num_threads(1)

N_PARTICLES = 600


def assert_close(a, b, bounds=FRAME_BOUNDS):
    """Two dicts of numpy particle fields: the same tagged particles
    alive, within `bounds`."""
    assert_close_by_id(SimpleNamespace(**a), SimpleNamespace(**b), bounds)


def _route_env(fused):
    old = os.environ.get("TMT_FUSED")
    os.environ["TMT_FUSED"] = "1" if fused else "0"
    return old


def _restore_env(old):
    if old is None:
        os.environ.pop("TMT_FUSED", None)
    else:
        os.environ["TMT_FUSED"] = old


def mpm_frame(fused, frames=1, load=None):
    """The crossing scene on the port's MPM (the CPU)."""
    old = _route_env(fused)
    try:
        sim = crossing_scene(MPM, device="cpu")
        if load:
            sim.load(load)
        for _ in range(frames):
            sim.step()
    finally:
        _restore_env(old)
    return sim


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the one JAX DistributedMPM run (made while the
    ranks work), and the port's MPM frames."""
    d = tmp_path_factory.mktemp("slabs")
    snap = str(d / "mpm.npz")
    mpm_frame(True).save(snap)
    out = {}

    def ranks():
        try:
            out["port"] = comm.run_ranks(scenes, 2, "gloo", args=(snap, str(d)), timeout_s=240)
        except Exception as e:  # re-raised below, in the test's thread
            out["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    jsim = crossing_scene(JDistributedMPM, ls=jlevelset, n_shards=2)
    jsim.step()
    jax_out = dict(convert.particles_to_numpy(jsim.particles),
                   bounds=np.asarray(jsim._bal[0]), t=float(jsim.t))
    mpm = {fused: convert.particles_to_numpy(mpm_frame(fused).particles) for fused in (True, False)}
    resumed = mpm_frame(True, load=snap)
    th.join(timeout=300)
    assert not th.is_alive(), "the ranks outlived their timeout"
    if "error" in out:
        raise out["error"]
    return dict(port=out["port"], jax=jax_out, mpm=mpm, dir=d,
                resumed=convert.particles_to_numpy(resumed.particles), resumed_t=resumed.t)


def test_default_route_matches_jax(runs):
    """Balanced fused slabs, the port's against JAX's: the same particles,
    within the frame bounds, the same bounds; migrants crossed both ways
    and the frame re-sorted in its middle."""
    r0, r1 = (r["fused_balanced"] for r in runs["port"])
    assert r0["fused"] and r0["balanced"] and r0["count"] == N_PARTICLES
    assert r0["sent"][1] > 0 and r1["sent"][0] > 0  # rank 0 -> 1 and 1 -> 0
    assert r0["resort_after"][0] == 0 and any(0 < n < 12 for n in r0["resort_after"])
    assert r0["resort_after"] == r1["resort_after"]
    assert tuple(runs["jax"]["bounds"]) == r0["bounds"][-1]
    assert_close(runs["jax"], r0)
    for k in ("x", "v", "F", "C", "aux", "active", "params"):
        assert np.array_equal(r0[k], r1[k]), k  # every rank gathers the same global set


@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_match_mpm(runs, route):
    """Each route and kind of bounds on two ranks against the port's MPM on
    that route."""
    fused, balanced = ROUTES[route]
    r0 = runs["port"][0][route]
    assert r0["fused"] == fused and r0["balanced"] == balanced
    assert r0["count"] == N_PARTICLES and r0["sent"] != (0, 0)
    assert_close(runs["mpm"][fused], r0)


def test_world_size_one_matches_mpm():
    """One rank (a group of one, in this process) against MPM: the local
    frame's collider positions x_local + offset round as the global ones
    do here, and the slab's summation order is one device's."""
    from taichi_mpm_torch.parallel.driver import DistributedMPM

    ref = convert.particles_to_numpy(mpm_frame(True).particles)
    with comm.process_group("gloo", 0, 1, comm.free_port(), timeout_s=60):
        sim = crossing_scene(DistributedMPM, device="cpu")
        sim.step()
        out = convert.particles_to_numpy(sim._gather())
        assert sim.slab_stats.sent_left == sim.slab_stats.sent_right == 0
    assert_close(ref, out, dict.fromkeys(FRAME_BOUNDS, 0.0))  # one rank gives MPM's bits


def test_source_after_first_step(runs):
    """add_particles after the first frame lands on the slabs: none lost."""
    for r in runs["port"]:
        src = r["source"]
        assert src["counts"] == [250, 250]
        assert src["positions"].shape == src["velocities"].shape == (250, 3)
        assert np.isfinite(src["positions"]).all() and np.isfinite(src["energy"])
    e = [r["source"]["energy"] for r in runs["port"]]
    assert e[0] == e[1]


def test_load_of_mpm_snapshot(runs):
    """A one-device snapshot resumes on two ranks: its next frame matches
    MPM's resumed frame within the frame bounds; the slabs' own snapshot
    (rank 0 writes it) resumes on one device; the BGEO is rank 0's."""
    for r in runs["port"]:
        assert r["load"]["t"] == float(runs["resumed_t"])
        assert_close(runs["resumed"], r["load"])
    d = runs["dir"]
    assert (d / "slabs_rank0.bgeo").exists() and not (d / "slabs_rank1.bgeo").exists()
    sim = crossing_scene(MPM, device="cpu", capacity=4096)  # the slabs' lanes, all ranks'
    load_checkpoint(str(d / "slabs.npz"), sim)
    assert sim.particle_count() == N_PARTICLES
    assert_close(runs["port"][0]["load"], convert.particles_to_numpy(sim.particles),
                 dict.fromkeys(FRAME_BOUNDS, 0.0))


def test_runner_with_shards(runs):
    """runner.main under SHARDS=2 in a two-rank group: DistributedMPM, two
    frames of colliding_balls_energy at res 32, frames written by rank 0."""
    from taichi_mpm_torch import scenes

    n = scenes.colliding_balls_energy(res=32, device="cpu").particle_count()
    for r in runs["port"]:
        assert r["runner"]["type"] == "DistributedMPM"
        assert r["runner"]["count"] == n and r["runner"]["positions"].shape == (n, 3)
        assert np.isfinite(r["runner"]["energy"])
    out = runs["dir"] / "runner"
    assert (out / "00000.bgeo").exists() and (out / "00001.bgeo").exists()
