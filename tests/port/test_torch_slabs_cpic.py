"""``DistributedMPM`` with rigid bodies (CPIC) on slabs: the port's on two
gloo ranks on the CPU (one spawned group for the file,
``slab_ranks.cpic_scenes``) against the JAX package's ``DistributedMPM``
on 2 of the 8 virtual CPU devices (one run, made while the ranks work:
the default route, fused and balanced, on the plate scene of
tests/test_distributed_driver.py:79-121), and the port's three CPIC slab
frames against its own ``MPM`` CPIC frames.

Scenes (``slab_ranks``): the plate scene, whose plate straddles the slab
boundary (scripted for the JAX run, free to turn for the others); a left
cluster cut by a plate at 20 m/s, where the balanced bound moves and
particles migrate both ways; a free plate inside rank 0's slab, so that
rank 1 has particles and an empty near set; and ``scenes.water_wheel``
through the runner with SHARDS=2 (res 32, 2 frames of 2e-3 s with its
source; the water does not reach the wheel that soon). Particles are
matched by an index tag.

Bounds: against JAX's slabs the CPIC bounds of
tests/test_cpic_packed.py (x 5e-6, v 5e-4, F 5e-5, states and near_b
equal, body vel and omega 1e-5); against the port's one-device frames
the bounds JAX holds between its own slabs and one device
(tests/test_spatial_blocked.py:285-353: x 1e-5, v 5e-4, body vel 1e-5),
omega 1e-5 too. The replicated bodies must be equal in bits on both
ranks after every frame, a save and resume must give the
uninterrupted run's bits, and a source after the first frame must leave
the bodies as on ``MPM``.
"""

import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_helpers import assert_close_by_id, by_id, max_err
from slab_ranks import BODY_FIELDS, CPIC_ROUTES, CPIC_SCENES, cpic_scenes, plate_scene
from taichi_mpm_torch import MPM, convert
from taichi_mpm_torch.parallel import comm
from taichi_mpm_torch.rigid import cpic_blocked as tcb
from taichi_mpm_torch.rigid import cpic_packed as tcp
from taichi_mpm_torch.rigid.mesh import plate_mesh
from taichi_mpm_tpu import DistributedMPM as JDistributedMPM
from taichi_mpm_tpu.rigid.mesh import plate_mesh as jplate_mesh

torch.set_num_threads(1)

JAX_BOUNDS = dict(x=5e-6, v=5e-4, F=5e-5)
JAX_BODY = 1e-5
MPM_BOUNDS = dict(x=1e-5, v=5e-4)
MPM_BODY = 1e-5


def assert_close(a, b, bounds, equal=()):
    assert_close_by_id(SimpleNamespace(**a), SimpleNamespace(**b), bounds, equal)


def body_errors(a, b):
    return {k: max_err(np.asarray(a[k]), np.asarray(b[k])) for k in ("vel", "omega")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the one JAX DistributedMPM run, made while
    the ranks work."""
    d = tmp_path_factory.mktemp("cpic_slabs")
    out = {}

    def ranks():
        try:
            out["port"] = comm.run_ranks(cpic_scenes, 2, "gloo", args=(str(d),), timeout_s=240)
        except Exception as e:  # re-raised below, in the test's thread
            out["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    old = os.environ.get("TMT_FUSED")
    os.environ["TMT_FUSED"] = "1"
    try:
        jsim = plate_scene(JDistributedMPM, jplate_mesh, n_shards=2)
        jsim.step()
    finally:
        if old is None:
            os.environ.pop("TMT_FUSED", None)
        else:
            os.environ["TMT_FUSED"] = old
    jax_out = dict(convert.particles_to_numpy(jsim.particles),
                   bodies={k: np.asarray(getattr(jsim.bodies, k)) for k in BODY_FIELDS},
                   bounds=tuple(int(b) for b in np.asarray(jsim._bal[0])), t=float(jsim.t))
    th.join(timeout=300)
    assert not th.is_alive(), "the ranks outlived their timeout"
    if "error" in out:
        raise out["error"]
    r0, r1 = out["port"]
    return dict(port=out["port"], jax=jax_out, mpm=dict(r0["mpm"], **r1["mpm"]), dir=d)


def test_default_route_matches_jax(runs):
    """The plate scene on balanced fused slabs, the port's two ranks
    against JAX's two devices: the same particles within the CPIC bounds,
    states and near_b equal, the bodies within 1e-5, the same bounds."""
    r0, r1 = (r["jax_plate"] for r in runs["port"])
    assert r0["fused"] and r0["balanced"] and r0["count"] == 400
    assert r0["n_near"] > 0 and r1["n_near"] > 0  # the plate reaches into both slabs
    assert r0["bounds"][-1] == runs["jax"]["bounds"]
    assert r0["t"] == runs["jax"]["t"]
    assert_close(runs["jax"], r0, JAX_BOUNDS, equal=("states", "near_b"))
    for k, err in body_errors(runs["jax"]["bodies"], r0["bodies"][-1]).items():
        assert err <= JAX_BODY, (k, err)


@pytest.mark.parametrize("scene", list(CPIC_SCENES))
@pytest.mark.parametrize("route", list(CPIC_ROUTES))
def test_slab_frames_match_mpm(runs, scene, route):
    """Each scene on each slab frame (the packed frame on balanced and on
    uniform bounds, the pytree frame on uniform bounds) against the
    port's MPM on that route: particles within x 1e-5, v 5e-4, bodies'
    vel and omega within 1e-5; every particle kept."""
    fused, balanced = CPIC_ROUTES[route]
    r0 = runs["port"][0][f"{scene}_{route}"]
    ref = runs["mpm"][f"{scene}_{int(fused)}"]
    assert (r0["fused"], r0["balanced"]) == (fused, balanced)
    assert r0["count"] == int(ref["active"].sum())
    assert_close(ref, r0, MPM_BOUNDS)
    for k, err in body_errors(ref["bodies"], r0["bodies"][-1]).items():
        assert err <= MPM_BODY, (k, err)


def test_scenes_reach_their_cases(runs):
    """The scenes do what they are there for: the free plates turn, with
    impulses from both ranks on the straddling one and from rank 0 alone
    on the one inside its slab (rank 1's near set empty, its slab not);
    the cluster's balanced bound moves and its particles cross both ways."""
    ranks = runs["port"]
    mpm = runs["mpm"]
    assert np.abs(mpm["plate_free_1"]["bodies"]["omega"]).max() > 1e-3
    assert all(r["plate_free_fused_uniform"]["n_near"] > 0 for r in ranks)
    assert np.abs(mpm["island_1"]["bodies"]["omega"]).max() > 1e-5
    for route in CPIC_ROUTES:
        assert ranks[0][f"island_{route}"]["n_near"] > 0
        assert ranks[1][f"island_{route}"]["n_near"] == 0
        assert ranks[1][f"island_{route}"]["count"] == 400
    bal = [r["cluster_fused_balanced"] for r in ranks]
    assert len(set(bal[0]["bounds"])) > 1, bal[0]["bounds"]
    assert bal[0]["sent"][1] > 0 and bal[1]["sent"][0] > 0
    assert all(r["n_near"] > 0 for r in bal)


def test_bodies_equal_across_ranks(runs):
    """The replicated bodies hold the same bits on both ranks after every
    frame of every run."""
    r0, r1 = runs["port"]
    keys = ["jax_plate"] + [f"{s}_{r}" for s in CPIC_SCENES for r in CPIC_ROUTES]
    for key in keys:
        assert len(r0[key]["bodies"]) == len(r1[key]["bodies"]) > 0
        for f, (a, b) in enumerate(zip(r0[key]["bodies"], r1[key]["bodies"])):
            for name in BODY_FIELDS:
                assert np.array_equal(a[name], b[name]), (key, f, name)


def test_unfused_indivisible_res_raises(runs):
    """TMT_FUSED=0 routes a CPIC scene to the uniform pytree frame, which
    needs res[0] in whole blocks per slab: res[0] = 36 on two ranks raises
    the JAX driver's ValueError (taichi_mpm_tpu/parallel/driver.py:296-302)."""
    for r in runs["port"]:
        msg = r["indivisible"]
        assert msg is not None and msg.startswith(
            "TMT_FUSED=0 routes CPIC scenes to the uniform-slab pytree frame: res[0]=36")


def test_save_and_resume_bits(runs):
    """A CPIC slab scene saved after frame 1 (particles and bodies, by rank
    0) and resumed by a fresh scene on both ranks steps frame 2 to the
    uninterrupted run's bits. The resumed frame's first re-sort moves no
    particle (the snapshot's split puts each on the rank that held it),
    so both runs sort the same lanes in the same order."""
    for r in runs["port"]:
        res = r["resume"]
        assert res["migrants"][:2] == (0, 0)
        a, b = by_id(SimpleNamespace(**res["uninterrupted"])), by_id(SimpleNamespace(**res["resumed"]))
        for name in a:
            assert np.array_equal(a[name], b[name]), name
        for name in BODY_FIELDS:
            assert np.array_equal(res["uninterrupted"]["bodies"][name],
                                  res["resumed"]["bodies"][name]), name


def test_water_wheel_runner_with_shards(runs):
    """runner.main water_wheel under SHARDS=2: DistributedMPM on two ranks,
    the source's particles as many as MPM's, the bodies as MPM's and equal
    on both ranks, frames and the wheel's meshes written by rank 0. In
    these 4 ms the water does not reach the paddles, so the bodies stay
    at rest: the coupling on this scene is held to MPM's on the card
    (chip_smoke.py's water_wheel_slabs, from a state with the water on
    the paddles)."""
    ref = runs["mpm"]["water_wheel"]
    assert ref["type"] == "MPM" and ref["count"] > 0
    for r in runs["port"]:
        ww = r["water_wheel"]
        assert ww["type"] == "DistributedMPM" and ww["count"] == ref["count"]
        assert ww["positions"].shape == (ref["count"], 3)
        assert max_err(ww["bodies"]["omega"], ref["bodies"]["omega"]) <= MPM_BODY
    a, b = (r["water_wheel"]["bodies"] for r in runs["port"])
    assert all(np.array_equal(a[k], b[k]) for k in BODY_FIELDS)
    out = runs["dir"] / "ww_slabs"
    assert (out / "00001.bgeo").exists() and (out / "00001_rigid_2.obj").exists()


def test_source_keeps_the_bodies(runs):
    """A source after the first frame (the global set gathered, the batch
    written, the set split again) leaves the replicated bodies as they
    were: the free plate of the island scene goes on turning as on MPM
    (omega within 1e-5), on both ranks in the same bits, and every
    particle arrives."""
    ref = runs["mpm"]["island_source"]
    assert ref["count"] == 460
    assert np.abs(ref["bodies"]["omega"]).max() > 1e-5
    for r in runs["port"]:
        got = r["island_source"]
        assert got["count"] == ref["count"]
        for k, err in body_errors(ref["bodies"], got["bodies"]).items():
            assert err <= MPM_BODY, (k, err)
    a, b = (r["island_source"]["bodies"] for r in runs["port"])
    assert all(np.array_equal(a[k], b[k]) for k in BODY_FIELDS)


def _substep_pair(fused):
    """One coupled substep of the plate scene with no hooks and with
    identity hooks (the slab hooks at a zero offset: lcfg the scene's
    config, world_off 0, the origins and colliders as they are, an
    identity exchange and sum). Returns the two outputs."""
    sim = plate_scene(MPM, plate_mesh, free=True, device="cpu")
    sim._finalize()
    cfg, scene = sim.cfg, sim.rigid_scene
    caps = tcp.Capacities(sim._rigid_map_cap())
    hooks = dict(lcfg=cfg, world_off=torch.zeros(3), grid_colliders=scene.colliders,
                 exchange_fn=lambda rec: rec, sum_fn=lambda x: x + 0.0)
    outs = []
    for kw in ({}, hooks):
        if fused:
            st, _, pm, _ = tcp.cpic_packed_pack_carry(sim.particles, cfg, 256)
            outs.append(tcp.cpic_packed_substep_presorted(st, pm, sim.bodies, np.float32(0.0), cfg,
                                                          scene, cfg.base_dt, caps, **kw))
        else:
            p, _, pm, _ = tcb.cpic_pack_carry(sim.particles, cfg, 256)
            if kw:
                kw = dict(kw, origin=pm["origin"] + torch.zeros(3))
            outs.append(tcb.cpic_blocked_substep_presorted(p, pm, sim.bodies, np.float32(0.0), cfg,
                                                           scene, cfg.base_dt, caps, **kw))
    return outs


def _fields(state):
    """A substep's particle state as named tensors: the packed rows, or a
    Particles set's fields."""
    if isinstance(state, torch.Tensor):
        return {"rows": state}
    return {f: getattr(state, f) for f in ("x", "v", "F", "C", "states", "bdist", "near_b")}


@pytest.mark.parametrize("fused", [True, False])
def test_hooks_absent_keep_one_device_bits(fused):
    """The single-device CPIC substeps with the slab hooks absent give the
    bits of the hooked code at a zero offset: the hooks add nothing to one
    device's arithmetic (that the hookless substep gives the parent
    tree's bits was checked when the hooks came in: CHANGES.md)."""
    (a, *ca), (b, *cb) = _substep_pair(fused)
    assert ca[:3] == cb[:3]  # n_near, n_coarse, n_r
    assert ca[0] > 0
    fa, fb = _fields(a[0]), _fields(b[0])
    for name in fa:
        assert torch.equal(fa[name], fb[name]), name
    for name in BODY_FIELDS:
        assert torch.equal(getattr(a[1], name), getattr(b[1], name)), name
