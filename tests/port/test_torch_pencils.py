"""``DistributedMPM(mesh_shape=(2, 2))``, the pencil mesh: the port's on
four gloo ranks on the CPU (one spawned group for the file,
``pencil_ranks.pencils``) against the JAX package's ``DistributedMPM``
on 4 of the 8 virtual CPU devices (one run, made while the ranks work:
the default route, fused and balanced, on
tests/test_distributed_driver.py:17-28's scene), and the port's frames
on every pencil route against its own ``MPM``.

Scenes (``taichi_mpm_torch.scenes``): ``driver_jelly`` (600 jelly
particles at 1 m/s along x, res 32) for JAX and the snapshots;
``pencil_drift`` (tests/test_spatial_mesh2d.py:22-31: 700 particles at
(1.5, 1.0, 0), crossing both axes) on the four plain routes;
``corner_crossing`` (two blobs crossing both axes at once) on uniform
fused pencils; ``corner_cluster`` (tests/test_spatial_mesh2d.py:143-160)
on the balanced routes, whose bounds move toward the cluster on both
axes; the
free plate of ``plate_scene`` (tests/test_distributed_driver.py:153-168
with the plate's rotation free) on the three CPIC pencil frames.
Particles are matched by an index tag.

Bounds: the port's frame bounds (``port_helpers.FRAME_BOUNDS``, x 5e-6,
v 5e-5, F 5e-6, C 5e-4, aux 5e-6) for plain scenes, against JAX's
pencils and against the port's one-device frames; the CPIC bounds (x
5e-6, v 5e-4, F 5e-5; bodies' vel and omega 1e-5, pos 1e-6) for the
plate. A node that takes mass from two pencils is summed as (a + b) +
(c + d) there and in one merge on one device, so the pencils' bits
differ from one device's; the replicated bodies must be equal in bits
on all four ranks. The host helpers are held to JAX's exactly."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pencil_ranks import CLUSTER_ROUTES, MESH, pencils
from port_helpers import (BODY_BOUNDS, CPIC_BOUNDS, FRAME_BOUNDS, ID_SLOT, assert_close_by_id,
                          configs, max_err, scene_arrays, tag_ids)
from slab_ranks import BODY_FIELDS, CPIC_ROUTES, ROUTES
from taichi_mpm_torch import MPM, convert, scenes
from taichi_mpm_torch.io.checkpoint import load_checkpoint
from taichi_mpm_torch.parallel import comm
from taichi_mpm_torch.parallel import spatial_mesh2d as sm
from taichi_mpm_tpu import DistributedMPM as JDistributedMPM
from taichi_mpm_tpu.core import levelset as jlevelset

torch.set_num_threads(1)

EXCHANGE_SEED = 5


def assert_close(a, b, bounds=FRAME_BOUNDS):
    assert_close_by_id(SimpleNamespace(**a), SimpleNamespace(**b), bounds)


def migration_inputs(cfg):
    """Four ranks' lanes, one after another: rank 0 (pencil (0, 0)) holds
    10 of its own, 5 for (1, 1), 3 for (1, 0) and 2 for (0, 1), with 4
    free lanes; rank 1 ((0, 1)) 6 of its own and 4 for (1, 0), 2 free;
    rank 2 ((1, 0)) 8 and 2 free; rank 3 ((1, 1)) 8 and none free. The
    diagonal movers pass through a pencil that has too few free lanes
    for its arrivals. Returns (arrays, caps, cfg)."""
    where = {0: [((0.25, 0.25), 10), ((0.75, 0.75), 5), ((0.75, 0.25), 3), ((0.25, 0.75), 2)],
             1: [((0.25, 0.75), 6), ((0.75, 0.25), 4)], 2: [((0.75, 0.25), 8)],
             3: [((0.75, 0.75), 8)]}
    caps = (24, 12, 10, 8)
    a, _ = scene_arrays(n=sum(caps), seed=3, lo=0.2, hi=0.3, cap_extra=0)
    a = tag_ids(a)
    a["active"][:] = False
    first = 0
    rng = np.random.default_rng(4)
    for r, cap in enumerate(caps):
        i = first
        for (x, y), n in where[r]:
            a["x"][i:i + n, :2] = (x, y) + rng.uniform(-0.05, 0.05, (n, 2))
            a["active"][i:i + n] = True
            i += n
        first += cap
    return a, caps, cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the one JAX DistributedMPM run (made while the
    ranks work), and the one-device frames the snapshots need."""
    d = tmp_path_factory.mktemp("pencils")
    snap = str(d / "mpm.npz")
    mpm = scenes.driver_jelly(MPM, device="cpu")
    mpm.step()
    mpm.save(snap)
    cfg = configs(("jelly",))[1]
    dense, _ = scene_arrays(n=4000, seed=2, lo=0.1, hi=0.9)
    prim = dict(exchange=(dense, cfg, EXCHANGE_SEED), migration=migration_inputs(cfg))
    out = {}

    def ranks():
        try:
            out["port"] = comm.run_ranks(pencils, 4, "gloo", args=(prim, snap, str(d)),
                                         timeout_s=300)
        except Exception as e:  # re-raised below, in the test's thread
            out["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    jsim = scenes.driver_jelly(JDistributedMPM, ls=jlevelset, mesh_shape=MESH)
    assert jsim.mesh2d and jsim.balanced and (jsim.rx, jsim.ry) == (1, 1)
    jsim.step()
    jsim.step()
    jax_out = dict(convert.particles_to_numpy(jsim.particles),
                   bounds=tuple(tuple(int(b) for b in np.asarray(jsim._bal[i])) for i in (0, 1)),
                   t=float(jsim.t))
    mpm.load(snap)
    mpm.step()
    th.join(timeout=360)
    assert not th.is_alive(), "the ranks outlived their timeout"
    if "error" in out:
        raise out["error"]
    ranks_out = out["port"]
    refs = {}
    for r in ranks_out:
        refs.update(r["mpm"])
    return dict(port=ranks_out, jax=jax_out, mpm=refs, dir=d, prim=prim,
                resumed=convert.particles_to_numpy(mpm.particles), resumed_t=float(mpm.t))


def test_default_route_matches_jax(runs):
    """driver_jelly on balanced fused pencils, the port's four ranks against
    JAX's four devices, 2 frames: the same particles within the frame
    bounds, the same bounds on both axes; every rank gathers the same
    global set."""
    r0 = runs["port"][0]["jax"]
    assert r0["fused"] and r0["balanced"] and (r0["rx"], r0["ry"]) == (1, 1)
    assert r0["count"] == 600 and r0["t"] == runs["jax"]["t"]
    assert r0["bounds"][-1] == runs["jax"]["bounds"]
    assert_close(runs["jax"], r0)
    for r in runs["port"][1:]:
        for k in ("x", "v", "F", "C", "active", "params"):
            assert np.array_equal(r0[k], r["jax"][k]), k


@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_match_mpm(runs, route):
    """pencil_drift on each plain pencil route against the port's MPM on
    that route, within the frame bounds; every particle kept."""
    fused, balanced = ROUTES[route]
    r0 = runs["port"][0][f"drift_{route}"]
    assert (r0["fused"], r0["balanced"]) == (fused, balanced)
    assert r0["count"] == 700
    assert_close(runs["mpm"][f"drift_{int(fused)}"], r0)


def test_particles_cross_both_axes(runs):
    """pencil_drift's frames migrate particles along x and along y on every
    route; corner_crossing's re-sorts move particles from (0, 0) to (1, 1)
    and from (0, 1) to (1, 0) (diagonal migrants, forwarded within one
    re-sort), and its frames match MPM's within the frame bounds."""
    for route in ROUTES:
        ranks = [r[f"drift_{route}"] for r in runs["port"]]
        assert sum(sum(r["sent_x"]) for r in ranks) > 0, route
        assert sum(sum(r["sent_y"]) for r in ranks) > 0, route
    ranks = [r["crossing"] for r in runs["port"]]
    assert ranks[0]["diagonal"] > 0 and ranks[1]["diagonal"] > 0
    assert ranks[2]["sent_y"][1] > 0 and ranks[3]["sent_y"][0] > 0  # forwarded along y
    assert ranks[0]["count"] == 1200
    assert_close(runs["mpm"]["crossing_1"], ranks[0])


def test_corner_block_of_diagonal_pencils(runs):
    """diagonal_pair: the corner nodes take mass from pencils (0, 0) and
    (1, 1) alone, and the pencils between them hold no particle; the
    frame still gives MPM's particles within the frame bounds (the pencil
    between passes the part it does not hold on along y)."""
    ranks = [r["pair"] for r in runs["port"]]
    assert [r["local_start"] for r in ranks] == [200, 0, 0, 200]
    assert ranks[0]["count"] == 400
    assert_close(runs["mpm"]["pair_1"], ranks[0])


@pytest.mark.parametrize("route", list(CLUSTER_ROUTES))
def test_corner_cluster_bounds_and_frames(runs, route):
    """corner_cluster on balanced pencils (r = 3): the bounds of both axes
    start and stay biased toward the cluster (tests/test_spatial_mesh2d.py
    :171-176), the frames match MPM's within the frame bounds, every
    particle kept."""
    fused, _ = CLUSTER_ROUTES[route]
    r0 = runs["port"][0][f"cluster_{route}"]
    assert r0["balanced"] and (r0["rx"], r0["ry"]) == (3, 3)
    bx0, by0 = r0["bounds"][0]
    assert bx0[1] < 8 and by0[1] < 8
    bx, by = r0["bounds"][-1]
    assert bx[0] == 0 and bx[-1] == 16 and by[0] == 0 and by[-1] == 16
    assert bx[1] <= 7 and by[1] <= 7
    assert r0["count"] == 800
    assert_close(runs["mpm"][f"cluster_{int(fused)}"], r0)


def test_migration_forwards_diagonal_movers(runs):
    """One re-sort's migration on the (2, 2) mesh: rank 0's movers to
    (1, 1) reach rank 3 through rank 2 and rank 1's movers to (1, 0) reach
    rank 2 through rank 3, every particle on its pencil's rank, none lost,
    and the ranks whose arrivals outnumber their free lanes grow."""
    arrays, caps, cfg = runs["prim"]["migration"]
    got = [r["migration"] for r in runs["port"]]
    ids = np.sort(np.concatenate([g["params"][g["active"], ID_SLOT] for g in got]))
    assert np.array_equal(ids, np.sort(arrays["params"][arrays["active"], ID_SLOT]))
    for r, g in enumerate(got):
        x = g["x"][g["active"]]
        assert np.all(((x[:, 0] >= 0.5) * 2 + (x[:, 1] >= 0.5)) == r), r
    assert [g["diagonal"] for g in got] == [5, 4, 0, 0]
    assert got[0]["sent_x"] == (0, 8) and got[0]["sent_y"] == (0, 2)
    assert got[1]["sent_x"] == (0, 4) and got[3]["sent_y"] == (4, 0)
    assert got[2]["sent_y"] == (0, 5)
    assert [int(g["active"].sum()) for g in got] == [10, 8, 15, 13]
    assert got[2]["grown"] > 0 and got[3]["grown"] > 0
    diag = set(arrays["params"][10:15, ID_SLOT])
    assert diag <= set(got[3]["params"][got[3]["active"], ID_SLOT])


def test_exchange_sums_every_copy(runs):
    """The record exchange on a res-32 (2, 2) layout of 4,000 particles:
    every rank's copy of every block, corners shared by four pencils
    included, holds the sum over the ranks that hold the block, within
    one float32 rounding; the ghost planes outside the domain (on sx = 0
    and sy = 0) hold zeros."""
    got = [r["exchange"] for r in runs["port"]]
    total = {}
    for g in got:
        for blk, rec in zip(map(tuple, g["block"]), g["before"]):
            total[blk] = total.get(blk, 0.0) + rec.astype(np.float64)
    owners = {}
    for g in got:
        for blk in map(tuple, g["block"]):
            owners[blk] = owners.get(blk, 0) + 1
    assert max(owners.values()) == 4  # corner blocks, on every rank
    for r, g in enumerate(got):
        for blk, rec in zip(map(tuple, g["block"]), g["after"]):
            if blk[0] < 0 or blk[1] < 0:
                assert not rec.any(), (r, blk)
            else:
                np.testing.assert_allclose(rec, total[blk], rtol=2.0 ** -22, err_msg=str(blk))
    assert any(b[0] < 0 for b in map(tuple, got[0]["block"]))
    assert any(b[1] < 0 for b in map(tuple, got[0]["block"]))


@pytest.mark.parametrize("route", list(CPIC_ROUTES))
def test_cpic_pencils_match_mpm(runs, route):
    """The free plate on each CPIC pencil frame (the packed frame on
    balanced and on uniform bounds, the pytree frame on uniform bounds)
    against the port's MPM on that route, 2 frames: particles within the
    CPIC bounds, the bodies within theirs; every particle kept."""
    fused, balanced = CPIC_ROUTES[route]
    r0 = runs["port"][0][f"plate_{route}"]
    ref = runs["mpm"][f"plate_{int(fused)}"]
    assert (r0["fused"], r0["balanced"]) == (fused, balanced)
    assert r0["count"] == 400
    assert_close(ref, r0, CPIC_BOUNDS)
    for k, bound in BODY_BOUNDS.items():
        err = max_err(ref["bodies"][k], r0["bodies"][-1][k])
        assert err <= bound, (k, err)
    assert np.abs(ref["bodies"]["omega"]).max() > 1e-3  # the plate turns


def test_corner_plate_matches_mpm(runs):
    """The free plate across the corner of the four uniform pencils (fused
    route): every rank's near set holds particles, so the impulses are a
    sum of four ranks' parts; particles and bodies within the CPIC bounds
    of MPM's."""
    ranks = [r["corner_plate"] for r in runs["port"]]
    assert all(r["n_near"] > 0 for r in ranks)
    ref = runs["mpm"]["corner_plate_1"]
    assert_close(ref, ranks[0], CPIC_BOUNDS)
    for k, bound in BODY_BOUNDS.items():
        err = max_err(ref["bodies"][k], ranks[0]["bodies"][-1][k])
        assert err <= bound, (k, err)
    assert np.abs(ref["bodies"]["omega"]).max() > 1e-3


def test_bodies_equal_on_all_ranks(runs):
    """The replicated bodies hold the same bits on all four ranks after
    every frame of every CPIC run, the corner plate's among them, whose
    impulses come from all four."""
    for key in [f"plate_{route}" for route in CPIC_ROUTES] + ["corner_plate"]:
        ranks = [r[key] for r in runs["port"]]
        for r in ranks[1:]:
            assert len(r["bodies"]) == len(ranks[0]["bodies"]) > 0
            for a, b in zip(ranks[0]["bodies"], r["bodies"]):
                for name in BODY_FIELDS:
                    assert np.array_equal(a[name], b[name]), (key, name)


def test_unfused_balanced_cpic_refused(runs):
    """TMT_FUSED=0 on balanced pencils with a body raises the JAX driver's
    ValueError (taichi_mpm_tpu/parallel/driver.py:265-270)."""
    for r in runs["port"]:
        assert r["refused"] is not None and r["refused"].startswith(
            "TMT_FUSED=0 routes CPIC pencil scenes to the uniform frame")


def test_snapshots_cross_layouts(runs):
    """A one-device snapshot resumes on pencils: its next frame matches
    MPM's resumed frame within the frame bounds; the pencils' own
    snapshot (rank 0 writes it) resumes on one device with their bits."""
    for r in runs["port"]:
        assert r["load"]["t"] == runs["resumed_t"]
        assert_close(runs["resumed"], r["load"])
    sim = scenes.driver_jelly(MPM, device="cpu", capacity=4096)
    load_checkpoint(str(runs["dir"] / "pencils.npz"), sim)
    assert sim.particle_count() == 600
    assert_close(runs["port"][0]["load"], convert.particles_to_numpy(sim.particles),
                 dict.fromkeys(FRAME_BOUNDS, 0.0))


def test_mesh_choices(runs):
    """The JAX driver's choices (taichi_mpm_tpu/parallel/driver.py:76-105):
    r clamped to each axis's largest (res 32 on 2 pencils allows 1); no
    room on an axis (res 24: r_max 0) or balanced=False gives uniform
    pencils; uniform pencils need res[ax] in whole blocks per pencil (res
    36 on 2 pencils is balanced, with r = 1, and refused uniform)."""
    for r in runs["port"]:
        c = r["choices"]
        assert c["r5"] == (True, True, 1, 1)
        assert c["res24"] == (True, False, None, None)
        assert c["uniform"] == (True, False, None, None)
        assert c["res36"] == (True, True, 1, 1)
        assert c["res36_uniform"] == "res[0]=36 must divide into whole blocks per pencil (4*2)"


def test_one_rank_mesh_matches_mpm():
    """A (1, 1) mesh (a group of one, in this process) against MPM on both
    routes: MPM's bits on the fused route, within the frame bounds on the
    unfused one (a one-rank slab's unfused frame parts from MPM's by an
    ulp on this scene too); a mesh that does not hold the group raises."""
    from taichi_mpm_torch.parallel.driver import DistributedMPM

    for fused in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TMT_FUSED", "1" if fused else "0")
            ref = scenes.pencil_drift(MPM, device="cpu")
            ref.step()
            with comm.process_group("gloo", 0, 1, comm.free_port(), timeout_s=60):
                sim = scenes.pencil_drift(DistributedMPM, device="cpu", mesh_shape=(1, 1))
                sim.step()
                assert sim.mesh2d and sim.balanced
                out = convert.particles_to_numpy(sim._gather())
                with pytest.raises(ValueError, match="must hold"):
                    DistributedMPM(res=(32, 32, 32), device="cpu", mesh_shape=(2, 2))
        assert_close(convert.particles_to_numpy(ref.particles), out,
                     dict.fromkeys(FRAME_BOUNDS, 0.0) if fused else FRAME_BOUNDS)


def test_host_helpers_match_jax():
    """pencil_cells, local_config, balanced_params2d, the offsets,
    balanced_bounds2d_host and shard_pencils(_bounds) on corner_cluster's
    particles against JAX's, exactly: the same bounds (r = 3), configs and
    each rank's part of JAX's global layout, lane for lane."""
    import jax
    from jax.sharding import Mesh

    from taichi_mpm_tpu.core.solver import MPM as JMPM
    from taichi_mpm_tpu.parallel import spatial_mesh2d as jsm

    jsim = scenes.corner_cluster(JMPM, ls=jlevelset)
    jsim._finalize()
    tsim = scenes.corner_cluster(MPM, device="cpu")
    tsim._finalize()
    arrays = convert.particles_to_numpy(jsim.particles)
    jp = jax.tree.map(np.asarray, jsim.particles)
    tp = convert.particles_from_numpy(arrays)
    jcfg, tcfg = jsim.cfg, tsim.cfg
    for ax in (0, 1):
        assert sm.pencil_cells(tcfg, MESH, ax) == jsm.pencil_cells(jcfg, MESH, ax)
    assert sm.local_config(tcfg, MESH).res == jsm.local_config(jcfg, MESH).res
    for s in range(4):
        sx, sy = divmod(s, 2)
        want = [float(v) for v in jsm.shard_offsets_cells(np.int32(sx), np.int32(sy), jcfg, MESH)]
        assert [float(v) for v in sm.shard_offsets_cells(sx, sy, tcfg, MESH)] == want
    jpar = jsm.balanced_params2d(jcfg, MESH, 3, 3)
    tpar = sm.balanced_params2d(tcfg, MESH, 3, 3)
    assert jpar[:2] == tpar[:2] and jpar[4].res == tpar[4].res
    for a, b in zip(jpar[2:4], tpar[2:4]):
        assert np.array_equal(a, b)
    jb = jsm.balanced_bounds2d_host(jp, jcfg, MESH, 3, 3)
    tb = sm.balanced_bounds2d_host(tp, tcfg, MESH, 3, 3)
    assert all(np.array_equal(a, b) for a, b in zip(jb, tb))
    assert jb[0][1] < 8 and jb[1][1] < 8
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(MESH), ("x", "y"))
    splits = {"bounds": (jsm.shard_pencils_bounds(jp, jcfg, mesh, *jb, slack=2.5),
                         lambda s: sm.shard_pencils_bounds(tp, tcfg, MESH, s, *tb, 2.5)),
              "uniform": (jsm.shard_pencils(jp, jcfg, mesh, slack=1.5),
                          lambda s: sm.shard_pencils(tp, tcfg, MESH, s, 1.5))}
    for name, (jglobal, port_part) in splits.items():
        ja = convert.particles_to_numpy(jglobal)
        cap = ja["x"].shape[0] // 4
        for s in range(4):
            part, pcap = port_part(s)
            assert pcap == cap, name
            pa = convert.particles_to_numpy(part)
            for k, v in pa.items():
                assert np.array_equal(v, ja[k][s * cap:(s + 1) * cap]), (name, s, k)
