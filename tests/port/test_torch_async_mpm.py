"""Port vs JAX: ``AsyncMPM(per_block=True)``, the bucketed frame at
natural levels, and ``visualize_scheduler``.

The scene of tests/test_adaptive.py::TestPerBlockDriver: 900 soft (E
4e3) and 300 stiff (E 4e5) elastic particles in a res-32 box without
gravity, frame 6.4e-3 s, unit 1e-4 s. The JAX AsyncMPM's step runs
``bucketed_frame``, jitted, with budgets it sizes from the first sort;
the budgets size only its buffers (a frame that overflows them is re-run
larger), so this file gives the frame the largest ones (every lane, the
whole page map), compiles it once, returning the frame's re-sort count
as well, which the driver drops, and runs it three times: the driver's
two frames, and a third from the first frame's state moving at 5 m/s,
which re-sorts mid-frame. Held: the port's AsyncMPM over the two
frames (the update counter equal, the particles within the frame bounds
of tests/test_fused.py, matched by an id tag), and the port's
``bucketed_frame`` on the third frame's input (the update count and the
re-sort count equal, the state within those bounds). The JAX frame's
capacity has pad lanes (1,200 of 1,536), see test_torch_async_bucketed.py.

``visualize_scheduler`` in both modes against the JAX package's BGEO on
tests/test_adaptive.py::TestSchedulerVisualize's scene; and the
per-block scheduler's refusals (2-D scenes, rigid bodies), which the
JAX package asserts.

``DistributedAsyncMPM`` on two gloo ranks (one spawned group,
``slab_ranks.async_slabs``) against the same JAX frames, the third
frame's re-sort included: JAX's own contract between its
``DistributedAsyncMPM`` and ``AsyncMPM(per_block=True)``
(parallel/async_spatial.py:31-33, tests/test_async_spatial.py:141-174):
the update counter equal, x within 1e-5 and v within 5e-4, no particle
lost. No JAX slab frame runs here (one compiles for minutes on the
CPU). Besides: the sharded levels equal the one-device levels integer
for integer; the schedule and the level histograms equal the port's
one-device frame's; a blob crossing x = 0.5 (re-sorts and migrants) and
the dam with its right slab empty against the port's ``AsyncMPM``; the
one-device frame run through the slab hooks, made trivial, keeps its
bits; and ``DistributedAsyncMPM``'s refusals, with JAX's messages.
"""

import dataclasses
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taichi_mpm_tpu.core.adaptive import AsyncMPM as JAsyncMPM
from taichi_mpm_tpu.io.bgeo import read_bgeo
from taichi_mpm_tpu.ops import async_bucketed as jab
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import convert, scenes
from taichi_mpm_torch.core.adaptive import AsyncMPM
from taichi_mpm_torch.ops import async_bucketed as tab
from taichi_mpm_torch.ops import blocked, packed
from taichi_mpm_torch.parallel import comm

from port_helpers import ID_SLOT, assert_close_by_id, tag_ids
from slab_ranks import BLOBS, add_blobs, async_slabs

torch.set_num_threads(1)

KW = dict(BLOBS, per_block=True)
SLAB_BOUNDS = dict(x=1e-5, v=5e-4)  # tests/test_async_spatial.py's, slabs vs one device
_add_blobs = add_blobs


def _numpy_of_jax(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


def _jax_of_numpy(jp, a):
    return dataclasses.replace(jp, **{k: jnp.asarray(v) for k, v in a.items()})


def _jax_unit(jsim):
    """The unit of the JAX driver's _build_bucketed_jit
    (taichi_mpm_tpu/core/adaptive.py:313-315)."""
    m = max(1, round(jsim.frame_dt / (jsim.unit_delta_t * (1 << jab.MAXLEV))))
    return jsim.frame_dt / (m * (1 << jab.MAXLEV))


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX driver's frame compiled once, three frames."""
    jsim = _add_blobs(JAsyncMPM(**KW))
    jsim._finalize()
    cfg = jsim.cfg
    K = jsim._active_block_cap()
    budget = jpacked.padded_width(jsim.particles.capacity)
    unit = _jax_unit(jsim)

    @jax.jit
    def frame(p, t):
        p, t, nup, nsel, nact, info = jab.bucketed_frame(
            p, t, cfg, (), jsim.frame_dt, unit, K, budget, K, interpret=True,
            fused=jsim.fused)
        return p, t, nup, info["n_resorts"]

    a0 = tag_ids(_numpy_of_jax(jsim.particles))
    p = _jax_of_numpy(jsim.particles, a0)
    t = jnp.float32(0.0)
    outs = []
    for _ in range(2):
        p, t, nup, nres = frame(p, t)
        outs.append(dict(p=p, t=t, nup=int(nup), n_resorts=int(nres)))
    fast = _numpy_of_jax(outs[0]["p"])
    fast["v"] = fast["v"] + np.float32([5.0, 0.0, 0.0])
    p3, t3, nup, nres = frame(_jax_of_numpy(outs[0]["p"], fast), outs[0]["t"])
    third = dict(a=fast, t=outs[0]["t"], p=p3, t_end=t3, nup=int(nup), n_resorts=int(nres))
    return dict(sim=jsim, a0=a0, frames=outs, third=third, unit=unit, K=K)


def test_sizing_matches_jax(jax_frames):
    sim = _add_blobs(AsyncMPM(**KW, device="cpu"))
    sim._finalize()
    assert sim.cfg == convert.config_from_dict(dataclasses.asdict(jax_frames["sim"].cfg))
    assert sim.bucket_unit() == jax_frames["unit"]
    assert sim._active_block_cap() == jax_frames["K"]
    for name, arr in convert.particles_to_numpy(sim.particles).items():
        want = jax_frames["a0"][name]
        if name == "params":
            want = np.concatenate([want[:, :ID_SLOT], arr[:, ID_SLOT:]], 1)
        assert np.array_equal(arr, want), name


def test_async_mpm_per_block_matches_jax(jax_frames):
    sim = _add_blobs(AsyncMPM(**KW, device="cpu"))
    sim._finalize()
    sim._set_particles(convert.particles_from_numpy(jax_frames["a0"]))
    counted = 0
    for f in jax_frames["frames"]:
        sim.step()
        counted += f["nup"]
        assert sim.update_counter == counted
        assert sim.t == np.float32(f["t"])
        assert_close_by_id(sim.particles, convert.particles_from_numpy(_numpy_of_jax(f["p"])))
    hist = sim.last_frame_stats.level_hist[0]
    assert hist[3] > 0 and hist[6] > 0  # levels 3 to 6 (by the sort's occupied slots)
    assert 0 < counted < 2 * 1200 * (1 << tab.MAXLEV)  # fewer updates than all at the unit
    assert np.all(np.isfinite(sim.positions())) and len(sim.positions()) == 1200


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_bucketed_frame_resorts_as_jax(jax_frames, fused):
    third = jax_frames["third"]
    cfg = convert.config_from_dict(dataclasses.asdict(jax_frames["sim"].cfg))
    p, t, n_up, stats = tab.bucketed_frame(
        convert.particles_from_numpy(third["a"]), np.float32(third["t"]), cfg, (),
        jax_frames["sim"].frame_dt, jax_frames["unit"], jax_frames["K"], fused=fused)
    assert third["n_resorts"] >= 1
    assert (n_up, stats.n_resorts) == (third["nup"], third["n_resorts"])
    assert t == np.float32(third["t_end"])
    assert_close_by_id(p, convert.particles_from_numpy(_numpy_of_jax(third["p"])))


@pytest.mark.parametrize("per_block", [False, True], ids=["global", "per_block"])
def test_visualize_scheduler_matches_jax(tmp_path, per_block):
    kw = dict(KW, per_block=per_block)

    def make(cls, **more):
        sim = cls(**kw, **more)
        pos = np.random.default_rng(0).uniform(0.3, 0.7, (400, 3)).astype(np.float32)
        sim.add_particles("elastic", pos=pos, E=4e3, nu=0.3)
        return sim

    make(JAsyncMPM).visualize_scheduler(str(tmp_path / "jax.bgeo"))
    make(AsyncMPM, device="cpu").visualize_scheduler(str(tmp_path / "port.bgeo"))
    jpos, jattrs = read_bgeo(str(tmp_path / "jax.bgeo"))
    tpos, tattrs = read_bgeo(str(tmp_path / "port.bgeo"))
    assert len(tpos) == 400 and np.array_equal(tpos, jpos)
    assert sorted(tattrs) == sorted(jattrs)
    if per_block:
        assert np.array_equal(tattrs["dt_level"], jattrs["dt_level"])
        assert np.array_equal(tattrs["dt_block"], jattrs["dt_block"])
        assert tattrs["dt_level"].min() >= 0
    else:
        for name in ("limit_strength", "limit_cfl", "limit"):
            rel = np.abs(tattrs[name].astype(np.float64) - jattrs[name]) / np.abs(jattrs[name])
            assert rel.max() <= 1e-6, name


def test_per_block_refusals():
    """2-D scenes and rigid bodies: the JAX package asserts, the port raises."""
    from taichi_mpm_tpu.rigid.mesh import plate_mesh as jplate
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    def two_d(cls, **more):
        sim = cls(res=(32, 32), per_block=True, **more)
        sim.add_particles("jelly", pos=np.full((4, 2), 0.5, np.float32))
        return sim

    def rigid(cls, mesh, **more):
        sim = cls(res=(16, 16, 16), per_block=True, **more)
        sim.add_particles("jelly", pos=np.full((4, 3), 0.5, np.float32))
        sim.add_particles("rigid", mesh=mesh(half_u=0.25, half_v=0.25, axis=1),
                          scripted_position=lambda t: (0.5, 0.45, 0.5),
                          scripted_rotation=lambda t: (0.0, 0.0, 0.0), codimensional=True)
        return sim

    with pytest.raises(AssertionError, match="3D-only"):
        two_d(JAsyncMPM).step()
    with pytest.raises(ValueError, match="3D-only"):
        two_d(AsyncMPM, device="cpu").step()
    with pytest.raises(AssertionError, match="CPIC not supported"):
        rigid(JAsyncMPM, jplate).step()
    with pytest.raises(ValueError, match="CPIC not supported"):
        rigid(AsyncMPM, plate_mesh, device="cpu").step()


# -- DistributedAsyncMPM on two gloo ranks ---------------------------------------------


def _one_device_frame(arrays, t, cfg, frame_dt, unit):
    """The port's one-device bucketed frame from the global set `arrays`."""
    carry, t, n_up, stats = tab.bucketed_frame_carry(
        packed.pack_particles(convert.particles_from_numpy(arrays)), np.float32(t), cfg, (),
        frame_dt, unit, 256)
    return dict(convert.particles_to_numpy(packed.unpack_particles(carry[0], 1200)), t=t,
                nup=n_up, stats=stats)


def _async_run(sim):
    sim.step()
    fs = sim.last_frame_stats
    return dict(convert.particles_to_numpy(sim.particles), nup=sim.update_counter,
                count=sim.particle_count(), schedule=fs.schedule, level_hist=fs.level_hist,
                sorts=fs.sorts)


@pytest.fixture(scope="module")
def slabs(jax_frames):
    """The ranks' results (``slab_ranks.async_slabs``) and, made while the
    ranks work, the port's one-device references: the bucketed frame
    from the JAX frames' inputs, the crossing blob and the dam."""
    third = jax_frames["third"]
    out = {}

    def ranks():
        try:
            out["ranks"] = comm.run_ranks(async_slabs, 2, "gloo",
                                          args=(jax_frames["a0"], third["a"], float(third["t"])),
                                          timeout_s=240)
        except Exception as e:  # re-raised below, in the test's thread
            out["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    cfg = convert.config_from_dict(dataclasses.asdict(jax_frames["sim"].cfg))
    args = (cfg, jax_frames["sim"].frame_dt, jax_frames["unit"])
    one = dict(first=_one_device_frame(jax_frames["a0"], 0.0, *args),
               third=_one_device_frame(third["a"], third["t"], *args),
               crossing=_async_run(scenes.crossing_blob(AsyncMPM, "cpu", per_block=True)),
               dam=_async_run(scenes.dam_frame(16, AsyncMPM, "cpu", per_block=True)), cfg=cfg)
    th.join(timeout=300)
    assert not th.is_alive(), "the ranks outlived their timeout"
    if "error" in out:
        raise out["error"]
    return dict(ranks=out["ranks"], one=one)


def _close(a, b, bounds=SLAB_BOUNDS):
    assert_close_by_id(SimpleNamespace(**a), SimpleNamespace(**b), bounds)


@pytest.mark.parametrize("frame", ["first", "second", "resort"])
def test_distributed_async_matches_jax(jax_frames, slabs, frame):
    """DistributedAsyncMPM's frames against JAX's AsyncMPM(per_block=True)
    frames: the update count, t, every particle kept, x and v within
    JAX's bounds between its slab and one-device frames; the third frame
    re-sorts mid-frame as JAX's does. Both ranks gather the same set."""
    r0, r1 = slabs["ranks"]
    if frame == "resort":
        got, want = (r0["third"], r1["third"]), jax_frames["third"]
        assert want["n_resorts"] >= 1 and got[0]["sorts"] == want["n_resorts"] + 1
        t_want = want["t_end"]
    else:
        i = ("first", "second").index(frame)
        got, want = (r0["frames"][i], r1["frames"][i]), jax_frames["frames"][i]
        t_want = want["t"]
    assert got[0]["nup"] == got[1]["nup"] == want["nup"]
    assert got[0]["t"] == float(np.float32(t_want))
    assert got[0]["count"] == 1200
    _close(got[0], _numpy_of_jax(want["p"]))
    for k in ("x", "v", "F", "C", "active", "params"):
        assert np.array_equal(got[0][k], got[1][k]), k


@pytest.mark.parametrize("state", ["a0", "fast"])
def test_sharded_levels_match_one_device(jax_frames, slabs, state):
    """The levels of the slabs (MAXLEV sweeps, each after a boundary plane
    exchange) equal the port's one-device slot_levels, integer for
    integer, on every block both page maps hold, every occupied block
    among them."""
    arrays = jax_frames["a0"] if state == "a0" else jax_frames["third"]["a"]
    cfg = slabs["one"]["cfg"]
    st, _, pm = packed.sort_and_map(packed.pack_particles(convert.particles_from_numpy(arrays)),
                                    cfg, 256)
    lev = tab.slot_levels(st, pm, cfg, jax_frames["unit"])
    bx, by, bz, valid = blocked._decode_ids(pm["ids"], cfg)
    one = {(int(x), int(y), int(z)): int(v)
           for x, y, z, v, ok in zip(bx, by, bz, lev, valid) if ok}
    compared = 0
    for r in slabs["ranks"]:
        got = r["levels"][("a0", "fast").index(state)]
        for block, level, occ in zip(map(tuple, got["block"].tolist()), got["lev"], got["occ"]):
            if occ:
                assert block in one, block
            if block in one:
                assert level == one[block], (block, level, one[block])
                compared += 1
    assert compared >= sum(r["levels"][0]["occ"].sum() for r in slabs["ranks"])


@pytest.mark.parametrize("frame", ["first", "resort"])
def test_slab_schedule_matches_one_device(slabs, frame):
    """The schedule of (tick, level), the re-sorts and the level histogram
    of each sort (summed over the ranks) equal the port's one-device
    frame's from the same input."""
    r0, r1 = slabs["ranks"]
    key = "frames" if frame == "first" else "third"
    g0, g1 = (r[key][0] if frame == "first" else r[key] for r in (r0, r1))
    one = slabs["one"]["first" if frame == "first" else "third"]
    assert g0["schedule"] == g1["schedule"] == one["stats"].schedule
    assert g0["sorts"] == one["stats"].sorts
    hist = (np.asarray(g0["level_hist"]) + np.asarray(g1["level_hist"])).tolist()
    assert hist == one["stats"].level_hist
    assert g0["nup"] == one["nup"]
    _close(g0, one)


def test_slab_crossing_matches_one_device(slabs):
    """A blob crossing x = 0.5 at 1 m/s: the slab frame re-sorts, particles
    migrate, and it matches AsyncMPM(per_block=True): the update count,
    the re-sorts, every particle kept, x and v within the slab bounds."""
    r0, r1 = slabs["ranks"]
    one = slabs["one"]["crossing"]
    g = r0["crossing"]
    assert g["sorts"] == one["sorts"] >= 2
    assert r0["crossing"]["sent"][1] > 0 and r1["crossing"]["arrived"] > 0
    assert g["nup"] == r1["crossing"]["nup"] == one["nup"]
    assert g["count"] == one["count"] == 1200
    assert g["schedule"] == one["schedule"]
    _close(g, one)


def test_slab_empty_rank(slabs):
    """The dam of scripts/async/water.py at res 16: the right slab starts
    empty, still joins every advance (its record exchanges carry zeros),
    and the frame ends on both ranks with the one-device counts."""
    r0, r1 = (r["dam"] for r in slabs["ranks"])
    one = slabs["one"]["dam"]
    assert r1["local_start"] == 0 and r0["local_start"] == one["count"]
    assert r1["empty"] == sum(1 for _ in r1["schedule"]) and r0["empty"] == 0
    assert r0["nup"] == r1["nup"] == one["nup"] > 0
    assert r0["count"] == one["count"]
    assert r0["schedule"] == one["schedule"]
    _close(r0, one)


class _TrivialHooks(tab.OneDevice):
    """One device through the slab hooks, each made trivial: the branch
    values reduced by a copy, an empty context extension, the local
    config and colliders of one device, an exchange that returns the
    records."""

    def sort(self, st, K, tz, stats):
        st, keys, pm = packed.sort_and_map(st, self.cfg, K)
        lev = torch.clamp(self.level_fn(st, pm), max=tz).to(torch.int32)
        return tab.Sorted(st, keys, pm, lev, self.cfg, stats, all_max=torch.clone,
                          ctx_extend=torch.zeros_like)

    def advance(self, st, backup, plan, t, dt):
        if plan.pm is None:
            return None
        return tab.advance_bucket(st, backup, plan, t, self.cfg, self.colliders, dt, True,
                                  lcfg=self.cfg, grid_colliders=self.colliders,
                                  exchange_fn=lambda rec, pm: rec)


def test_hooks_absent_keep_bits(jax_frames, slabs):
    """The one-device frame (held to JAX's bits in
    test_torch_async_bucketed.py) and the same frame through trivial slab
    hooks give the same bits, the re-sorting third frame's input."""
    cfg, unit = slabs["one"]["cfg"], jax_frames["unit"]
    third = jax_frames["third"]
    st = packed.pack_particles(convert.particles_from_numpy(third["a"]))
    plain = tab.bucketed_frame_carry(st.clone(), third["t"], cfg, (), jax_frames["sim"].frame_dt,
                                     unit, 256)
    level_fn = lambda s, pm: tab.slot_levels(s, pm, cfg, unit)  # noqa: E731
    cur, st2, t, n_up, _, stats = tab.tick_loop(st.clone(), third["t"], cfg,
                                                jax_frames["sim"].frame_dt, unit, 256,
                                                _TrivialHooks(cfg, (), level_fn))
    assert stats.n_resorts >= 1
    assert int(n_up) == plain[2] and t == plain[1]
    assert torch.equal(st2, plain[0][0])


@pytest.mark.parametrize("case", ["balanced", "mesh_shape", "rigid", "frame_dt"])
def test_distributed_async_refusals(case):
    """DistributedAsyncMPM refuses what JAX's asserts against, with its
    messages (taichi_mpm_tpu/parallel/driver.py:393-501)."""
    from taichi_mpm_torch.parallel.driver import DistributedAsyncMPM
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    kw = dict(res=(16, 16, 16), device="cpu")
    if case == "balanced":
        with pytest.raises(ValueError, match="bucketed async runs on uniform slabs"):
            DistributedAsyncMPM(balanced=True, **kw)
        return
    if case == "mesh_shape":
        with pytest.raises(ValueError, match=r"bucketed async is slab-mesh \(1-D\) only"):
            DistributedAsyncMPM(mesh_shape=(1, 1), **kw)
        return
    with comm.process_group("gloo", 0, 1, comm.free_port(), timeout_s=60):
        sim = DistributedAsyncMPM(**kw)
        sim.add_particles("jelly", pos=np.full((4, 3), 0.5, np.float32))
        if case == "rigid":
            sim.add_particles("rigid", mesh=plate_mesh(half_u=0.25, half_v=0.25, axis=1),
                              scripted_position=lambda t: (0.5, 0.45, 0.5),
                              scripted_rotation=lambda t: (0.0, 0.0, 0.0), codimensional=True)
            with pytest.raises(ValueError, match="adaptive dt \\+ CPIC not supported yet"):
                sim.step()
        else:
            with pytest.raises(ValueError, match="frame_dt is baked into the bucketed tick loop"):
                sim.step(2 * sim.frame_dt)
