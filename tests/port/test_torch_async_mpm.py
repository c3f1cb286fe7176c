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
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taichi_mpm_tpu.core.adaptive import AsyncMPM as JAsyncMPM
from taichi_mpm_tpu.io.bgeo import read_bgeo
from taichi_mpm_tpu.ops import async_bucketed as jab
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import convert
from taichi_mpm_torch.core.adaptive import AsyncMPM
from taichi_mpm_torch.ops import async_bucketed as tab

from port_helpers import ID_SLOT, assert_close_by_id, tag_ids

torch.set_num_threads(1)

KW = dict(res=(32, 32, 32), base_delta_t=1e-3, frame_dt=6.4e-3, unit_delta_t=1e-4,
          per_block=True, gravity=(0, 0, 0))


def _add_blobs(sim):
    rng = np.random.default_rng(0)
    pos = np.concatenate([
        rng.uniform([0.15, 0.3, 0.3], [0.4, 0.6, 0.6], (900, 3)),
        rng.uniform([0.6, 0.4, 0.4], [0.8, 0.6, 0.6], (300, 3)),
    ]).astype(np.float32)
    sim.add_particles("elastic", pos=pos[:900], E=4e3, nu=0.3)
    sim.add_particles("elastic", pos=pos[900:], E=4e5, nu=0.3)
    return sim


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
