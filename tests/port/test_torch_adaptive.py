"""Port vs JAX: global adaptive dt on plain scenes.

``snap_pot`` must give the JAX package's bits, also where a float32
log2 is not exact (at powers of two and one ulp beside them); the JAX
function is compiled as its frames compile it (jitted, unit and max dt
constant). ``dt_limit_packed`` and ``dt_limit`` against JAX for every
material. The port's ``packed_adaptive_frame`` against the JAX package's
(Pallas kernels in interpret mode) on both routes, on a fast jelly scene
whose dt changes inside the frame (the advection CFL binds, then the max
dt): the substep count, the time and the occupancy equal, the state
within the bounds of ``tests/test_fused.py``. Then ``AsyncMPM``: its
frames are the adaptive frames, and per block what it refuses."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taichi_mpm_tpu.core import adaptive as jadaptive
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import convert
from taichi_mpm_torch.core import adaptive as tadaptive
from taichi_mpm_torch.materials import models as tmodels
from taichi_mpm_torch.ops import packed as tpacked

from port_helpers import assert_frame_close, configs, fast_arrays, jax_particles, scene_arrays

torch.set_num_threads(1)

MATERIALS = ("elastic", "jelly", "snow", "water", "sand", "von_mises", "linear", "visco")


def _ulps(x, n):
    """x and its n float32 neighbours on either side."""
    out = [np.float32(x)]
    lo = hi = np.float32(x)
    for _ in range(n):
        lo, hi = np.nextafter(lo, np.float32(0)), np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return out


@pytest.mark.parametrize("unit,max_dt", [(1e-6, 1.0), (1e-6, 1e-3), (3e-7, 1e-2)])
def test_snap_pot_bits_match_jax(unit, max_dt):
    recip = np.float32(1.0 / np.float64(np.float32(unit)))
    dts = []
    for k in range(31):
        # dt whose ratio dt / unit (as the compiled frame forms it) is 2^k,
        # and the dt one to three float32 ulps on either side
        dts += _ulps(np.float32(np.float64(2.0 ** k) / np.float64(recip)), 3)
    dts += list(np.random.default_rng(0).uniform(0.0, 2.0 * max_dt, 2000).astype(np.float32))
    dts = np.asarray(dts, np.float32)
    ratios = dts * recip
    exact = np.float32(2.0) ** np.arange(31, dtype=np.float32)
    assert np.isin(exact, ratios).sum() >= 25  # exact powers of two are among them
    want = np.asarray(jax.jit(lambda d: jadaptive.snap_pot(d, unit, max_dt))(dts))
    got = tadaptive.snap_pot(dts, unit, max_dt)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_snap_pot_reproduces_float32_log2():
    """At the ratio 2^13 a float32 log2 gives 12.999999: JAX snaps to
    unit x 2^12 there, and so does the port."""
    unit = 1e-6
    dt = np.float32(np.float64(2.0 ** 13) / np.float64(np.float32(1.0 / np.float64(np.float32(unit)))))
    want = np.asarray(jax.jit(lambda d: jadaptive.snap_pot(d, unit, 1.0))(dt))
    assert want == np.float32(unit) * np.float32(2.0 ** 12)
    assert tadaptive.snap_pot(dt, unit, 1.0) == want


def _deformed_state(mat):
    a, mids = scene_arrays(400, seed=5, mats=(mat,), v_scale=2.0)
    rng = np.random.default_rng(6)
    n = 400
    a["F"][:n] += 0.05 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    if mat in ("snow", "water"):  # aux is Jp or J
        a["aux"][:n] = (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return a, mids


@pytest.mark.parametrize("mat", MATERIALS)
def test_dt_limit_packed_matches_jax(mat):
    a, mids = _deformed_state(mat)
    jcfg, tcfg = configs(mids)
    want = float(jpacked.dt_limit_packed(jpacked.pack_particles(jax_particles(a)), jcfg,
                                         0.7, 0.9))
    st = tpacked.pack_particles(convert.particles_from_numpy(a))
    got = tpacked.dt_limit_packed(st, tcfg, 0.7, 0.9)
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - want) <= 2e-6 * want


def test_dt_limit_matches_jax_mixed():
    a, mids = scene_arrays(600, seed=12, mats=("elastic", "water", "jelly", "snow"))
    jcfg, tcfg = configs(mids)
    want = float(jadaptive.dt_limit(jax_particles(a), jcfg, 0.5, 2.0))
    got = float(tadaptive.dt_limit(convert.particles_from_numpy(a), tcfg, 0.5, 2.0))
    assert abs(got - want) <= 2e-6 * want
    # the matrix-form dispatch is the component form's
    p = convert.particles_from_numpy(a)
    speed = torch.linalg.vector_norm(p.v, dim=-1)
    per = tmodels.dispatch_allowed_dt(tcfg.active_materials, p.mat, p.F, p.aux, p.params,
                                      p.vol, p.mass, speed, tcfg.dx)
    assert per.shape == (p.capacity,) and bool(torch.isinf(per[p.mat == 1]).all())


FRAME_DT, UNIT, K = 4e-3, 1e-6, 192


@pytest.fixture(scope="module")
def fast_jelly():
    """Jelly at up to ~40 m/s, moving together at 7 m/s, max dt 1e-3: the
    CFL binds at the first substep (dt 5.12e-4), the max dt after the
    transfer has averaged the random velocities, the last substep lands
    on the frame's end, and the drift re-sorts once."""
    return fast_arrays(seed=9, v_scale=10.0, drift=(6.0, -4.0, 0.0))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_adaptive_frame_matches_jax(fast_jelly, fused):
    a, mids = fast_jelly
    jcfg, tcfg = configs(mids, base_dt=1e-3)
    jp, jt, jn, jnmax = jpacked.packed_adaptive_frame(
        jax_particles(a), jnp.float32(0.0), jcfg, (), FRAME_DT, UNIT, jcfg.base_dt, K,
        interpret=True, fused=fused)
    dts = []
    carry = tpacked.pack_carry(convert.particles_from_numpy(a), tcfg, K)
    carry, tt, tnmax, tns, _, tn = tpacked.packed_adaptive_frame_carry(
        carry, np.float32(0.0), tcfg, (), FRAME_DT, UNIT, tcfg.base_dt, fused=fused, dts=dts)
    assert (int(jn), int(jnmax)) == (tn, tnmax)
    assert np.float32(jt) == tt
    assert tns == 1 and len(set(dts)) == 3
    assert_frame_close(jp, tpacked.unpack_particles(carry[0], a["x"].shape[0]))


def test_async_mpm_frames_are_adaptive_frames(fast_jelly, monkeypatch):
    """AsyncMPM on either route, built through the scene API from the
    same particles: each frame is packed_adaptive_frame on the previous
    frame's particles (bit for bit), and the counters add up."""
    a, mids = fast_jelly
    _, tcfg = configs(mids, base_dt=1e-3)
    n = int(a["active"].sum())
    for env in ("1", "0"):
        monkeypatch.setenv("TMT_FUSED", env)
        sim = tadaptive.AsyncMPM(res=(32, 32, 32), base_delta_t=1e-3, frame_dt=FRAME_DT,
                                 unit_delta_t=UNIT, capacity=a["x"].shape[0], device="cpu")
        sim.add_particles("jelly", pos=a["x"][:n], vel=a["v"][:n], mass=1e-3, vol=1e-6)
        sim._finalize()
        assert sim.cfg == tcfg
        for name, arr in convert.particles_to_numpy(sim.particles).items():
            assert np.array_equal(arr, a[name]), name
        p, t, counted = convert.particles_from_numpy(a), np.float32(0.0), 0
        for _ in range(2):
            sim.step()
            p, t, n_sub, _ = tpacked.packed_adaptive_frame(
                p, t, tcfg, (), FRAME_DT, UNIT, tcfg.base_dt, sim.block_capacity,
                fused=env == "1")
            counted += n_sub * n
            assert sim.last_substeps == n_sub and sim.t == t
        assert sim.update_counter == counted
        lo, hi = sim.last_dt_range
        assert 0.0 < lo <= hi <= np.float32(1e-3)
        for name in ("x", "v", "F", "C", "active"):
            assert torch.equal(getattr(sim.particles, name), getattr(p, name)), name


def test_async_mpm_per_block_raises():
    """The per-block scheduler runs (test_torch_async_mpm.py holds it to
    JAX) and raises where the JAX package asserts: a 2-D scene."""
    sim = tadaptive.AsyncMPM(res=(32, 32), per_block=True, device="cpu")
    sim.add_particles("jelly", pos=np.full((4, 2), 0.5, np.float32))
    with pytest.raises(ValueError, match="3D-only"):
        sim.step()
    sim = tadaptive.AsyncMPM(res=(32, 32, 32), per_block=True, frame_dt=6.4e-3,
                             unit_delta_t=1e-4, device="cpu")
    sim.add_particles("jelly", pos=np.full((4, 3), 0.5, np.float32))
    sim.step()
    assert sim.update_counter > 0 and sim.last_frame_stats.n_substeps > 0
