"""Port vs JAX: the fused G2P + finish.

The port's G2P (on the CPU its plain twin ``g2p_fused_plain``) and the
JAX kernel ``fused_pallas.g2p_fused`` in interpret mode get the same
sorted packed state, slot keys and velocity records (random, seeded);
each package assembles its own windows. Held to the bounds the reference
sets between its own paths (``tests/test_fused.py``): x 5e-6, v 5e-5,
F 5e-6, C 5e-4, aux 5e-6 absolute; vmax to 1e-6 relative; the active
mask and the plasticity count exactly. One lane starts with a NaN in F
(the scrub must deactivate and reset it) and the last active lane
carries the overflow key K (it must gather v = B = 0 and still finish).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.ops import blocked as jblocked
from taichi_mpm_tpu.ops import fused_pallas
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import convert
from taichi_mpm_torch.ops import blocked as tblocked
from taichi_mpm_torch.ops import g2p as tg2p
from taichi_mpm_torch.ops import packed as tpacked
from taichi_mpm_torch.ops.rows import RACT, RAUX, RC, RF, RV, RX

from port_helpers import configs, jax_particles, max_err, scene_arrays

torch.set_num_threads(1)

K = 64
BOUNDS = ((RX, 3, 5e-6), (RV, 3, 5e-5), (RF, 9, 5e-6), (RC, 9, 5e-4), (RAUX, 1, 5e-6))


@pytest.mark.parametrize("material", ["jelly", "water"])
def test_g2p_matches_jax(material):
    a, mids = scene_arrays(1200, seed=31, mats=(material,))
    jcfg, tcfg = configs(mids)
    jst, _, jpm = jpacked.pack_carry(jax_particles(a), jcfg, K, two_d=True)[:3]
    st = np.array(jst)
    keys = np.array(jpm["slot_keys"])
    n = int(a["active"].sum())
    st[RF, 5] = np.nan  # sorted lane 5: scrubbed by the finish
    keys[n - 1] = K  # last active lane: overflow key, gathers zero
    rng = np.random.default_rng(32)
    n_act = int(jpm["n_act"])
    vrec = (0.3 * rng.standard_normal((K, 192))).astype(np.float32)
    vrec[n_act:] = 0.0
    dt = jcfg.base_dt

    gtiles = jblocked.windows_mm(jnp.asarray(vrec), jpm["nbr"])
    jnew, jvmax, jplast = fused_pallas.g2p_fused(
        jnp.asarray(keys)[None, :], jnp.asarray(st), gtiles,
        jnp.asarray([K], jnp.int32), dt, jcfg, interpret=True)
    jnew = np.asarray(jnew)

    tst = convert.packed_from_numpy(st)
    win = tblocked.windows(torch.as_tensor(vrec), torch.as_tensor(np.array(jpm["nbr"])))
    tvmax, tplast = tg2p.g2p_fused(torch.as_tensor(keys), tst, win, dt, tcfg)
    tnew = tst.numpy()

    assert np.array_equal(jnew[RACT], tnew[RACT])
    assert jnew[RACT, 5] == 0.0 and np.all(tnew[RF:RF + 9, 5] == np.eye(3).ravel())
    for r0, nr, bound in BOUNDS:
        assert max_err(jnew[r0:r0 + nr], tnew[r0:r0 + nr]) <= bound, r0
    assert np.array_equal(jnew[25:], tnew[25:])  # untouched rows, bit for bit
    jv = float(np.max(np.asarray(jvmax)))
    assert abs(jv - float(tvmax)) <= 1e-6 * jv
    assert int(np.sum(np.asarray(jplast))) == int(tplast)
    if material == "water":
        assert int(tplast) > 0  # the count is exercised, not only zero


def test_g2p_wrapper_checks_inputs():
    a, mids = scene_arrays(100, seed=33)
    _, tcfg = configs(mids)
    st = torch.zeros((48, 100))
    win = torch.zeros((4, 3, 7, 7, 7))
    with pytest.raises(ValueError, match="keys"):
        tg2p.g2p_fused(torch.zeros(100, dtype=torch.int64), st, win, 2e-4, tcfg)
    with pytest.raises(ValueError, match="windows"):
        tg2p.g2p_fused(torch.zeros(100, dtype=torch.int32), st, win[:, :2], 2e-4, tcfg)


def test_finish_zero_C_matches_jax():
    """The CPIC frame's finish: gathered rows corrected outside the
    kernel, the near-boundary lanes' C zeroed (zero_C); water's return map."""
    a, mids = scene_arrays(600, seed=34, mats=("water",))
    jcfg, tcfg = configs(mids)
    st = np.array(jpacked.pack_carry(jax_particles(a), jcfg, K, two_d=True)[0])
    pw = st.shape[1]
    rng = np.random.default_rng(35)
    pout = np.zeros((16, pw), np.float32)
    pout[:12] = 0.5 * rng.standard_normal((12, pw))
    zero_c = rng.uniform(size=pw) < 0.3
    dt = jcfg.base_dt
    jnew, jvmax, jplast = jpacked.finish_packed(jnp.asarray(st), jnp.asarray(pout), jcfg, dt,
                                                zero_C=jnp.asarray(zero_c))
    tnew, tvmax, tplast = tg2p.finish_packed(convert.packed_from_numpy(st),
                                             torch.as_tensor(pout[:12]), tcfg, dt,
                                             zero_C=torch.as_tensor(zero_c))
    jnew, tnew = np.asarray(jnew), tnew.numpy()
    for r0, nr, bound in BOUNDS:
        assert max_err(jnew[r0:r0 + nr], tnew[r0:r0 + nr]) <= bound, r0
    live = (tnew[RACT] > 0.5) & zero_c
    assert live.any() and not np.any(tnew[RC:RC + 9, live])
    assert int(np.sum(np.asarray(jplast))) == int(tplast) > 0
    assert abs(float(jvmax) - float(tvmax)) <= 1e-6 * float(jvmax)


def test_g2p_blocked_wrapper_checks_inputs():
    a, mids = scene_arrays(100, seed=36)
    _, tcfg = configs(mids)
    st = torch.zeros((48, 100))
    win = torch.zeros((4, 3, 7, 7, 7))
    with pytest.raises(ValueError, match="keys"):
        tg2p.g2p_blocked(torch.zeros(100, dtype=torch.int64), st, win, tcfg)
    with pytest.raises(ValueError, match="contiguous"):
        tg2p.g2p_blocked(torch.zeros(100, dtype=torch.int32), st.t().contiguous().t(), win, tcfg)
    out = tg2p.g2p_blocked(torch.full((100,), 4, dtype=torch.int32), st, win, tcfg)
    assert out.shape == (12, 100) and not out.any()  # slot key K gathers zero


def _gather_every_lane(keys, st, win, cfg):
    """The window gather as every lane runs it: a slot-K lane gathers from
    an appended window of zeros (the form ``g2p._gather_plain`` had before
    it computed the lanes of live slots only)."""
    from taichi_mpm_torch.ops.rows import RORG
    from taichi_mpm_torch.math.kernels import quadratic_weight

    nK = win.shape[0]
    tile = win.shape[-1]
    flat = torch.cat([win.reshape(nK, -1), win.new_zeros(1, 3 * tile ** 3)])
    slot = keys.long().clamp(max=nK)
    pos = torch.stack([st[RX + a] * cfg.inv_dx - st[RORG + a] for a in range(3)])
    base = torch.clamp(torch.floor(pos - 0.5), -2.0, 7.0)
    w = [[quadratic_weight(pos[a] - (base[a] + d)) for d in range(3)] for a in range(3)]
    tidx = (base + 1).long()
    acc = [torch.zeros_like(pos[0]) for _ in range(12)]
    for di in range(3):
        for dj in range(3):
            for dk in range(3):
                ix, iy, iz = tidx[0] + di, tidx[1] + dj, tidx[2] + dk
                inside = ((ix >= 0) & (ix < tile) & (iy >= 0) & (iy < tile)
                          & (iz >= 0) & (iz < tile))
                wn = w[0][di] * w[1][dj] * w[2][dk]
                node = (ix.clamp(0, tile - 1) * tile + iy.clamp(0, tile - 1)) * tile \
                    + iz.clamp(0, tile - 1)
                d = (pos[0] - (ix - 1), pos[1] - (iy - 1), pos[2] - (iz - 1))
                for c in range(3):
                    wg = torch.where(inside, wn * flat[slot, c * tile ** 3 + node], 0.0)
                    acc[c] = acc[c] + wg
                    for a in range(3):
                        acc[3 + 3 * c + a] = acc[3 + 3 * c + a] + wg * d[a]
    return torch.stack(acc)


def test_gather_plain_matches_every_lane_gather():
    """The plain twins' gather computes the lanes of live slots only: on
    every live lane it gives the every-lane gather's bits (NaN where a
    lane's position is not finite), and on every free lane (slot key K)
    zero, as the CUDA kernel's gather does; the every-lane gather gave
    NaN there where the free lane's position was not finite."""
    a, mids = scene_arrays(300, seed=37, mats=("jelly",))
    _, tcfg = configs(mids)
    st, _, pm, _ = tpacked.pack_carry(convert.particles_from_numpy(a), tcfg, K)
    keys, n = pm["slot_keys"], int(pm["n_act"])
    free = keys >= K
    lanes = torch.arange(keys.shape[0])
    free_lanes, live_lanes = lanes[free], lanes[~free]
    assert n > 3 and free_lanes.numel() > 3
    st[RX, live_lanes[1]] = float("nan")
    st[RX + 1, free_lanes[0]] = float("nan")
    st[RX + 2, free_lanes[2]] = float("inf")
    rng = np.random.default_rng(38)
    vrec = torch.as_tensor((0.3 * rng.standard_normal((K, 192))).astype(np.float32))
    win = tblocked.windows(vrec, pm["nbr"])

    got = torch.stack(tg2p._gather_plain(keys, st, win, tcfg))
    every = _gather_every_lane(keys, st, win, tcfg)
    torch.testing.assert_close(got[:, ~free], every[:, ~free], rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got[:, live_lanes[1]]).any()
    assert not got[:, free].any()
    ok = torch.isfinite(st[RX:RX + 3, free]).all(0)
    assert not every[:, free][:, ok].any()
    assert torch.isnan(every[:, free_lanes[0]]).any() and torch.isnan(every[:, free_lanes[2]]).any()
