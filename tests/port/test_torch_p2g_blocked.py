"""Port vs JAX: P2G from a prebuilt operand (the unfused route's kernel).

The port's ``p2g_blocked`` (on the CPU its plain twin
``p2g_blocked_plain``) and the JAX kernels ``p2g_pallas.p2g_blocked`` and
``p2g_blocked_batched`` (4 slots per program, K % 4 == 0) in interpret
mode get the same (16, Pw) operand, built by the JAX package's
``prep_packed`` from a sorted state, and the same slot ranges. The
reference's tiles (K, 28, 49) [(i, c), (j, k)] are turned into the port's
(K, 7, 7, 7, 4) layout and compared tile for tile, and both packages'
merged node records, at 1e-5 x max|value|: the reference sums the affine
term as c0 - n A with c0 = m v + A pos, the port as m v + A (pos - n),
the same value rounded in another order (the bound of
``test_torch_p2g.py``)."""

import numpy as np
import pytest
import torch

from taichi_mpm_tpu.ops import blocked as jblocked
from taichi_mpm_tpu.ops import p2g_pallas
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch.ops import blocked as tblocked
from taichi_mpm_torch.ops import p2g as tp2g

from port_helpers import configs, jax_particles, max_err, np_of, scene_arrays

torch.set_num_threads(1)

REL = 1e-5


def _operand(a, mids, K):
    """The JAX package's sorted state, page map and P2G operand of `a`."""
    jcfg, _ = configs(mids)
    jst, jkeys, jpm, _ = jpacked.pack_carry(jax_particles(a), jcfg, K, two_d=True)
    pdata, _ = jpacked.prep_packed(jst, jkeys, jcfg, jcfg.base_dt)
    return np.asarray(pdata), {k: np.asarray(v) for k, v in jpm.items()}, jst.shape[1]


def _deformed(n, seed, lo=0.375, hi=0.5):
    a, mids = scene_arrays(n, seed=seed, lo=lo, hi=hi)
    rng = np.random.default_rng(seed + 1)
    a["F"][:n] += 0.05 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    a["C"][:n] = 0.5 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    return a, mids


def _port_tiles(s_arr, e_arr, pdata, pw):
    return tp2g.p2g_blocked(torch.as_tensor(s_arr.copy()), torch.as_tensor(e_arr.copy()),
                            torch.as_tensor(pdata[:, :pw].copy()))


def _assert_tiles_close(jtiles, ttiles, nbr=None):
    K = ttiles.shape[0]
    jt = np.asarray(jtiles).reshape(K, 7, 4, 7, 7).transpose(0, 1, 3, 4, 2)
    assert ttiles.shape == (K, 7, 7, 7, 4)
    assert max_err(jt, ttiles) <= REL * float(np.abs(jt).max())
    if nbr is not None:
        jrec = np.asarray(jblocked.merge_tiles_mm(jtiles, nbr))
        trec = tblocked.merge_tiles(ttiles, torch.as_tensor(np.array(nbr)))
        assert max_err(jrec, trec) <= REL * float(np.abs(jrec).max())


@pytest.fixture(scope="module")
def scene():
    a, mids = _deformed(1200, seed=21)
    return _operand(a, mids, 64)


@pytest.mark.parametrize("kernel", ["p2g_blocked", "p2g_blocked_batched"])
def test_matches_jax_k_multiple_of_4(scene, kernel):
    pdata, pm, pw = scene
    assert pm["s_arr"].shape[0] % 4 == 0
    jtiles = getattr(p2g_pallas, kernel)(pm["s_arr"], pm["e_arr"], pdata, interpret=True)
    _assert_tiles_close(jtiles, _port_tiles(pm["s_arr"], pm["e_arr"], pdata, pw), pm["nbr"])


def test_matches_jax_odd_k(scene):
    """K odd: the live slots and one empty slot after them (the TPU
    dispatch takes p2g_blocked there; the port has one kernel)."""
    pdata, pm, pw = scene
    n = int(pm["n_act"])
    K = n + 1 if n % 2 == 0 else n + 2
    s_arr, e_arr = pm["s_arr"][:K], pm["e_arr"][:K]
    assert K % 2 == 1 and s_arr[-1] == e_arr[-1]
    jtiles = p2g_pallas.p2g_blocked(s_arr, e_arr, pdata, interpret=True)
    _assert_tiles_close(jtiles, _port_tiles(s_arr, e_arr, pdata, pw))


def test_empty_slots_give_zero_tiles(scene):
    """Live slots emptied (s == e) and the sentinel slots past the live
    ones: zero tiles in both packages, the other tiles as before."""
    pdata, pm, pw = scene
    s_arr, e_arr = pm["s_arr"].copy(), pm["e_arr"].copy()
    n = int(pm["n_act"])
    emptied = np.arange(0, n, 3)
    e_arr[emptied] = s_arr[emptied]
    for kernel in (p2g_pallas.p2g_blocked, p2g_pallas.p2g_blocked_batched):
        jtiles = kernel(s_arr, e_arr, pdata, interpret=True)
        ttiles = _port_tiles(s_arr, e_arr, pdata, pw)
        _assert_tiles_close(jtiles, ttiles)
        empty = np.ones(s_arr.shape[0], bool)
        empty[n:] = True
        empty[:n] = s_arr[:n] == e_arr[:n]
        assert empty[emptied].all() and empty[n:].all()
        assert not np_of(ttiles)[empty].any()


def test_long_range_in_one_slot():
    """1,200 particles inside one grid block: one slot's range spans three
    of the reference's 512-lane chunks and 38 of the port's 32-particle
    staging rounds."""
    a, mids = _deformed(1200, seed=31, lo=0.2525, hi=0.3725)  # block cells 8-11 at res 32
    pdata, pm, pw = _operand(a, mids, 64)
    counts = pm["e_arr"] - pm["s_arr"]
    assert counts.max() == 1200
    for kernel in (p2g_pallas.p2g_blocked, p2g_pallas.p2g_blocked_batched):
        jtiles = kernel(pm["s_arr"], pm["e_arr"], pdata, interpret=True)
        _assert_tiles_close(jtiles, _port_tiles(pm["s_arr"], pm["e_arr"], pdata, pw),
                            pm["nbr"])


def test_fused_plain_is_prep_then_blocked_plain(scene):
    """The fused twin is the operand prep followed by this scatter: on a
    port state both give the same bits."""
    from taichi_mpm_torch import convert
    from taichi_mpm_torch.ops import packed as tpacked

    a, mids = _deformed(600, seed=41)
    _, tcfg = configs(mids)
    st, _, pm, _ = tpacked.pack_carry(convert.particles_from_numpy(a), tcfg, 64)
    fused = tp2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, tcfg.base_dt, tcfg)
    split = tp2g.p2g_blocked(pm["s_arr"], pm["e_arr"], tp2g.prep_packed(st, tcfg, tcfg.base_dt))
    assert torch.equal(fused, split)


def test_wrapper_checks_inputs(scene):
    pdata, pm, pw = scene
    s = torch.as_tensor(pm["s_arr"].copy())
    e = torch.as_tensor(pm["e_arr"].copy())
    op = torch.as_tensor(pdata[:, :pw].copy())
    with pytest.raises(ValueError, match=r"\(16, Pw\)"):
        tp2g.p2g_blocked(s, e, op[:15].contiguous())
    with pytest.raises(ValueError, match="int32"):
        tp2g.p2g_blocked(s.long(), e, op)
    with pytest.raises(ValueError, match="contiguous"):
        tp2g.p2g_blocked(s, e, torch.as_tensor(pdata.copy())[:, :pw])
    before = tp2g.blocked_stats.launches
    tp2g.p2g_blocked(s, e, op)
    assert tp2g.blocked_stats.launches == before  # the twin is no launch
