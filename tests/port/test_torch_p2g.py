"""Port vs JAX: the fused prep + P2G.

The port's P2G (on the CPU its plain twin ``p2g_fused_plain``) and the
JAX kernel ``fused_pallas.p2g_fused`` in interpret mode get the same
sorted packed state and slot ranges; each package merges its own tiles
into node records (K, 256). The reference sums the affine term by a
node-moment decomposition (mv + A pos, minus node x A), the port sums
w (mv + A (pos - node)) per node: the same value, rounded in another
order, so records are held to 1e-5 x max|record|."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.ops import blocked as jblocked
from taichi_mpm_tpu.ops import fused_pallas
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import convert
from taichi_mpm_torch.ops import blocked as tblocked
from taichi_mpm_torch.ops import p2g as tp2g
from taichi_mpm_torch.ops import packed as tpacked

from port_helpers import configs, jax_particles, max_err, scene_arrays

torch.set_num_threads(1)

K = 64


def _sorted_state(mats, v_scale):
    a, mids = scene_arrays(1200, seed=21, mats=mats, v_scale=v_scale)
    # a deformed, rotating start so force and affine terms matter
    rng = np.random.default_rng(22)
    n = int(a["active"].sum())
    a["F"][:n] += 0.05 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    a["C"][:n] = 0.5 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    jcfg, tcfg = configs(mids)
    jst, _, jpm = jpacked.pack_carry(jax_particles(a), jcfg, K, two_d=True)[:3]
    return jcfg, tcfg, jst, jpm


@pytest.mark.parametrize("mats", [("jelly",), ("jelly", "sand", "water")])
def test_p2g_records_match_jax(mats):
    jcfg, tcfg, jst, jpm = _sorted_state(mats, v_scale=0.5)
    dt = jcfg.base_dt
    jtiles = fused_pallas.p2g_fused(jpm["s_arr"], jpm["e_arr"], jst, dt, jcfg,
                                    interpret=True)
    jrec = np.asarray(jblocked.merge_tiles_mm(jtiles, jpm["nbr"]))

    tst = convert.packed_from_numpy(np.asarray(jst))
    s_arr = torch.as_tensor(np.asarray(jpm["s_arr"]))
    e_arr = torch.as_tensor(np.asarray(jpm["e_arr"]))
    nbr = torch.as_tensor(np.asarray(jpm["nbr"]))
    ttiles = tp2g.p2g_fused(s_arr, e_arr, tst, dt, tcfg)
    assert ttiles.shape == (K, 7, 7, 7, 4)
    trec = tblocked.merge_tiles(ttiles, nbr)
    scale = float(np.abs(jrec).max())
    assert max_err(jrec, trec) <= 1e-5 * scale
    # mass channel: the port's tiles match the reference's tile for tile
    jt = np.asarray(jtiles).reshape(K, 7, 4, 7, 7).transpose(0, 1, 3, 4, 2)
    assert max_err(jt[..., 3], ttiles[..., 3]) <= 1e-5 * float(np.abs(jt[..., 3]).max())


def test_p2g_plain_is_deterministic():
    _, tcfg, jst, jpm = _sorted_state(("jelly",), v_scale=2.0)
    tst = convert.packed_from_numpy(np.asarray(jst))
    s_arr = torch.as_tensor(np.asarray(jpm["s_arr"]))
    e_arr = torch.as_tensor(np.asarray(jpm["e_arr"]))
    a = tp2g.p2g_fused(s_arr, e_arr, tst, 2e-4, tcfg)
    b = tp2g.p2g_fused(s_arr, e_arr, tst, 2e-4, tcfg)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_prep_packed_matches_jax():
    """The operand both P2G versions build: the port's prep_packed vs the
    JAX package's (which decodes origins from the keys)."""
    jcfg, tcfg, jst, jpm = _sorted_state(("jelly",), v_scale=0.5)
    keys = tpacked._keys_of(convert.packed_from_numpy(np.asarray(jst)), tcfg)
    jpd, _ = jpacked.prep_packed(jst, jnp.asarray(keys.numpy()), jcfg, jcfg.base_dt)
    pw = jst.shape[1]
    tpd = tp2g.prep_packed(convert.packed_from_numpy(np.asarray(jst)), tcfg, jcfg.base_dt)
    jpd = np.asarray(jpd)[:, :pw]
    for r in range(16):
        assert max_err(jpd[r], tpd[r]) <= 1e-6 * max(float(np.abs(jpd[r]).max()), 1e-30), r


def test_p2g_wrapper_checks_inputs():
    _, tcfg, jst, jpm = _sorted_state(("jelly",), v_scale=0.5)
    tst = convert.packed_from_numpy(np.asarray(jst))
    s64 = torch.as_tensor(np.asarray(jpm["s_arr"])).long()
    with pytest.raises(ValueError, match="int32"):
        tp2g.p2g_fused(s64, s64, tst, 2e-4, tcfg)
    with pytest.raises(ValueError, match="float32"):
        tp2g.p2g_fused(s64.int(), s64.int(), tst.double(), 2e-4, tcfg)


def test_device_material_check_names_material():
    """Every material has device code, alone and in any mix; only a
    kernel order other than the quadratic one is refused."""
    for mats in [(m,) for m in range(8)] + [(1, 4), (2, 4, 7), tuple(range(8))]:
        _, tcfg = configs(mats)
        tp2g.check_device_materials(tcfg)
        assert tp2g.material_set(tcfg) == sum(1 << m for m in mats)
    assert tp2g.DEVICE_MATERIALS == tuple(range(8))
    _, cubic = configs((1, 4), kernel_order=3)
    with pytest.raises(NotImplementedError, match="kernel_order=3"):
        tp2g.check_device_materials(cubic)
