"""Port vs JAX: P2G on hand-made inputs at the kernels' edges.

``diagnostics.p2g_edge_inputs`` builds the inputs on which
``chip_smoke.py`` holds the CUDA P2G kernels to their twins: one slot of
1,200 particles, supports reaching tile nodes 0 and 6 (particles 0.45
cell outside their sort-time block), positions on exact half-cells
(weights exactly 0), one-particle slots, empty slots among the live ones
and after them, K odd. Their operand (the port's ``prep_packed``) goes
to the JAX package's ``p2g_pallas.p2g_blocked`` in interpret mode (Ppad a
multiple of 128 with CHUNK lanes of slack) and to the port's
``p2g_blocked_plain``; tiles and merged node records agree to 1e-5 x
max|value|, the bound of ``test_torch_p2g_blocked.py``. So the twin that
the card holds the kernels against is right at those edges."""

import numpy as np
import pytest
import torch

from taichi_mpm_tpu.ops import blocked as jblocked
from taichi_mpm_tpu.ops import p2g_pallas
from taichi_mpm_torch import diagnostics
from taichi_mpm_torch.math.kernels import quadratic_weight
from taichi_mpm_torch.ops import blocked as tblocked
from taichi_mpm_torch.ops import p2g as tp2g

from port_helpers import max_err, np_of

torch.set_num_threads(1)

REL = 1e-5


def _jax_operand(pdata):
    """The operand padded to a multiple of 128 lanes plus CHUNK lanes of
    slack, as the reference kernel's DMA windows need."""
    pw = pdata.shape[1]
    ppad = -(-pw // 128) * 128 + p2g_pallas.CHUNK
    return np.pad(pdata, ((0, 0), (0, ppad - pw)))


@pytest.fixture(scope="module", params=["jelly", "water", "sand/svd"])
def edges(request):
    """"sand/svd": sand with F at the SVD's edges and slots of
    SVD_EDGE_SLOTS particles (``p2g_edge_inputs(svd=True)``)."""
    material, _, svd = request.param.partition("/")
    e = diagnostics.p2g_edge_inputs(material, svd=svd == "svd")
    st = torch.as_tensor(e["st"])
    pdata = tp2g.prep_packed(st, e["cfg"], e["cfg"].base_dt)
    s_arr, e_arr = torch.as_tensor(e["s_arr"]), torch.as_tensor(e["e_arr"])
    jtiles = p2g_pallas.p2g_blocked(e["s_arr"], e["e_arr"], _jax_operand(np_of(pdata)),
                                    interpret=True)
    return dict(e, st_t=st, pdata=pdata, s_t=s_arr, e_t=e_arr, jtiles=np.asarray(jtiles),
                tiles=tp2g.p2g_blocked_plain(s_arr, e_arr, pdata))


def test_tiles_and_records_match_jax(edges):
    K = edges["s_arr"].shape[0]
    jt = edges["jtiles"].reshape(K, 7, 4, 7, 7).transpose(0, 1, 3, 4, 2)
    tt = edges["tiles"]
    assert tt.shape == (K, 7, 7, 7, 4)
    assert max_err(jt, tt) <= REL * float(np.abs(jt).max())
    jrec = np.asarray(jblocked.merge_tiles_mm(edges["jtiles"], edges["nbr"]))
    trec = tblocked.merge_tiles(tt, torch.as_tensor(edges["nbr"]))
    assert max_err(jrec, trec) <= REL * float(np.abs(jrec).max())


def test_empty_slots_give_zero_tiles(edges):
    empty = edges["s_arr"] == edges["e_arr"]
    assert empty.sum() == 5 and not empty[-5]  # one among the live slots, four after
    assert not edges["jtiles"][empty].any()
    assert not np_of(edges["tiles"])[empty].any()
    assert np_of(edges["tiles"])[~empty].any(axis=(1, 2, 3, 4)).all()


def test_inputs_reach_the_edges(edges):
    """What the inputs are for: supports at both tile edges, weights
    exactly 0 on half-cells, slots of one particle and of 1,200."""
    counts = edges["e_arr"] - edges["s_arr"]
    assert counts.max() == 1200 and (counts == 1).sum() == 5 and 33 in counts
    pos = edges["pdata"][13:16, :counts.sum()]
    base = torch.floor(pos - 0.5)
    assert base.min() == -1 and base.max() == 3  # support tile nodes 0 .. 6
    assert float(pos.min()) < -0.44 and float(pos.max()) > 4.44
    half = (pos - 0.5 == torch.round(pos - 0.5))
    assert int(half.all(0).sum()) >= 64
    w_last = quadratic_weight(pos - (base + 2))
    assert torch.equal(half, w_last == 0.0)


def test_fused_plain_is_prep_then_blocked_plain(edges):
    """The fused twin on the edge state gives the bits of the operand
    prep followed by the scatter."""
    cfg = edges["cfg"]
    fused = tp2g.p2g_fused_plain(edges["s_t"], edges["e_t"], edges["st_t"], cfg.base_dt, cfg)
    assert torch.equal(fused, edges["tiles"])
