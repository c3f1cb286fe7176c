"""Port vs JAX: the fused G2P + finish on hand-made inputs at its edges.

``diagnostics.g2p_edge_inputs`` builds the inputs on which
``chip_smoke.py`` holds the CUDA kernel ``g2p_fused`` to its twin: a slot
of more lanes than a CUDA block, a run of small slots that spans more
slots per block than the kernel stages in shared memory, one-lane slots,
inactive lanes among and after the active ones, active lanes with key K,
supports at the clamp edges (first node -2 and 7) and 0.45 cell outside
the block, exact half-cells, a NaN in F; jelly, water and both. The sorted
state, keys and velocity records go to the JAX package's
``fused_pallas.g2p_fused`` in interpret mode (its windows from the
27-offset ``windows_mm27``, as the hand-made page map is not the dilated
one the separable assembly needs) and to the port's ``g2p_fused_plain``,
held to ``test_torch_g2p.py``'s bounds: x 5e-6, v 5e-5, F 5e-6, C 5e-4,
aux 5e-6 absolute; vmax 1e-6 relative; the active mask and the
plasticity count exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.config import SimConfig as JConfig
from taichi_mpm_tpu.ops import blocked as jblocked
from taichi_mpm_tpu.ops import fused_pallas
from taichi_mpm_torch import diagnostics
from taichi_mpm_torch.ops import blocked as tblocked
from taichi_mpm_torch.ops import g2p as tg2p
from taichi_mpm_torch.ops.rows import RACT, RAUX, RC, RF, RV, RX

from port_helpers import max_err, np_of

torch.set_num_threads(1)

BOUNDS = ((RX, 3, 5e-6), (RV, 3, 5e-5), (RF, 9, 5e-6), (RC, 9, 5e-4), (RAUX, 1, 5e-6))


def _port_run(e, keys, st):
    """g2p_fused_plain on copies of the edge inputs: (state, vmax, plast)."""
    win = tblocked.windows(torch.as_tensor(e["vrec"]), torch.as_tensor(e["nbr"]))
    out = torch.as_tensor(st).clone()
    vmax, plast = tg2p.g2p_fused_plain(torch.as_tensor(keys), out, win, e["cfg"].base_dt,
                                       e["cfg"])
    return out.numpy(), float(vmax), int(plast)


@pytest.fixture(scope="module", params=["jelly", "water", "mixed"])
def edges(request):
    e = diagnostics.g2p_edge_inputs(request.param)
    return dict(e, port=_port_run(e, e["keys"], e["st"]))


def test_g2p_edges_match_jax(edges):
    cfg = edges["cfg"]
    jcfg = JConfig(**dataclasses.asdict(cfg))
    K = edges["vrec"].shape[0]
    gtiles = jblocked.windows_mm27(jnp.asarray(edges["vrec"]), jnp.asarray(edges["nbr"]))
    jnew, jvmax, jplast = fused_pallas.g2p_fused(
        jnp.asarray(edges["keys"])[None, :], jnp.asarray(edges["st"]), gtiles,
        jnp.asarray([K], jnp.int32), cfg.base_dt, jcfg, interpret=True)
    jnew = np.asarray(jnew)
    tnew, tvmax, tplast = edges["port"]

    assert np.array_equal(jnew[RACT], tnew[RACT])
    for r0, nr, bound in BOUNDS:
        assert max_err(jnew[r0:r0 + nr], tnew[r0:r0 + nr]) <= bound, r0
    assert np.array_equal(jnew[25:], tnew[25:])  # untouched rows, bit for bit
    jv = float(np.max(np.asarray(jvmax)))
    assert abs(jv - tvmax) <= 1e-6 * jv
    assert int(np.sum(np.asarray(jplast))) == tplast


def test_inactive_lanes_untouched_and_nan_scrubbed(edges):
    st, (tnew, _, tplast) = edges["st"], edges["port"]
    idle = st[RACT] <= 0.5
    assert idle[-1] and (idle & (edges["keys"] < edges["vrec"].shape[0])).sum() >= 5
    assert np.array_equal(st[:, idle], tnew[:, idle])
    assert tnew[RACT, 17] == 0.0 and np.array_equal(tnew[RF:RF + 9, 17], np.eye(3).ravel())
    assert (tplast > 0) == (edges["cfg"].active_materials != (1,))  # water counts events


def test_inputs_reach_the_edges(edges):
    """What the inputs are for: slots of one lane and of more than a CUDA
    block, blocks that span more slots than the kernel stages, first
    support nodes -2 .. 7, weights exactly 0 on half-cells, active lanes
    with key K."""
    st, keys = edges["st"], edges["keys"]
    K = edges["vrec"].shape[0]
    counts = np.bincount(keys[keys < K], minlength=K)
    assert counts.max() > 512 and (counts == 1).sum() >= 4
    act = st[RACT] > 0.5
    assert ((keys == K) & act).sum() == 6
    assert ((keys < K) & ~act).sum() >= 5
    pos = st[RX:RX + 3] * np.float32(edges["cfg"].inv_dx) - st[43:46]
    base = np.floor(pos[:, keys < K] - 0.5)
    assert base.min() == -2 and base.max() == 8  # clamped to 7 by the kernels
    assert ((pos[:, keys < K] - 0.5) == np.round(pos[:, keys < K] - 0.5)).all(0).sum() >= 64
    for lanes in (64, 128, 256):  # lanes per CUDA block: the kernel's 128 and its neighbours
        share = diagnostics.g2p_staged_share(torch.as_tensor(keys), torch.as_tensor(st),
                                             lanes, 4, K)
        assert 0.5 < share < 0.9  # both gather paths of the kernel run


def test_twin_ignores_lane_order(edges):
    """The kernel must give the same bits on unsorted keys; so does its
    twin, which the card holds it to on a permuted copy of these lanes."""
    perm = np.random.default_rng(1).permutation(edges["keys"].shape[0])
    pnew, pvmax, pplast = _port_run(edges, edges["keys"][perm], edges["st"][:, perm])
    tnew, tvmax, tplast = edges["port"]
    assert np.array_equal(np_of(pnew).view(np.int32), tnew[:, perm].view(np.int32))
    assert (pvmax, pplast) == (tvmax, tplast)
