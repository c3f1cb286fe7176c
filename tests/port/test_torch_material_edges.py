"""Port vs JAX: the eight materials on the kernels' hand-made edge inputs.

``diagnostics.p2g_edge_inputs`` and ``g2p_edge_inputs`` build, for each
material and for all eight on successive lanes, the inputs on which
``chip_smoke.py`` holds the CUDA kernels ``p2g_fused`` and ``g2p_fused``
to their twins. Here the twins' material code on those inputs goes
against the JAX package's ``materials.cforms``: the force on the P2G
state, and the return map on the G2P state with the cdg its gather
gives, held to ``test_torch_cforms.py``'s 2e-5 x max|value| with the NaN
lanes where JAX has them and the plasticity counts equal. The inputs must
reach the return maps' branches (sand at the tip and on the cone, snow
clipped on both sides, von Mises yielded, visco flowing and not), and
the fused G2P twin on all eight materials must match JAX's
``fused_pallas.g2p_fused`` (interpret mode), as
``test_torch_g2p_edges.py`` holds it on jelly and water."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.config import SimConfig as JConfig
from taichi_mpm_tpu.materials import cforms as jcf
from taichi_mpm_tpu.ops import blocked as jblocked
from taichi_mpm_tpu.ops import fused_pallas
from taichi_mpm_torch import diagnostics
from taichi_mpm_torch.materials import cforms as tcf
from taichi_mpm_torch.math import cmat3 as tc3
from taichi_mpm_torch.ops import blocked as tblocked
from taichi_mpm_torch.ops import g2p as tg2p
from taichi_mpm_torch.ops.rows import RACT, RAUX, RC, RF, RMAT, RPAR, RV, RVOL, RX

from port_helpers import max_err

torch.set_num_threads(1)

REL = 2e-5
MATERIALS = diagnostics.EDGE_MATERIALS + ("all",)
# the same inputs with F at the SVD's edges on the lanes whose kernels run
# one (diagnostics.SVD_EDGE_F): "<material>/svd"
FORCE_SVD = tuple(f"{m}/svd" for m in (*diagnostics.SVD_FORCE_MATERIALS, "all"))
PLAST_SVD = tuple(f"{m}/svd" for m in (*diagnostics.SVD_PLAST_MATERIALS, "all"))


def _case(case):
    """(material, svd) of a parameter "<material>" or "<material>/svd"."""
    material, _, svd = case.partition("/")
    return material, svd == "svd"
BOUNDS = ((RX, 3, 5e-6), (RV, 3, 5e-5), (RF, 9, 5e-6), (RC, 9, 5e-4), (RAUX, 1, 5e-6))


def _rows(st, r0, n):
    return tuple(st[r0 + k] for k in range(n))


def _close(js, ts):
    """Each component within REL x the largest |value| of JAX's, with NaN
    in the same places."""
    j = np.stack([np.asarray(a) for a in js]).astype(np.float64)
    t = np.stack([np.asarray(a) for a in ts]).astype(np.float64)
    assert np.array_equal(np.isnan(j), np.isnan(t))
    ok = ~np.isnan(j)
    scale = max(float(np.abs(j[ok]).max()), 1e-30)
    err = float(np.abs(j[ok] - t[ok]).max())
    assert err <= REL * scale, (err, scale)


def _both(st, cfg, fn_j, fn_t, *extra):
    """A material dispatch of each package on the active lanes of `st`:
    (mat, F, [extra], aux, params, ...) built from the state's rows."""
    act = st[RACT] > 0.5
    s = st[:, act]
    mat = s[RMAT].view(np.int32)
    ex = tuple(e[:, act] for e in extra)
    args = lambda conv: (
        conv(mat), tuple(conv(r) for r in _rows(s, RF, 9)),
        *[tuple(conv(r) for r in e) for e in ex], conv(s[RAUX]),
        tuple(conv(r) for r in _rows(s, RPAR, 8)))
    return (fn_j(cfg.active_materials, *args(jnp.asarray)),
            fn_t(cfg.active_materials, *args(lambda a: torch.as_tensor(np.ascontiguousarray(a)))))


@pytest.mark.parametrize("material", MATERIALS + FORCE_SVD)
def test_force_matches_jax(material):
    material, svd = _case(material)
    e = diagnostics.p2g_edge_inputs(material, svd=svd)
    if svd:
        assert _svd_edge_lanes(e["st"], diagnostics.SVD_FORCE_MATERIALS) >= 12
    st, cfg = e["st"], e["cfg"]
    vol = st[RVOL, st[RACT] > 0.5]
    fj, ft = _both(st, cfg, lambda *a: jcf.dispatch_force(*a, jnp.asarray(vol)),
                   lambda *a: tcf.dispatch_force(*a, torch.as_tensor(vol)))
    _close(fj, ft)


def _svd_edge_f(st):
    """(Pw,) bool: the lanes whose F is one of SVD_EDGE_F."""
    edge = np.stack([np.asarray(F, np.float32).reshape(9) for _, F, _ in diagnostics.SVD_EDGE_F])
    return (st[RF:RF + 9].T[:, None, :] == edge[None]).all(-1).any(-1)


def _svd_edge_lanes(st, materials):
    """Active lanes of `materials` whose F is one of SVD_EDGE_F."""
    mids = [diagnostics.models.MATERIAL_NAMES[m] for m in materials]
    return int((_svd_edge_f(st) & (st[RACT] > 0.5)
                & np.isin(st[RMAT].view(np.int32), mids)).sum())


def _g2p_inputs(material, svd=False):
    """The G2P edge inputs of `material` with the cdg of their gather."""
    e = diagnostics.g2p_edge_inputs(material, svd=svd)
    cfg = e["cfg"]
    win = tblocked.windows(torch.as_tensor(e["vrec"]), torch.as_tensor(e["nbr"]))
    acc = tg2p._gather_plain(torch.as_tensor(e["keys"]), torch.as_tensor(e["st"]), win, cfg)
    k = tg2p._k_cdg(cfg, cfg.base_dt)
    cdg = np.stack([(1.0 if i % 4 == 0 else 0.0) - k * acc[3 + i].numpy() for i in range(9)])
    return e, cdg.astype(np.float32)


@pytest.fixture(scope="module", params=MATERIALS + PLAST_SVD)
def g2p_case(request):
    material, svd = _case(request.param)
    e, cdg = _g2p_inputs(material, svd)
    if svd:  # cdg = I on those lanes (no slot), so the return map's SVD sees F itself
        assert _svd_edge_lanes(e["st"], diagnostics.SVD_PLAST_MATERIALS) >= 24
    return material, e, cdg


def test_return_map_matches_jax(g2p_case):
    material, e, cdg = g2p_case
    st, cfg = e["st"], e["cfg"]
    dt = float(np.float32(cfg.base_dt))
    (Fj, aj, cj), (Ft, at, ct) = _both(
        st, cfg, lambda *a: jcf.dispatch_plasticity(*a, dt),
        lambda *a: tcf.dispatch_plasticity(*a, dt), cdg)
    _close(Fj, Ft)
    _close([aj], [at])
    assert np.array_equal(np.asarray(cj), ct.numpy())
    assert np.isnan(np.stack([f.numpy() for f in Ft])).any(0).sum() == (
        8 if material == "all" else 1)  # the NaN lanes of F


def _sand_terms(F, cdg, aux, par):
    """tr and delta_gamma of the sand return map (cforms.plast_sand)."""
    _, sig, _ = tc3.c_svd(tc3.c_mm(cdg, F))
    eps = [torch.log(torch.clamp(torch.abs(s), min=1e-4)) - par[3] for s in sig]
    tr = eps[0] + eps[1] + eps[2] + aux
    eh = [x - tr / 3.0 for x in eps]
    ehn = torch.sqrt(eh[0] ** 2 + eh[1] ** 2 + eh[2] ** 2)
    return tr, ehn + (3.0 * par[1] + 2.0 * par[0]) / (2.0 * par[0]) * tr * par[2]


def test_inputs_reach_the_branches(g2p_case):
    material, e, cdg = g2p_case
    st = e["st"]
    mats = st[RMAT].view(np.int32)
    # the random lanes (F near I); the lanes with F at the SVD's edges
    # (svd cases) reach other branches, which is what they are for
    act = (st[RACT] > 0.5) & np.isfinite(st[RF:RF + 9]).all(0) & ~_svd_edge_f(st)
    names = diagnostics.edge_material_names(material)
    for name in names:
        mid = diagnostics.models.MATERIAL_NAMES[name]
        lanes = act & (mats == mid)
        assert lanes.sum() >= 100
        t = lambda r0, n: tuple(torch.as_tensor(st[r0 + k, lanes]) for k in range(n))
        F, par, aux = t(RF, 9), t(RPAR, 8), torch.as_tensor(st[RAUX, lanes])
        c = tuple(torch.as_tensor(cdg[k, lanes]) for k in range(9))
        if name == "sand":
            tr, dg = _sand_terms(F, c, aux, par)
            assert (tr >= 0).sum() >= 20 and ((tr < 0) & (dg > 0)).sum() >= 20
            assert ((tr < 0) & (dg <= 0)).sum() >= 5
        elif name == "snow":
            _, sig, _ = tc3.c_svd(tc3.c_mm(c, F))
            s = torch.stack(sig)
            assert (s < 1.0 - par[3]).any(0).sum() >= 20 and (s > 1.0 + par[4]).any(0).sum() >= 20
        elif name == "von_mises":
            _, _, cnt = tcf.plast_von_mises(F, c, aux, par, 1e-4)
            assert 20 <= int(cnt.sum()) < int(lanes.sum())
        elif name == "visco":
            pnorm = tcf._visco_pk1_norm(F, par[0], par[1])
            assert bool((pnorm > 1e-5).all())
            assert (pnorm > aux).sum() >= 20 and (pnorm < aux).sum() >= 20


def test_g2p_fused_all_materials_matches_jax():
    """The whole fused G2P twin on the eight materials at once, against
    JAX's fused kernel (windows from windows_mm27, as in
    test_torch_g2p_edges.py), at test_torch_g2p.py's bounds."""
    e = diagnostics.g2p_edge_inputs("all")
    cfg = e["cfg"]
    K = e["vrec"].shape[0]
    gtiles = jblocked.windows_mm27(jnp.asarray(e["vrec"]), jnp.asarray(e["nbr"]))
    jnew, jvmax, jplast = fused_pallas.g2p_fused(
        jnp.asarray(e["keys"])[None, :], jnp.asarray(e["st"]), gtiles,
        jnp.asarray([K], jnp.int32), cfg.base_dt, JConfig(**dataclasses.asdict(cfg)),
        interpret=True)
    jnew = np.asarray(jnew)
    win = tblocked.windows(torch.as_tensor(e["vrec"]), torch.as_tensor(e["nbr"]))
    tnew = torch.as_tensor(e["st"]).clone()
    tvmax, tplast = tg2p.g2p_fused_plain(torch.as_tensor(e["keys"]), tnew, win,
                                         cfg.base_dt, cfg)
    tnew = tnew.numpy()
    assert np.array_equal(jnew[RACT], tnew[RACT])
    assert (tnew[RACT, 16:24] == 0).all()  # the NaN lanes, one of each material, scrubbed
    for r0, nr, bound in BOUNDS:
        assert max_err(jnew[r0:r0 + nr], tnew[r0:r0 + nr]) <= bound, r0
    assert np.array_equal(jnew[25:], tnew[25:])
    jv = float(np.max(np.asarray(jvmax)))
    assert abs(jv - float(tvmax)) <= 1e-6 * jv
    assert int(np.sum(np.asarray(jplast))) == int(tplast) > 0
