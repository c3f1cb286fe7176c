"""Port vs JAX: component-form 3x3 math and the 8 material models.

Same random F, cdg, aux and params (numpy, seeded) through
``taichi_mpm_tpu.materials.cforms`` and ``taichi_mpm_torch.materials.
cforms``. Both run float32 elementwise formulas in the same order; the
bound 2e-5 x max|value| allows for the libm differences of exp/log/pow
and the rsqrt of the Jacobi sweeps between XLA:CPU and torch, compounded
through the SVD-based return maps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.materials import cforms as jcf
from taichi_mpm_tpu.math import cmat3 as jc3
from taichi_mpm_torch.materials import cforms as tcf
from taichi_mpm_torch.materials import models as tmodels
from taichi_mpm_torch.math import cmat3 as tc3

from port_helpers import max_err

torch.set_num_threads(1)

N = 512
REL = 2e-5


def _rand_F(rng, scale=0.3):
    return (np.eye(3, dtype=np.float32)[None]
            + scale * rng.standard_normal((N, 3, 3)).astype(np.float32))


def _both(a):
    """numpy (N, 3, 3) -> (JAX 9-tuple, torch 9-tuple)."""
    j = tuple(jnp.asarray(a[:, i, k]) for i in range(3) for k in range(3))
    t = tuple(torch.as_tensor(a[:, i, k].copy()) for i in range(3) for k in range(3))
    return j, t


def _close(js, ts, rel=REL):
    js, ts = list(js), list(ts)
    scale = max(max(float(np.max(np.abs(np.asarray(j)))) for j in js), 1e-30)
    err = max(max_err(j, t) for j, t in zip(js, ts))
    assert err <= rel * scale, (err, scale)


def test_cmat3_polar_svd_inverse():
    rng = np.random.default_rng(0)
    Fj, Ft = _both(_rand_F(rng))
    _close(jc3.c_polar_newton(Fj), tc3.c_polar_newton(Ft))
    _close(jc3.c_inv_transpose(Fj), tc3.c_inv_transpose(Ft))
    Uj, sj, Vj = jc3.c_svd(Fj)
    Ut, st, Vt = tc3.c_svd(Ft)
    _close(sj, st)
    _close(Uj, Ut)
    _close(Vj, Vt)
    _close([jc3.c_det(Fj)], [tc3.c_det(Ft)])


@pytest.mark.parametrize("material", sorted(tmodels.MATERIAL_NAMES))
def test_material_force_plasticity(material):
    rng = np.random.default_rng(1 + tmodels.MATERIAL_NAMES[material])
    mid, params, aux0 = tmodels.pack_params(material)
    Fj, Ft = _both(_rand_F(rng, 0.2))
    cdgj, cdgt = _both(_rand_F(rng, 0.02))
    aux = (aux0 + 0.05 * rng.standard_normal(N)).astype(np.float32)
    if material == "water":
        aux = np.abs(aux) + 0.5  # j > 0
    par = np.broadcast_to(np.asarray(params, np.float32), (N, 8)).copy()
    par *= (1.0 + 0.1 * rng.random((N, 8))).astype(np.float32)
    vol = (1e-6 * (1.0 + rng.random(N))).astype(np.float32)
    pj = tuple(jnp.asarray(par[:, k]) for k in range(8))
    pt = tuple(torch.as_tensor(par[:, k].copy()) for k in range(8))
    dt = 2e-4

    fj = jcf.FORCE_FNS[mid](Fj, jnp.asarray(aux), pj, jnp.asarray(vol))
    ft = tcf.FORCE_FNS[mid](Ft, torch.as_tensor(aux), pt, torch.as_tensor(vol))
    _close(fj, ft)

    Fnj, auxj, cj = jcf.PLASTICITY_FNS[mid](Fj, cdgj, jnp.asarray(aux), pj, dt)
    Fnt, auxt, ct = tcf.PLASTICITY_FNS[mid](Ft, cdgt, torch.as_tensor(aux), pt, dt)
    _close(Fnj, Fnt)
    _close([auxj], [auxt])
    assert np.array_equal(np.asarray(cj), ct.numpy())

    spd = np.abs(rng.standard_normal(N)).astype(np.float32)
    mass = (4e-4 * (1.0 + rng.random(N))).astype(np.float32)
    dj = jcf.allowed_dt(mid, Fj, jnp.asarray(aux), pj, jnp.asarray(vol),
                        jnp.asarray(mass), jnp.asarray(spd), 1.0 / 32)
    dt_t = tcf.allowed_dt(mid, Ft, torch.as_tensor(aux), pt, torch.as_tensor(vol),
                          torch.as_tensor(mass), torch.as_tensor(spd), 1.0 / 32)
    dj, dt_t = np.asarray(dj), dt_t.numpy()
    assert np.array_equal(np.isinf(dj), np.isinf(dt_t))
    fin = np.isfinite(dj)
    if fin.any():
        _close([dj[fin]], [dt_t[fin]])


def test_dispatch_multimaterial():
    """The blended dispatch picks each particle's own material."""
    rng = np.random.default_rng(7)
    mats = [tmodels.JELLY, tmodels.WATER, tmodels.SAND]
    mat = np.asarray([mats[i % 3] for i in range(N)], np.int32)
    par = np.zeros((N, 8), np.float32)
    aux = np.zeros(N, np.float32)
    for m in mats:
        _, params, aux0 = tmodels.pack_params(tmodels.MATERIAL_IDS[m])
        par[mat == m] = params
        aux[mat == m] = aux0
    Fj, Ft = _both(_rand_F(rng, 0.1))
    cdgj, cdgt = _both(_rand_F(rng, 0.02))
    vol = np.full(N, 1e-6, np.float32)
    pj = tuple(jnp.asarray(par[:, k]) for k in range(8))
    pt = tuple(torch.as_tensor(par[:, k].copy()) for k in range(8))
    _close(jcf.dispatch_force(tuple(mats), jnp.asarray(mat), Fj, jnp.asarray(aux), pj,
                              jnp.asarray(vol)),
           tcf.dispatch_force(tuple(mats), torch.as_tensor(mat), Ft, torch.as_tensor(aux),
                              pt, torch.as_tensor(vol)))
    Fnj, auxj, cj = jcf.dispatch_plasticity(tuple(mats), jnp.asarray(mat), Fj, cdgj,
                                            jnp.asarray(aux), pj, 2e-4)
    Fnt, auxt, ct = tcf.dispatch_plasticity(tuple(mats), torch.as_tensor(mat), Ft, cdgt,
                                            torch.as_tensor(aux), pt, 2e-4)
    _close(Fnj, Fnt)
    _close([auxj], [auxt])
    assert np.array_equal(np.asarray(cj), ct.numpy())


def test_param_packing_matches():
    from taichi_mpm_tpu.materials import models as jmodels

    for name in tmodels.MATERIAL_NAMES:
        assert jmodels.pack_params(name) == tmodels.pack_params(name)
    assert jmodels.param_slot("sand", "cohesion") == tmodels.param_slot("sand", "cohesion")
    assert jmodels.lame_parameters(2e4, 0.35) == tmodels.lame_parameters(2e4, 0.35)
