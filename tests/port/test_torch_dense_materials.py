"""Port vs JAX: the B-spline weights of every order and the matrix-form
materials of the dense path.

``math/kernels.bspline_weights`` for orders 1-3 against the JAX
package's to 1e-7 (absolute; the weights lie in [0, 1]). Every
material's force, return map, dt limit and potential energy against
``taichi_mpm_tpu.materials.models`` in 2-D and 3-D on edge inputs (see
``edge_inputs``), the JAX functions run op by op on the CPU. Bounds:
F and aux 5e-6 (absolute), plasticity counts exact, forces 2e-6 of the
batch's largest |force|, dt limits and energies 2e-6 relative; NaN in
the same places.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.materials import models as jmodels
from taichi_mpm_tpu.math import kernels as jkernels
from taichi_mpm_torch.materials import models as tmodels
from taichi_mpm_torch.math import kernels as tkernels

torch.set_num_threads(1)

MATERIALS = ("elastic", "jelly", "snow", "water", "sand", "von_mises", "linear", "visco")


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_bspline_weights(order, dim):
    rng = np.random.default_rng(order * 10 + dim)
    x = rng.uniform(0.0, 40.0, (500, dim)).astype(np.float32)
    x[:4] = np.float32([0.5, 1.0, 1.5, 2.0])[:, None]  # stencil edges
    jb, jw, jdw = jkernels.bspline_weights(order, jnp.asarray(x))
    tb, tw, tdw = tkernels.bspline_weights(order, torch.as_tensor(x))
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert tw.shape == (500, dim, tkernels.stencil_size(order))
    assert np.abs(np.asarray(jw) - tw.numpy()).max() <= 1e-7
    assert np.abs(np.asarray(jdw) - tdw.numpy()).max() <= 1e-7
    assert tkernels.inv_D(order) == jkernels.inv_D(order)


def test_bspline_rejects_other_orders():
    with pytest.raises(ValueError, match="order 4"):
        tkernels.bspline_weights(4, torch.zeros(3, 2))


def edge_inputs(name, dim, n=96, seed=0):
    """(F, cdg, aux, params, vol) of one material: F near I stretched by
    up to 30%, and lanes at its edges: F near a rotation (by up to pi),
    inverted F (a column negated), strong compression and stretch (snow's
    clamps, sand in and out of its cone, von Mises yield), cdg near I; aux
    spread over the material's range; one lane with a NaN in F."""
    rng = np.random.default_rng(seed + 17 * dim)
    d = dim
    F = np.eye(d) + 0.3 * rng.uniform(-1, 1, (n, d, d))
    ang = rng.uniform(-np.pi, np.pi, n // 4)
    rot = np.tile(np.eye(d), (n // 4, 1, 1))
    rot[:, 0, 0], rot[:, 0, 1] = np.cos(ang), -np.sin(ang)
    rot[:, 1, 0], rot[:, 1, 1] = np.sin(ang), np.cos(ang)
    F[: n // 4] = rot * (1 + 1e-3 * rng.standard_normal((n // 4, d, d)))
    F[n // 4: n // 4 + 8, :, 0] *= -1.0  # inverted
    F[n // 4 + 8: n // 4 + 16] *= rng.uniform(0.5, 0.8, (8, 1, 1))  # compressed
    F[n // 4 + 16: n // 4 + 24] *= rng.uniform(1.2, 1.6, (8, 1, 1))  # stretched
    F[-1, 0, 0] = np.nan
    cdg = np.eye(d) + 0.05 * rng.uniform(-1, 1, (n, d, d))
    mid, params, aux0 = tmodels.pack_params(name)
    aux_range = {"snow": (0.5, 2.0), "water": (0.05, 1.6), "sand": (-0.2, 0.2),
                 "visco": (0.0, 3000.0)}.get(name, (aux0, aux0))
    aux = rng.uniform(*aux_range, n)
    params = np.broadcast_to(np.asarray(params), (n, 8))
    vol = rng.uniform(0.5e-6, 2e-6, n)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return mid, f32(F), f32(cdg), f32(aux), f32(params), f32(vol)


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


def assert_close(j, t, bound):
    j = np.asarray(j, np.float64)
    t = t.numpy().astype(np.float64)
    assert np.array_equal(np.isnan(j), np.isnan(t))
    ok = ~np.isnan(j)
    err = np.abs(j[ok] - t[ok]).max()
    assert err <= bound, err


def assert_relative(j, t, bound=2e-6):
    """Within `bound` relative where finite; NaN and inf in the same places."""
    j = np.asarray(j, np.float64)
    t = t.numpy().astype(np.float64)
    assert np.array_equal(np.isnan(j), np.isnan(t))
    assert np.array_equal(np.isinf(j), np.isinf(t))
    fin = np.isfinite(j)
    assert not fin.any() or np.abs(t[fin] / j[fin] - 1.0).max() <= bound


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", MATERIALS)
def test_force(name, dim):
    mid, F, _, aux, params, vol = edge_inputs(name, dim)
    (jF, jaux, jpar, jvol), (tF, taux, tpar, tvol) = both(F, aux, params, vol)
    want = np.asarray(jmodels.FORCE_FNS[mid](jF, jaux, jpar, jvol))
    got = tmodels.FORCE_FNS[mid](tF, taux, tpar, tvol)
    assert_close(want, got, 2e-6 * np.nanmax(np.abs(want)))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", MATERIALS)
def test_return_map(name, dim):
    mid, F, cdg, aux, params, _ = edge_inputs(name, dim)
    (jF, jcdg, jaux, jpar), (tF, tcdg, taux, tpar) = both(F, cdg, aux, params)
    jF2, jaux2, jcnt = jmodels.PLASTICITY_FNS[mid](jF, jcdg, jaux, jpar, 1e-4)
    tF2, taux2, tcnt = tmodels.PLASTICITY_FNS[mid](tF, tcdg, taux, tpar, 1e-4)
    assert_close(jF2, tF2, 5e-6)
    assert_close(jaux2, taux2, 5e-6)
    assert np.array_equal(np.asarray(jcnt), tcnt.numpy())
    if name in ("water", "sand", "von_mises"):
        assert 0 < int(tcnt.sum()) < len(F)  # both branches reached


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", MATERIALS)
def test_allowed_dt_and_energy(name, dim):
    mid, F, _, aux, params, vol = edge_inputs(name, dim)
    mass = vol * 400.0
    speed = np.linspace(0.0, 3.0, len(F)).astype(np.float32)
    (jF, jaux, jpar, jvol, jm, js), (tF, taux, tpar, tvol, tm, ts) = both(
        F, aux, params, vol, mass, speed)
    want = np.asarray(jmodels.allowed_dt(mid, jF, jaux, jpar, jvol, jm, js, 1.0 / 32))
    assert_relative(want, tmodels.allowed_dt(mid, tF, taux, tpar, tvol, tm, ts, 1.0 / 32))
    ok = ~np.isnan(F).any((1, 2))  # the energy of the NaN lane is NaN in both
    want = np.asarray(jmodels.potential_energy(mid, jF, jaux, jpar, jvol))[ok]
    got = tmodels.potential_energy(mid, tF, taux, tpar, tvol)[ok]
    assert_close(want, got, 2e-6 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dim", [2, 3])
def test_dispatch_blends_by_material(dim):
    """The dispatch over all eight materials at once: each lane takes its
    own material's force, return map and dt limit."""
    lanes = [0, 9, 24, 25, 32, 33, 40, 41, 60, 80, 94, 95]  # 12 of each kind, 96 in all
    parts = [edge_inputs(name, dim, seed=i) for i, name in enumerate(MATERIALS)]
    mids = tuple(range(8))
    mat = np.concatenate([np.full(len(lanes), p[0], np.int32) for p in parts])
    F, cdg, aux, params, vol = (np.concatenate([p[k][lanes] for p in parts])
                                for k in range(1, 6))
    (jmat, jF, jcdg, jaux, jpar, jvol), (tmat, tF, tcdg, taux, tpar, tvol) = both(
        mat, F, cdg, aux, params, vol)
    want = np.asarray(jmodels.dispatch_force(mids, jmat, jF, jaux, jpar, jvol))
    assert_close(want, tmodels.dispatch_force(mids, tmat, tF, taux, tpar, tvol),
                 2e-6 * np.nanmax(np.abs(want)))
    jF2, jaux2, jcnt = jmodels.dispatch_plasticity(mids, jmat, jF, jcdg, jaux, jpar, 1e-4)
    tF2, taux2, tcnt = tmodels.dispatch_plasticity(mids, tmat, tF, tcdg, taux, tpar, 1e-4)
    assert_close(jF2, tF2, 5e-6)
    assert_close(jaux2, taux2, 5e-6)
    assert np.array_equal(np.asarray(jcnt), tcnt.numpy())
    speed = np.full(len(F), 0.5, np.float32)
    want = np.asarray(jmodels.dispatch_allowed_dt(mids, jmat, jF, jaux, jpar, jvol, jvol * 400,
                                                  jnp.asarray(speed), 1.0 / 32))
    assert_relative(want, tmodels.dispatch_allowed_dt(mids, tmat, tF, taux, tpar, tvol,
                                                      tvol * 400, torch.as_tensor(speed),
                                                      1.0 / 32))
