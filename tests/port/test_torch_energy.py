"""Port vs JAX: the SVD, the potential energy and the diagnostics.

``svd3x3``, ``svd2x2``, ``polar_decomp`` and ``polar_newton`` on matrix
tensors against the JAX package's on stirred F (I + N(0, 0.2)) and on
degenerate ones: singular values to 2e-6, U and V to 1e-4 where the
singular values are 1e-3 apart (else each pair spans the same
subspace), U diag(s) V^T to 2e-6 of F. ``potential_energy`` of each
material and ``mechanical_energy`` within ENERGY_RTOL of JAX's (relative
to the sum of magnitudes of the terms; ``chip_smoke.py``'s
``energy_check`` holds the card to the CPU with it). Then the scene
surface: ``MPM.energy``, ``simulate_with_energy``, ``FrameProfiler``,
``general_action``, ``trace`` and ``device_memory_report``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu import diagnostics as jdiag
from taichi_mpm_tpu.config import SimConfig as JConfig
from taichi_mpm_tpu.core import solver as jsolver
from taichi_mpm_tpu.materials import models as jmodels
from taichi_mpm_tpu.math import svd as jsvd
from taichi_mpm_torch import MPM as TMPM
from taichi_mpm_torch import convert, diagnostics
from taichi_mpm_torch.core import solver as tsolver
from taichi_mpm_torch.materials import models as tmodels
from taichi_mpm_torch.math import svd as tsvd

from port_helpers import configs, jax_particles, max_err, scene_arrays

torch.set_num_threads(1)

ENERGY_RTOL = 1e-5
MATERIALS = tuple(tmodels.MATERIAL_NAMES)


def _stirred_F(n=512, d=3, spread=0.2, seed=0):
    rng = np.random.default_rng(seed)
    F = np.eye(d) + spread * rng.standard_normal((n, d, d))
    special = [np.eye(d), np.diag(np.arange(1.0, d + 1)[::-1]), -np.eye(d),
               np.diag([1.0] * (d - 1) + [-0.5]), np.diag([2.0] * d),
               np.diag([1.0] * (d - 1) + [0.0])]
    return np.concatenate([F, np.stack(special)]).astype(np.float32)


def _check_svd(jout, tout, F):
    (jU, js, jV), (tU, ts, tV) = [tuple(np.asarray(a, np.float64) for a in o)
                                  for o in (jout, (x.numpy() for x in tout))]
    assert max_err(ts, js) <= 2e-6
    recon = np.einsum("nij,nj,nkj->nik", tU, ts, tV)
    assert max_err(recon, F) <= 2e-6
    for R in (tU, tV):
        assert max_err(np.einsum("nji,njk->nik", R, R), np.eye(F.shape[-1])) <= 2e-6
        assert np.all(np.linalg.det(R) > 0)
    gaps = np.diff(js[:, ::-1], axis=1).min(1) if js.shape[1] > 1 else np.ones(len(js))
    apart = np.minimum(gaps, np.abs(js).min(1)) > 1e-3
    assert apart.sum() > 400
    assert max_err(tU[apart], jU[apart]) <= 1e-4 and max_err(tV[apart], jV[apart]) <= 1e-4


def test_svd3x3_matches_jax():
    F = _stirred_F()
    _check_svd(jsvd.svd3x3(jnp.asarray(F)), tsvd.svd(torch.as_tensor(F)), F)


def test_svd2x2_matches_jax():
    F = _stirred_F(d=2, seed=1)
    _check_svd(jsvd.svd2x2(jnp.asarray(F)), tsvd.svd(torch.as_tensor(F)), F)


def test_polar_matches_jax():
    F = _stirred_F(seed=2)[:512]
    jR, jS = jsvd.polar_decomp(jnp.asarray(F))
    tR, tS = tsvd.polar_decomp(torch.as_tensor(F))
    assert max_err(tR, jR) <= 1e-5 and max_err(tS, jS) <= 1e-5
    assert max_err(tsvd.polar_newton(torch.as_tensor(F)), jsvd.polar_newton(jnp.asarray(F))) <= 1e-5


def _energy_inputs(material, n=512, seed=3):
    rng = np.random.default_rng(seed)
    mid, params, aux0 = tmodels.pack_params(material)
    F = _stirred_F(n, seed=seed)
    params = np.broadcast_to(np.asarray(params, np.float32), (len(F), 8)).copy()
    aux = np.full(len(F), aux0, np.float32)
    vol = rng.uniform(0.5e-6, 1.5e-6, len(F)).astype(np.float32)
    return mid, F, aux, params, vol


@pytest.mark.parametrize("material", MATERIALS)
def test_potential_energy_matches_jax(material):
    mid, F, aux, params, vol = _energy_inputs(material)
    want = np.asarray(jmodels.potential_energy(mid, *map(jnp.asarray, (F, aux, params, vol))))
    got = tmodels.potential_energy(mid, *map(torch.as_tensor, (F, aux, params, vol)))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert max_err(got, want) <= ENERGY_RTOL * max(np.abs(want).max(), 1e-30)
    if material in ("jelly", "linear", "elastic"):
        assert np.abs(want).max() > 0


def _energy_terms(a, g):
    m = np.where(a["active"], a["mass"], 0.0).astype(np.float64)
    return (np.abs(0.5 * m * (a["v"].astype(np.float64) ** 2).sum(-1)).sum()
            + np.abs(m * (a["x"] @ np.asarray(g, np.float64))).sum())


def test_mechanical_energy_matches_jax():
    a, mids = scene_arrays(1500, seed=8, mats=MATERIALS)
    n = 1500
    a["F"][:n] = _stirred_F(n - 6, seed=9)
    jcfg, tcfg = configs(mids)
    want = float(jsolver.mechanical_energy(jax_particles(a), jcfg))
    got = tsolver.mechanical_energy(convert.particles_from_numpy(a), tcfg)
    assert got.shape == () and got.dtype == torch.float32
    pot = float(np.abs(np.asarray(jmodels.dispatch_potential_energy(
        jcfg.active_materials, *(jnp.asarray(a[k]) for k in ("mat", "F", "aux", "params",
                                                             "vol"))))).sum())
    scale = _energy_terms(a, tcfg.gravity) + pot
    assert pot > 0 and abs(float(got) - want) <= ENERGY_RTOL * scale


def _jelly_scene(cls, **kw):
    rng = np.random.default_rng(21)
    sim = cls(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=8e-4, gravity=(0.0, 0.0, 0.0), **kw)
    pos = rng.uniform(0.35, 0.6, (400, 3)).astype(np.float32)
    sim.add_particles("jelly", pos=pos, vel=(0.2, 0.0, -0.1), E=1e4, nu=0.3, density=1000)
    return sim


def test_mpm_energy_and_simulate_with_energy():
    """The scene's energy before a frame as JAX's; then simulate_with_energy
    over two frames reads the energy after each, as JAX's
    mechanical_energy reads the same particles."""
    jsim, tsim = _jelly_scene(jsolver.MPM), _jelly_scene(TMPM, device="cpu")
    e0 = tsim.energy()
    assert abs(e0 - jsim.energy()) <= ENERGY_RTOL * abs(jsim.energy())
    energies = diagnostics.simulate_with_energy(tsim, 2)
    assert energies.shape == (2,) and np.all(np.isfinite(energies))
    jcfg = JConfig(**dataclasses.asdict(tsim.cfg))
    want = float(jsolver.mechanical_energy(
        jax_particles(convert.particles_to_numpy(tsim.particles)), jcfg))
    assert abs(energies[-1] - want) <= ENERGY_RTOL * abs(want)
    assert energies[-1] == tsim.general_action("calculate_energy")
    assert abs(energies[-1] - e0) <= 0.1 * e0  # zero gravity: bounded drift


def test_frame_profiler_matches_jax():
    profs = (jdiag.FrameProfiler(substeps_per_frame=10),
             diagnostics.FrameProfiler(substeps_per_frame=10))
    for prof in profs:
        for n in (60, 60, 80):
            with prof.frame(n):
                pass
    assert profs[1].update_counter == profs[0].update_counter == 2000
    assert profs[1].particle_steps_per_sec() > 0
    assert profs[1].report().splitlines()[1] == profs[0].report().splitlines()[1]
    assert "throughput" in profs[1].report()
    assert diagnostics.FrameProfiler().report() == "no frames recorded"


def test_general_action(tmp_path):
    sim = _jelly_scene(TMPM, device="cpu")
    sim.step()
    path = str(tmp_path / "s.npz")
    sim.general_action("save", path=path)
    e = sim.general_action("calculate_energy")
    sim2 = _jelly_scene(TMPM, device="cpu")
    sim2.general_action("load", file_name=path)
    assert sim2.general_action("calculate_energy") == e and sim2.t == sim.t
    with pytest.raises(ValueError, match="unknown general_action"):
        sim.general_action("explode")
    with pytest.raises(ValueError, match="add rigid bodies first"):
        sim.general_action("add_articulation", type="rotation", obj0=1)


def test_trace_and_memory_report(tmp_path):
    sim = _jelly_scene(TMPM, device="cpu")
    with diagnostics.trace(str(tmp_path / "trace")) as prof:
        sim.energy()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
    report = diagnostics.device_memory_report()
    if torch.cuda.is_available():
        assert report["peak_bytes_in_use"] >= report["bytes_in_use"] >= 0
    else:
        assert report is None
