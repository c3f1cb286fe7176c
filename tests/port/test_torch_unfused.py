"""Port vs JAX: the unfused route (the JAX package's ``TMT_FUSED=0``).

The port's ``packed_frame(fused=False)`` (prep_packed, the P2G kernel on
the operand, the gather-only G2P kernel and the finish; on the CPU the
kernels' plain twins) against the JAX package's
``packed_frame(fused=False)`` with its Pallas kernels in interpret mode,
on the same numpy particles, 6 substeps with a re-sort inside the frame,
for jelly and for water. Held to the bounds the reference sets between
its own routes (``tests/test_fused.py``): x 5e-6, v 5e-5, F 5e-6,
C 5e-4, aux 5e-6; the sort and plasticity counts equal. Then the port's
two routes against each other under the same bounds, the route that
``MPM`` takes under ``TMT_FUSED``, and ``stage_report``."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import MPM as TMPM
from taichi_mpm_torch import convert, diagnostics, scenes
from taichi_mpm_torch.ops import p2g as tp2g
from taichi_mpm_torch.ops import packed as tpacked

from port_helpers import assert_frame_close, configs, fast_arrays, jax_particles

torch.set_num_threads(1)

N_SUB, K, DT = 6, 192, 3e-4  # 12 m/s at dt 3e-4, res 32: a re-sort after 4 substeps


def _port_frame(a, tcfg, fused):
    return tpacked.packed_frame(convert.particles_from_numpy(a), np.float32(0.0), tcfg, (),
                                tcfg.base_dt, N_SUB, K, fused=fused)


@pytest.mark.parametrize("mats", [("jelly",), ("water",)])
def test_unfused_frame_matches_jax(mats):
    a, mids = fast_arrays(mats=mats)
    jcfg, tcfg = configs(mids, base_dt=DT)
    jp, _, jnmax, jns, jpl = jpacked.packed_frame(
        jax_particles(a), jnp.float32(0.0), jcfg, (), jcfg.base_dt, N_SUB, K,
        interpret=True, fused=False)
    tp, _, tnmax, tns, tpl = _port_frame(a, tcfg, fused=False)
    assert (int(jnmax), int(jns), int(jpl)) == (tnmax, tns, int(tpl))
    assert tns == 2  # the initial sort and one inside the frame
    if "water" in mats:
        assert int(tpl) > 0
    assert_frame_close(jp, tp)


@pytest.mark.parametrize("mats", [("jelly",), ("jelly", "water")])
def test_unfused_matches_fused(mats):
    a, mids = fast_arrays(mats=mats, seed=8)
    _, tcfg = configs(mids, base_dt=DT)
    fp, _, fnmax, fns, fpl = _port_frame(a, tcfg, fused=True)
    up, _, unmax, uns, upl = _port_frame(a, tcfg, fused=False)
    assert (fnmax, fns, int(fpl)) == (unmax, uns, int(upl))
    assert_frame_close(fp, up)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("p2g_fused", "p2g_blocked"):
            fn = getattr(tp2g, name)
            monkeypatch.setattr(tp2g, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def spy(*args, **kw):
            self.calls.append(name)
            return fn(*args, **kw)
        return spy


@pytest.mark.parametrize("env,route", [(None, "p2g_fused"), ("0", "p2g_blocked"),
                                       ("1", "p2g_fused")])
def test_mpm_route_follows_tmt_fused(monkeypatch, env, route):
    if env is None:
        monkeypatch.delenv("TMT_FUSED", raising=False)
    else:
        monkeypatch.setenv("TMT_FUSED", env)
    sim = scenes.benchmark_cube(cells=4, res=32, device="cpu", E=2e4, nu=0.35)
    sim.frame_dt = 2 * sim.cfg.base_dt
    spy = _Spy(monkeypatch)
    sim.step()
    assert sim.fused == (route == "p2g_fused")
    assert spy.calls == [route, route]
    assert np.isfinite(sim.positions()).all()


def test_unfused_cpic_raises(monkeypatch):
    """The unfused CPIC route no longer raises: it runs the pytree CPIC
    frame (test_torch_cpic_unfused.py holds it to JAX), launching
    p2g_blocked's and g2p_blocked's twins and no fused one."""
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    monkeypatch.setenv("TMT_FUSED", "0")
    sim = TMPM(res=(16, 16, 16), device="cpu")
    pos = np.random.default_rng(3).uniform(0.3, 0.7, (40, 3)).astype(np.float32)
    sim.add_particles("jelly", pos=pos, E=1e4, nu=0.3)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.25, half_v=0.25, axis=1),
                      scripted_position=lambda t: (0.5, 0.45, 0.5),
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0), codimensional=True)
    calls = []
    monkeypatch.setattr(tp2g, "p2g_fused", lambda *a: calls.append("p2g_fused"))
    sim.frame_dt = 2 * sim.cfg.base_dt
    sim.step()
    assert not calls and not sim.fused and sim.particles.count() == 40
    assert isinstance(sim.packed_carry[0], type(sim.particles)) and sim.n_sorts >= 1


def test_stage_report_times_every_stage():
    sim = scenes.benchmark_cube(cells=4, res=32, device="cpu", E=2e4, nu=0.35)
    report = diagnostics.stage_report(sim, substeps=2, repeats=1)
    assert set(report) == set(diagnostics.STAGES) | {"total_stages", "p2g_fused", "g2p_fused"}
    assert all(math.isfinite(v) and v >= 0.0 for v in report.values())
    assert report["total_stages"] == pytest.approx(sum(report[s] for s in diagnostics.STAGES))
