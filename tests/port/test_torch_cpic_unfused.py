"""Port vs JAX: the pytree CPIC frame, the CPIC route of the blocked path
with ``TMT_FUSED=0`` (``rigid/cpic_blocked.cpic_frame_carry``).

On the plate scene of tests/test_cpic_packed.py (jelly over a scripted
plate, res 16), moving fast enough to re-sort inside the frame: the
port's ``cpic_blocked_frame`` and its ``MPM(optimized=True)`` built under
TMT_FUSED=0 against the JAX package's ``cpic_blocked_frame`` (Pallas
kernels in interpret mode), from the same numpy state, at the bounds of
tests/test_cpic_packed.py (x 5e-6, v 5e-4, F 5e-5, states and near_b
exactly, body vel and omega 1e-5, pos 1e-6), the frame's counts (n_act,
n_near, n_coarse, n_r, sorts, plastic events) equal. The near sets of
``compact_near_rigid_ranges`` (record CDF over the page map) and
``compact_near_rigid`` (dense CDF) equal JAX's exactly; so do the pytree
sort and page map (``sort_particles``, ``build_page_map_full``) and the
P2G operand of ``prep_p2g`` within rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taichi_mpm_tpu.ops import blocked as jblocked
from taichi_mpm_tpu.ops import substep as jsubstep
from taichi_mpm_tpu.rigid import cdf as jcdf
from taichi_mpm_tpu.rigid import cpic_blocked as jcb
from taichi_mpm_tpu.rigid.body import boundary_particle_world as jboundary_particle_world
from taichi_mpm_tpu.rigid.mesh import plate_mesh
from taichi_mpm_torch import MPM
from taichi_mpm_torch.ops import blocked as tblocked
from taichi_mpm_torch.ops import substep as tsubstep
from taichi_mpm_torch.rigid import cdf as tcdf
from taichi_mpm_torch.rigid import cpic_blocked as tcb
from taichi_mpm_torch.rigid.body import boundary_particle_world
from taichi_mpm_torch.rigid.cpic_packed import Capacities

from port_helpers import assert_cpic_close, jax_plate_scene, max_err, np_of, port_inputs

torch.set_num_threads(1)

N_SUB, K, NEAR, B1, KR = 8, 128, 256, 1024, 64
VDRIFT = 0.1 / (2e-4 * 16.0)  # ~0.1 cell per substep: a re-sort inside the frame
SEED = 7


@pytest.fixture(scope="module")
def frames():
    sim = jax_plate_scene(vel=(VDRIFT, -0.5, 0.0), seed=SEED)
    cfg = sim.cfg
    jout = jax.jit(lambda p, b: jcb.cpic_blocked_frame(
        p, b, jnp.float32(0.0), cfg, sim.rigid_scene, cfg.base_dt, N_SUB, K, NEAR, B1, KR,
        interpret=True))(sim.particles, sim.bodies)
    tp, tb, ts, tcfg = port_inputs(sim)
    tout = tcb.cpic_blocked_frame(tp, tb, np.float32(0.0), tcfg, ts, tcfg.base_dt, N_SUB, K,
                                  Capacities(KR))
    return sim, jout, tout


def test_pytree_frame_matches_jax(frames):
    _, jout, tout = frames
    assert_cpic_close(jout[0], jout[1], tout[0], tout[1])
    # max n_act, n_near, n_coarse, n_r, sorts (the first and one inside), plasticity
    assert [int(v) for v in jout[3:]] == [int(v) for v in tout[3:]]
    assert int(tout[7]) == 2 and int(tout[4]) > 0


def test_unfused_mpm_matches_jax(frames, monkeypatch):
    """The port's scene API with TMT_FUSED=0 takes the pytree frame (its
    own capacities, the carry a Particles set)."""
    _, jout, _ = frames
    monkeypatch.setenv("TMT_FUSED", "0")
    rng = np.random.default_rng(SEED)
    pos = rng.uniform(0.3, 0.7, size=(220, 3)).astype(np.float32)
    tsim = MPM(res=(16, 16, 16), base_delta_t=2e-4, gravity=(0, -10.0, 0), penalty=1e3,
               optimized=True, device="cpu")
    tsim.add_particles("jelly", pos=pos, vel=(VDRIFT, -0.5, 0.0), E=1e4, nu=0.3, density=1000)
    tsim.add_particles("rigid", mesh=plate_mesh(half_u=0.25, half_v=0.25, axis=1),
                       scripted_position=lambda t: (0.5, 0.45, 0.5),
                       scripted_rotation=lambda t: (0.0, 0.0, 0.0), codimensional=True,
                       friction=0.2)
    tsim.frame_dt = N_SUB * tsim.cfg.base_dt
    tsim.step()
    assert not tsim.fused and isinstance(tsim.packed_carry[0], type(tsim.particles))
    assert tsim.cpic_stats == dict(n_act=int(jout[3]), n_near=int(jout[4]),
                                   n_coarse=int(jout[5]), n_r=int(jout[6]))
    assert tsim.n_sorts == 2
    assert_cpic_close(jout[0], jout[1], tsim.particles, tsim.bodies)


@pytest.fixture(scope="module")
def near_sets(frames):
    """JAX's near sets at the scene's first substep, one compile: the
    sort, the page map, the rigid page map's CDF and the dense one."""
    sim = frames[0]
    cfg, scene = sim.cfg, sim.rigid_scene

    @jax.jit
    def run(p, bodies):
        p, keys, _ = jblocked.sort_particles(p, cfg)
        pm = jsubstep.build_page_map_full(keys, cfg, K)
        _, ncdf, n_r, _ = jcb.rigid_prologue(bodies, scene, cfg, cfg, cfg.base_dt, KR)
        ranges = jcb.compact_near_rigid_ranges(p, keys, pm, ncdf, cfg, NEAR, B1)
        xb, _, elem = jboundary_particle_world(bodies, scene.bp_rid, scene.bp_offset,
                                                scene.bp_normal, scene.bp_elem)
        _, _, grid_states = jcdf.rasterize_rigid_boundary(xb, elem, scene.bp_rid, bodies.num,
                                                          cfg)
        dense = jcb.compact_near_rigid(p, grid_states, cfg, NEAR, B1)
        pdata = jsubstep.prep_p2g(p, keys, cfg, cfg.base_dt, origin=pm["origin"])
        return keys, pm, ranges, dense, n_r, pdata

    return jax.tree_util.tree_map(lambda x: np.array(x), run(sim.particles, sim.bodies))


def test_pytree_sort_page_map_and_prep_match_jax(frames, near_sets):
    keys_j, pm_j, _, _, _, pdata_j = near_sets
    tp, _, _, tcfg = port_inputs(frames[0])
    p, keys, order = tblocked.sort_particles(tp, tcfg)
    assert np.array_equal(np_of(tp.x[order]), np_of(p.x))
    assert np.array_equal(np_of(keys), keys_j)
    pm = tsubstep.build_page_map_full(keys, tcfg, K)
    for name in ("ids", "n_act", "s_arr", "e_arr", "nbr", "slot_keys", "slot_map", "origin"):
        assert np.array_equal(np_of(pm[name]), pm_j[name]), name
    pdata = tsubstep.prep_p2g(p, keys, tcfg, tcfg.base_dt, origin=pm["origin"])
    n = p.capacity
    assert np.array_equal(np_of(pdata[:4]), pdata_j[:4, :n])  # m v and m
    assert np.array_equal(np_of(pdata[13:]), pdata_j[13:16, :n])  # block-local positions
    assert max_err(pdata[4:13], pdata_j[4:13, :n]) <= 1e-6 * np.abs(pdata_j[4:13]).max()


def test_near_sets_match_jax(frames, near_sets):
    _, _, (idx_j, _, n_near_j, n_coarse_j), (didx_j, _, dn_near_j, dn_coarse_j), n_r_j, _ = \
        near_sets
    tp, tb, ts, tcfg = port_inputs(frames[0])
    p, keys, _ = tblocked.sort_particles(tp, tcfg)
    pm = tsubstep.build_page_map_full(keys, tcfg, K)
    caps = Capacities(KR)
    _, ncdf, n_r, _ = tcb.rigid_prologue(tb, ts, tcfg, tcfg.base_dt, caps)
    assert n_r == int(n_r_j)
    idx, n_near, n_coarse = tcb.compact_near_rigid_ranges(p, pm, ncdf, tcfg)
    assert (n_near, n_coarse) == (int(n_near_j), int(n_coarse_j)) and n_near > 0
    assert np.array_equal(np_of(idx), idx_j[:n_near])
    xb, _, elem = boundary_particle_world(tb, ts.bp_rid, ts.bp_offset, ts.bp_normal,
                                          ts.bp_elem)
    _, _, grid_states = tcdf.rasterize_rigid_boundary(xb, elem, ts.bp_rid, tb.num, tcfg)
    didx, dn_near, dn_coarse = tcb.compact_near_rigid(p, grid_states, tcfg)
    assert (dn_near, dn_coarse) == (int(dn_near_j), int(dn_coarse_j))
    assert np.array_equal(np_of(didx), didx_j[:dn_near])
    assert dn_near == n_near  # both stage-2 tests are exact
