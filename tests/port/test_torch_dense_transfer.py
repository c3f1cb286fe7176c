"""Port vs JAX: the dense transfers of ``core/transfer.py`` one by one.

The same numpy particles and grids go through the JAX package's
``core.transfer`` (op by op on the CPU) and the port's, in 2-D and 3-D
and at B-spline orders 1-3: ``p2g`` (node values to 1e-6 of the grid's
largest), ``grid_update`` with a plane, a sphere, a box and a
``DirichletRegion`` (node velocities to 1e-6 of the largest),
``g2p`` (x 5e-6, v 5e-5, F 5e-6, C 5e-4, aux 5e-6 and the plasticity
count exactly), ``particle_collision_resolution`` and
``core.solver.clear_boundary_particles`` (x and v to 1e-6, the active
mask exactly). Inactive slots hold a NaN F and a heavy mass, which must
not reach the grid.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.core import levelset as jls
from taichi_mpm_tpu.core import solver as jsolver
from taichi_mpm_tpu.core import transfer as jtransfer
from taichi_mpm_torch import convert
from taichi_mpm_torch.core import levelset as tls
from taichi_mpm_torch.core import solver as tsolver
from taichi_mpm_torch.core import transfer as ttransfer

from port_helpers import FRAME_BOUNDS, dense_arrays, dense_configs, jax_particles, max_err

torch.set_num_threads(1)

MATS = ("jelly", "water")


def scene(dim, order=2, res=16, **cfg_kw):
    a, mids = dense_arrays(300, dim=dim, seed=dim * 10 + order, mats=MATS)
    a["F"][300:] = np.nan  # inactive slots: garbage that must not reach the grid
    a["mass"][300:] = 99.0
    a["x"][300:] = 0.5
    a["C"][:300] = 0.3 * np.random.default_rng(order).standard_normal(a["C"][:300].shape)
    jcfg, tcfg = dense_configs(mids, dim=dim, res=res, kernel_order=order, **cfg_kw)
    return a, jcfg, tcfg


def colliders(kind, dim):
    """(JAX, port) collider of one kind, cutting through the particles."""
    up = (0.0, 1.0, 0.0)[:dim]
    make = {
        "plane": lambda ls: ls.plane((0.0, 0.45, 0.0)[:dim], up, friction=0.3),
        "sphere": lambda ls: ls.sphere((0.45,) * dim, 0.1, friction=-1.0),
        "box": lambda ls: ls.box_domain((0.35,) * dim, (0.9,) * dim, friction=-2.5),
        "dirichlet": lambda ls: ls.dirichlet_slab(0, 0.3, 0.4, velocity=(0.5, -0.25, 0.0)[:dim]),
    }[kind]
    return (make(jls),), (make(tls),)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_p2g(dim, order):
    a, jcfg, tcfg = scene(dim, order)
    want = np.asarray(jtransfer.p2g(jax_particles(a), jcfg, jcfg.base_dt))
    got = ttransfer.p2g(convert.particles_from_numpy(a), tcfg, tcfg.base_dt)
    assert got.shape == tuple(n + 2 for n in tcfg.res) + (dim + 1,)
    assert np.isfinite(got.numpy()).all()
    assert max_err(want, got) <= 1e-6 * np.abs(want).max()
    assert abs(float(got[..., dim].sum()) - 300e-3) <= 1e-6  # the mass of the active ones


@pytest.mark.parametrize("kind", ["plane", "sphere", "box", "dirichlet"])
@pytest.mark.parametrize("dim", [2, 3])
def test_grid_update(dim, kind):
    a, jcfg, tcfg = scene(dim)
    jcol, tcol = colliders(kind, dim)
    grid = np.asarray(jtransfer.p2g(jax_particles(a), jcfg, jcfg.base_dt))
    jv, jm = jtransfer.grid_update(jnp.asarray(grid), jcfg, jcol, jnp.float32(0.0), jcfg.base_dt)
    tg = torch.tensor(grid)
    tv, tm = ttransfer.grid_update(tg, tcfg, tcol, np.float32(0.0), tcfg.base_dt)
    assert max_err(jm, tm) == 0.0
    assert max_err(jv, tv) <= 1e-6 * np.abs(np.asarray(jv)).max()
    # the node positions built once give the same velocities
    xg = ttransfer.node_positions(tcfg, "cpu")
    tv2, _ = ttransfer.grid_update(tg, tcfg, tcol, np.float32(0.0), tcfg.base_dt, xg)
    assert torch.equal(tv, tv2)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_g2p(dim, order):
    a, jcfg, tcfg = scene(dim, order)
    jp = jax_particles(a)
    jv, _ = jtransfer.grid_update(jtransfer.p2g(jp, jcfg, jcfg.base_dt), jcfg, (),
                                  jnp.float32(0.0), jcfg.base_dt)
    jq, jcnt = jtransfer.g2p_finish(jp, *_jax_gather(jp, jv, jcfg), jcfg, jcfg.base_dt,
                                    return_count=True)
    tq, tcnt = ttransfer.g2p(convert.particles_from_numpy(a), torch.tensor(np.asarray(jv)),
                             tcfg, tcfg.base_dt, return_count=True)
    ja = np.asarray(jq.active)
    assert np.array_equal(ja, tq.active.numpy()) and ja.sum() == 300
    for name, bound in FRAME_BOUNDS.items():
        assert max_err(np.asarray(getattr(jq, name))[ja], getattr(tq, name).numpy()[ja]) <= bound
    assert int(jcnt) == int(tcnt) > 0  # water lanes with J > 1
    assert np.isnan(tq.F.numpy()[300:]).all()  # inactive slots kept as they were


def _jax_gather(p, grid_v, cfg):
    """(v_new, b_new) of the JAX package's g2p gather (its loop, before
    ``g2p_finish``)."""
    d = cfg.dim
    pos, base, w = jtransfer._weights(cfg, p.x)
    flat_v = grid_v.reshape(-1, d)
    v_new, b_new = jnp.zeros_like(p.v), jnp.zeros_like(p.C)
    for off in jtransfer.stencil_offsets(d, cfg.kernel_order):
        idx = base + jnp.asarray(off, jnp.int32)
        dpos = pos - idx.astype(pos.dtype)
        wo = jtransfer._offset_weight(w, off)
        inb = jnp.all((idx >= 0) & (idx < jnp.asarray(cfg.grid_nodes)), -1)
        gv = jnp.where(inb[:, None], flat_v[jnp.where(inb, jtransfer._ravel(idx, cfg.grid_nodes), 0)],
                       0.0)
        v_new = v_new + wo[:, None] * gv
        b_new = b_new + (wo[:, None] * gv)[..., :, None] * dpos[..., None, :]
    return v_new, b_new


@pytest.mark.parametrize("kind", ["plane", "sphere", "box"])
@pytest.mark.parametrize("dim", [2, 3])
def test_particle_collision_resolution(dim, kind):
    a, jcfg, tcfg = scene(dim)
    jcol, tcol = colliders(kind, dim)
    jq = jtransfer.particle_collision_resolution(jax_particles(a), jcfg, jcol, jnp.float32(0.0))
    tq = ttransfer.particle_collision_resolution(convert.particles_from_numpy(a), tcfg, tcol,
                                                 np.float32(0.0))
    act = a["active"]
    moved = np.abs(tq.x.numpy() - a["x"]).max(-1) > 0
    assert moved[act].any()
    for name in ("x", "v"):
        assert max_err(np.asarray(getattr(jq, name))[act], getattr(tq, name).numpy()[act]) <= 1e-6


@pytest.mark.parametrize("dim", [2, 3])
def test_clear_boundary_particles(dim):
    a, jcfg, tcfg = scene(dim, res=32)
    a["x"][:300] = np.random.default_rng(dim).uniform(0.0, 1.0, (300, dim))
    jq = jsolver.clear_boundary_particles(jax_particles(a), jcfg)
    tq = tsolver.clear_boundary_particles(convert.particles_from_numpy(a), tcfg)
    assert np.array_equal(np.asarray(jq.active), tq.active.numpy())
    assert 0 < int(tq.active.sum()) < 300


@pytest.mark.parametrize("dim", [2, 3])
def test_substep_moves_inactive_nothing(dim):
    """One dense substep with particle gravity and both clean-ups on: the
    port's against the JAX package's, the inactive slots untouched."""
    a, jcfg, tcfg = scene(dim, particle_gravity=True, particle_collision=True, clean_boundary=True)
    jcol, tcol = colliders("plane", dim)
    jq, jt = jsolver.substep(jax_particles(a), jnp.float32(0.0), jcfg, jcol, jcfg.base_dt)
    tq, tt, _ = tsolver.substep(convert.particles_from_numpy(a), np.float32(0.0), tcfg, tcol,
                                tcfg.base_dt)
    assert np.float32(jt) == tt
    ja = np.asarray(jq.active)
    assert np.array_equal(ja, tq.active.numpy())
    for name, bound in FRAME_BOUNDS.items():
        assert max_err(np.asarray(getattr(jq, name))[ja], getattr(tq, name).numpy()[ja]) <= bound
    assert np.isnan(tq.F.numpy()[300:]).all() and (tq.mass.numpy()[300:] == 99.0).all()
