"""Port vs JAX: frames of the dense path, fixed and adaptive dt.

``core.solver.frame_fn`` (6 substeps) against the JAX package's dense
substeps on the same numpy particles, in 2-D and 3-D at B-spline orders
1-3, several materials at once, a sticky plane and a frictional sphere
cutting through the particles, and the per-particle collision and the
boundary clean-up on: x 5e-6, v 5e-5, F 5e-6, C 5e-4, aux 5e-6, the same
particles alive. Then ``AsyncMPM`` on the dense path against the JAX
package's ``adaptive_frame_fn``, with equal substep counts, and the
``MPM`` scene on the dense path against its JAX twin frame by frame.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taichi_mpm_tpu.core import adaptive as jadaptive
from taichi_mpm_tpu.core import levelset as jls
from taichi_mpm_torch import convert, scenes
from taichi_mpm_torch.core import adaptive as tadaptive
from taichi_mpm_torch.core import levelset as tls
from taichi_mpm_torch.core import solver as tsolver

from port_helpers import (FRAME_BOUNDS, assert_frame_close, dense_arrays, dense_configs,
                          jax_particles, jax_substeps)

torch.set_num_threads(1)

# the materials of each frame: all eight once, then sets whose JAX frames
# are quick to run (each material's return map is held on its own edge
# inputs by test_torch_dense_materials.py)
MATS = {(2, 1): ("jelly", "snow", "water"),
        (2, 2): ("elastic", "jelly", "snow", "water", "sand", "von_mises", "linear", "visco"),
        (2, 3): ("sand", "linear", "water"),
        (3, 1): ("jelly", "water"), (3, 2): ("snow", "sand"), (3, 3): ("linear", "water")}


def colliders(ls, dim):
    up = (0.0, 1.0, 0.0)[:dim]
    return (ls.plane((0.0, 0.36, 0.0)[:dim], up, friction=-1.0),
            ls.sphere((0.5,) * dim, 0.08, friction=0.4))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_frame_matches_jax(dim, order):
    mats = MATS[dim, order]
    a, mids = dense_arrays(300, dim=dim, seed=3 * order + dim, mats=mats)
    jcfg, tcfg = dense_configs(mids, dim=dim, res=24, kernel_order=order,
                               particle_collision=True, clean_boundary=True)
    jp, jt = jax_substeps(jax_particles(a), jcfg, colliders(jls, dim), 6)
    tp, tt, count = tsolver.frame_fn(convert.particles_from_numpy(a), np.float32(0.0), tcfg,
                                     colliders(tls, dim), tcfg.base_dt, 6)
    assert np.float32(jt) == tt
    assert 0 < int(tp.active.sum())
    assert_frame_close(jp, tp)
    if "water" in mats:
        assert int(count) > 0


def _block():
    # tests/test_adaptive.py's 2-D block of 64 particles
    return np.stack(np.meshgrid(np.linspace(0.4, 0.6, 8), np.linspace(0.6, 0.8, 8)),
                    -1).reshape(-1, 2).astype(np.float32)


@pytest.mark.parametrize("material,kw", [
    ("jelly", dict(E=5e4, nu=0.3)),
    ("elastic", dict(E=1e5, nu=0.3)),  # the sound-speed limit binds
])
def test_async_dense_frame_matches_adaptive_frame_fn(material, kw):
    """tests/test_adaptive.py's 2-D scene (AsyncMPM(res 64^2,
    base_delta_t 1e-3, frame_dt 5e-3, unit 1e-6), a falling block)
    through the port's AsyncMPM against adaptive_frame_fn, two frames."""
    def make(cls, **dev):
        sim = cls(res=(64, 64), base_delta_t=1e-3, frame_dt=5e-3, unit_delta_t=1e-6, **dev)
        sim.add_particles(material, pos=_block(), vel=(0.0, -2.0), **kw)
        return sim

    jsim = make(jadaptive.AsyncMPM)
    jsim._finalize()
    jp, jt, jcfg = jsim.particles, jnp.float32(0.0), jsim.cfg
    tsim = make(tadaptive.AsyncMPM, device="cpu")
    frame = jax.jit(lambda p, t: jadaptive.adaptive_frame_fn(p, t, jcfg, (), 5e-3, 1e-6, 1e-3))
    substeps = 0
    for _ in range(2):
        jp, jt, jn = frame(jp, jt)
        tp = tsim.step()
        assert tsim.last_substeps == int(jn) > 1
        assert np.float32(jt) == tsim.t
        assert_frame_close(jp, tp)
        substeps += int(jn)
    lo, hi = tsim.last_dt_range
    assert np.float32(1e-6) <= lo <= hi <= np.float32(1e-3)
    assert tsim.update_counter == substeps * 64


def test_async_dense_3d_jello():
    """scripts/benchmark/oscillating_jello.py at res 16 through the port's
    AsyncMPM(optimized=False) against adaptive_frame_fn: the same substeps
    and the frame bounds."""
    tsim = scenes.oscillating_jello(res=16, device="cpu", solver=tadaptive.AsyncMPM,
                                    unit_delta_t=1e-6)
    tsim.frame_dt = 2e-3
    tsim._ensure_finalized()
    a = convert.particles_to_numpy(tsim.particles)
    jcfg, _ = dense_configs(tsim.cfg.active_materials, dim=3, res=16)
    jcfg = jcfg.__class__(**dict(jcfg.__dict__, base_dt=5e-4, gravity=(0.0, 0.0, 0.0)))
    jp, jt, jn = jax.jit(lambda p: jadaptive.adaptive_frame_fn(
        p, jnp.float32(0.0), jcfg, (), 2e-3, 1e-6, 5e-4))(jax_particles(a))
    tp = tsim.step()
    assert tsim.last_substeps == int(jn) >= 4
    assert_frame_close(jp, tp)


def test_mpm_dense_scene_matches_jax_frames():
    """The tetris scene (2-D, jelly, snow and water, three frictional
    walls) through the port's MPM against the JAX package's dense
    substeps, two frames of 10 substeps: within the frame bounds after
    each."""
    tsim = scenes.tetris(res=64, device="cpu")
    tsim.frame_dt = 10 * tsim.cfg.base_dt
    tsim._ensure_finalized()
    a = convert.particles_to_numpy(tsim.particles)
    jcfg, _ = dense_configs(tsim.cfg.active_materials, dim=2, res=64)
    jcfg = jcfg.__class__(**dict(jcfg.__dict__, gravity=(0.0, -20.0)))
    jcol = (jls.Collider(sdf=lambda x, t: x[..., 1] - 0.05, friction=0.3),
            jls.Collider(sdf=lambda x, t: x[..., 0] - 0.05, friction=0.3),
            jls.Collider(sdf=lambda x, t: 0.95 - x[..., 0], friction=0.3))
    jp, jt = jax_particles(a), 0.0
    for _ in range(2):
        jp, jt = jax_substeps(jp, jcfg, jcol, 10, t=jt)
        tsim.step()
        assert np.float32(jt) == tsim.t
        assert_frame_close(jp, tsim.particles, FRAME_BOUNDS)
    assert tsim.n_sorts == 0 and tsim.packed_carry is None
