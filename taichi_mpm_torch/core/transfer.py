"""The dense P2G / G2P transfers over the whole grid (torch counterpart of
``taichi_mpm_tpu.core.transfer``, the JAX package's portable path and
the oracle of its blocked kernels).

Grid-unit conventions, as the reference's:
  pos   = x / dx                       (grid units)
  dpos  = pos - node                   (grid units)
  B     = sum_i w_i v_i dpos_i         (APIC B)
  P2G value_i = w_i * (m v + [invD m B - invD inv_dx dt force] dpos_i, m)
  G2P   cdg   = I - invD dt inv_dx B   (the MLS-MPM F update)
with invD = 6 - order, force = -vol P F^T (``materials.models``).

Any B-spline order (1, 2, 3) and dimension (2, 3). The scatter and the
gathers are torch ops, as the reference's are XLA ops: no Pallas kernel
stands behind them. The grid holds res + 2 nodes per axis; the dense
slab frame (``parallel.spatial``) runs the same transfers on a node
window of it, `window` = (x_start, nodes): the global node column of the
window's column 0 and the window's node counts.

Scalars follow the JAX package's arithmetic: a dt given as a Python
float folds with the other constants in double precision and is rounded
once, as a constant in a jitted frame is; a float32 dt (the adaptive
frame's) takes part in float32 products, in the reference's order.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.levelset import DirichletRegion, friction_project
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.materials import models as materials
from taichi_mpm_torch.math.kernels import bspline_weights, inv_D
from taichi_mpm_torch.utils import const, index_add_ordered, mv, outer


def stencil_offsets(dim: int, order: int):
    """Node offsets of the B-spline stencil, in the JAX package's order
    (itertools.product: the last axis varies fastest)."""
    return tuple(itertools.product(range(order + 1), repeat=dim))


def _weights(cfg: SimConfig, x):
    pos = x * cfg.inv_dx
    base, w, _ = bspline_weights(cfg.kernel_order, pos)
    return pos, base, w


def _ravel(idx, nodes):
    lin = idx[..., 0]
    for k in range(1, len(nodes)):
        lin = lin * nodes[k] + idx[..., k]
    return lin


def _stencil(cfg: SimConfig, pos, base, w, window=None):
    """Every stencil offset of every particle at once, offsets first (K
    offsets in the JAX package's order, N particles): (offset from the
    node dpos (K, N, d), tensor-product weight (K, N), in-grid mask
    (K, N), linear node index (K, N) int64, 0 where out of the grid). The
    same elementwise arithmetic as the JAX package's loop over offsets,
    which these ops run in fewer, larger launches. On a node `window`
    the indices are the window's and the mask holds the window and the
    grid's x extent (the JAX package's ``spatial.p2g_local``)."""
    d = cfg.dim
    nodes = cfg.grid_nodes if window is None else window[1]
    offs = const(stencil_offsets(d, cfg.kernel_order), torch.int32, pos.device)  # (K, d)
    if window is not None:
        base = base - const((window[0],) + (0,) * (d - 1), torch.int32, pos.device)
    idx = base[None] + offs[:, None, :]
    inb = torch.all((idx >= 0) & (idx < const(nodes, torch.int32, pos.device)), -1)
    if window is not None:
        gx = idx[..., 0] + window[0]
        inb = inb & (gx >= 0) & (gx < cfg.grid_nodes[0])
    lin = torch.where(inb, _ravel(idx, nodes), 0).to(torch.int64)
    dpos = pos[None] - idx.to(pos.dtype)
    if window is not None:
        dpos[..., 0] = dpos[..., 0] - float(window[0])
    # prod_k w[:, k, off_k], multiplied in axis order
    wo = w[:, 0, offs[:, 0].long()].T
    for k in range(1, d):
        wo = wo * w[:, k, offs[:, k].long()].T
    return dpos, wo, inb, lin


def _folded(*factors):
    """The product of Python constants and dt, left to right: in double
    precision (rounded once where it meets a float32 tensor) when every
    factor is a Python number, else each factor rounded to float32 and
    multiplied in float32."""
    if all(isinstance(f, (int, float)) for f in factors):
        return math.prod(factors)
    out = np.float32(factors[0])
    for f in factors[1:]:
        out = out * np.float32(f)
    return out


def p2g(p: Particles, cfg: SimConfig, dt, window=None) -> torch.Tensor:
    """Particle-to-grid scatter of (momentum, mass): a tensor of shape
    cfg.grid_nodes + (d + 1,), or the node `window`'s nodes + (d + 1,).

    The values of all stencil offsets go to the grid in one ordered
    scatter (``utils.index_add_ordered``), offset-major and particles in
    index order within each offset: every node sums its values in the
    order of the JAX package's scatter per offset, and the sum has the
    same bits on every run on the card."""
    d = cfg.dim
    nodes = cfg.grid_nodes if window is None else window[1]
    invD = inv_D(cfg.kernel_order)
    pos, base, w = _weights(cfg, p.x)

    vel = p.v
    if cfg.particle_gravity:
        vel = vel + const(cfg.gravity, torch.float32, p.device) * dt

    force = materials.dispatch_force(cfg.active_materials, p.mat, p.F, p.aux, p.params, p.vol)
    # affine momentum and the MLS force: (invD m B - invD inv_dx dt force)
    affine = (invD * p.mass[:, None, None] * p.C
              - _folded(invD * cfg.inv_dx, dt) * force)
    # inactive slots may hold any F (a NaN force): zeroed, as 0 * NaN is NaN
    affine = torch.where(p.active[:, None, None], affine, 0.0)
    mass = torch.where(p.active, p.mass, 0.0)
    mvel = mass[:, None] * vel

    dpos, wo, inb, lin = _stencil(cfg, pos, base, w, window)
    wo = wo * p.active
    mom = mvel + mv(affine, dpos)  # (K, N, d)
    val = torch.cat([mom, mass[:, None].expand(mom.shape[:-1] + (1,))], -1) * wo[..., None]
    val = torch.where(inb[..., None], val, 0.0)
    flat = torch.zeros((int(np.prod(nodes)), d + 1), dtype=torch.float32, device=p.device)
    index_add_ordered(flat, lin.reshape(-1), val.reshape(-1, d + 1))
    return flat.reshape(tuple(nodes) + (d + 1,))


def node_positions(cfg: SimConfig, device, window=None) -> torch.Tensor:
    """Physical positions of all grid nodes, shape nodes + (d,), or of a
    node `window`'s. A scene builds them once and passes them to every
    ``grid_update``."""
    nodes = cfg.grid_nodes if window is None else window[1]
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in nodes]
    if window is not None:
        axes[0] = axes[0] + float(window[0])
    axes = [a * cfg.dx for a in axes]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def grid_update(grid, cfg: SimConfig, colliders, t, dt, xg=None):
    """Momentum to velocity, gravity on the nodes with mass, and the
    boundary colliders on every node (``DirichletRegion`` pins; SDF
    colliders project the velocity of the nodes with mass inside their
    band by the dense ``levelset.friction_project``). `xg` are the node
    positions (``node_positions``), built here when not given. Returns
    (node velocities nodes + (d,), the mass channel)."""
    d = cfg.dim
    mass = grid[..., d]
    has_mass = mass > 0.0
    inv_mass = torch.where(has_mass, 1.0 / torch.clamp(mass, min=1e-30), 0.0)
    v = grid[..., :d] * inv_mass[..., None]
    if not cfg.particle_gravity:
        v = torch.where(has_mass[..., None],
                        v + const(cfg.gravity, torch.float32, grid.device) * dt, v)
    if colliders and xg is None:
        xg = node_positions(cfg, grid.device)
    for c in colliders:
        if isinstance(c, DirichletRegion):
            vel = c.velocity if c.velocity else (0.0,) * d
            v = torch.where(c.mask(xg, t)[..., None], const(vel, torch.float32, v.device), v)
            continue
        phi = c.sdf(xg, t)
        band = (phi > c.band_lo * cfg.dx) & (phi <= c.band_hi * cfg.dx) & has_mass
        bv = c.boundary_velocity(xg, t)
        if np.float32(c.friction) == -1.0:
            # sticky: friction_project returns the boundary velocity, whatever the normal
            v = torch.where(band[..., None], bv, v)
            continue
        n = c.normal(xg, t, eps=0.5 * cfg.dx)
        v_proj = friction_project(v, bv, n, const(c.friction, torch.float32, v.device))
        v = torch.where(band[..., None], v_proj, v)
    return v, mass


def particle_collision_resolution(p: Particles, cfg: SimConfig, colliders, t) -> Particles:
    """Per-particle level-set projection: active particles inside a
    collider move to its surface and lose their normal velocity."""
    x, v = p.x, p.v
    for c in colliders:
        if isinstance(c, DirichletRegion):
            continue
        phi = c.sdf(x, t)
        grad = c.normal(x, t, eps=0.5 * cfg.dx)
        hit = (p.active & (phi < 0.0))[:, None]
        x = torch.where(hit, x - grad * phi[:, None], x)
        vn = torch.sum(grad * v, -1, keepdim=True)
        v = torch.where(hit, v - vn * grad, v)
    return dataclasses.replace(p, x=x, v=v)


def g2p(p: Particles, grid_v, cfg: SimConfig, dt, return_count: bool = False, window=None):
    """Grid-to-particle gather of v and APIC B, then ``g2p_finish``."""
    v_new, b_new = gather(p, grid_v, cfg, window)
    return g2p_finish(p, v_new, b_new, cfg, dt, return_count=return_count)


def gather(p: Particles, grid_v, cfg: SimConfig, window=None):
    """(v (N, d), APIC B (N, d, d)) of each particle from the node
    velocities `grid_v` (of the grid, or of a node `window`), offset by
    offset in the stencil's order."""
    d = cfg.dim
    pos, base, w = _weights(cfg, p.x)
    dpos, wo, inb, lin = _stencil(cfg, pos, base, w, window)
    gv = grid_v.reshape(-1, d).index_select(0, lin.reshape(-1)).reshape(lin.shape + (d,))
    gv = torch.where(inb[..., None], gv, 0.0)  # (K, N, d)
    wgv = wo[..., None] * gv
    b_off = outer(wgv, dpos)
    # summed offset by offset, as the JAX package's loop sums them
    v_new = torch.zeros_like(p.v)
    b_new = torch.zeros_like(p.C)
    for k in range(wgv.shape[0]):
        v_new = v_new + wgv[k]
        b_new = b_new + b_off[k]
    return v_new, b_new


def cdg_of(b_new, cfg: SimConfig, dt):
    """The MLS-MPM F update's factor I - invD dt inv_dx B."""
    eye = torch.eye(cfg.dim, dtype=b_new.dtype, device=b_new.device)
    invD = inv_D(cfg.kernel_order)
    return eye - _folded(invD, dt, cfg.inv_dx) * b_new


def g2p_finish(p: Particles, v_new, b_new, cfg: SimConfig, dt, zero_C=None,
               return_count: bool = False):
    """The tail of G2P: RPIC/APIC damping, the MLS F update and the
    material return map, advection, the position clamp, inactive slots
    kept as they were, and NaN particles deactivated. `zero_C` masks the
    particles whose C is reset while the F update still uses b_new. With
    `return_count`, also the summed plasticity count of the particles
    left active (a 0-d int tensor)."""
    b_sym = 0.5 * (b_new + b_new.transpose(-1, -2))
    b_skew = b_new - b_sym
    C_new = (1.0 - cfg.rpic_damping) * b_sym + (1.0 - cfg.apic_damping) * b_skew
    if not cfg.apic:
        C_new = torch.zeros_like(C_new)
    if zero_C is not None:
        C_new = torch.where(zero_C[:, None, None], 0.0, C_new)

    F_new, aux_new, cnt = materials.dispatch_plasticity(
        cfg.active_materials, p.mat, p.F, cdg_of(b_new, cfg, dt), p.aux, p.params, dt)

    x_new = p.x + dt * v_new
    hi = (np.asarray(cfg.res, np.float32) - np.float32(cfg.clamp_eps)) * np.float32(cfg.dx)
    x_new = torch.minimum(torch.clamp(x_new, min=0.0), const(hi, torch.float32, x_new.device))

    act = p.active
    x = torch.where(act[:, None], x_new, p.x)
    v = torch.where(act[:, None], v_new, p.v)
    F = torch.where(act[:, None, None], F_new, p.F)
    finite = (torch.all(torch.isfinite(x), -1) & torch.all(torch.isfinite(v), -1)
              & torch.all(torch.isfinite(F).flatten(-2), -1))
    out = dataclasses.replace(
        p, x=x, v=v, F=F,
        C=torch.where(act[:, None, None], C_new, p.C),
        aux=torch.where(act, aux_new, p.aux),
        active=act & finite)
    if return_count:
        return out, torch.sum(torch.where(out.active, cnt, 0))
    return out
