"""The blocked substep's pieces on a Particles set, and the grid update
on node records (torch counterpart of the parts of
``taichi_mpm_tpu.ops.substep`` that the pytree CPIC frame runs):
``build_page_map_full`` (the page map with each particle's block
origin), ``prep_p2g`` (the P2G operand of ``ops/p2g.p2g_blocked``) and
``grid_update_flat``."""

from __future__ import annotations

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.levelset import DirichletRegion
from taichi_mpm_torch.materials import models as materials
from taichi_mpm_torch.math.kernels import inv_D
from taichi_mpm_torch.ops import blocked
from taichi_mpm_torch.utils import const


def build_page_map_full(keys, cfg: SimConfig, K: int):
    """The page map of sorted keys (``ops.packed.build_page_map_packed``)
    with each lane's block origin in grid units, ``origin`` (P, 3)."""
    from taichi_mpm_torch.ops import packed

    pm = packed.build_page_map_packed(keys, cfg, K)
    pm["origin"] = packed.origin_rows(keys, cfg).t()
    return pm


def prep_p2g(p, keys, cfg: SimConfig, dt, origin=None):
    """The P2G operand (16, P) of a sorted Particles set: m v (3), m, the
    affine A (9, row-major) and the block-local position (3), with the
    matrix-form material force (the JAX package's ``prep_p2g``, whose
    folded dt factors this keeps: invD * inv_dx * dt in float64, gravity
    times float32 dt). Inactive particles get m = A = 0."""
    if origin is None:
        from taichi_mpm_torch.ops import packed

        origin = packed.origin_rows(keys, cfg).t()
    invD = inv_D(cfg.kernel_order)
    pos_local = p.x * cfg.inv_dx - origin
    vel = p.v
    if cfg.particle_gravity:
        vel = vel + const(cfg.gravity, device=p.device) * float(np.float32(dt))
    force = materials.dispatch_force(cfg.active_materials, p.mat, p.F, p.aux, p.params, p.vol)
    act = p.active
    affine = invD * p.mass[:, None, None] * p.C - (invD * cfg.inv_dx * dt) * force
    affine = torch.where(act[:, None, None], affine, 0.0)
    mass = torch.where(act, p.mass, 0.0)
    mv = mass[:, None] * vel
    return torch.cat([mv.t(), mass[None], affine.reshape(-1, 9).t(), pos_local.t()])


def grid_update_flat(rec, ids, cfg: SimConfig, colliders, t, dt):
    """Normalize + gravity + boundary projection on node records (K, 256)
    [c-major lanes: c*64 + l] -> velocity records (K, 192).

    The friction projection keeps the reference's sqrt(max(|vt|^2,
    1e-30)) form, which differs from ``levelset.friction_project``'s
    max(|vt|, 1e-30) in the JAX package; the blocked path is held to
    this one."""
    mass = rec[:, 192:256]
    has_mass = mass > 0.0
    inv = torch.where(has_mass, 1.0 / torch.clamp(mass, min=1e-30), 0.0)
    v = [rec[:, c * 64 : (c + 1) * 64] * inv for c in range(3)]
    if not cfg.particle_gravity:
        for c in range(3):
            v[c] = torch.where(has_mass, v[c] + cfg.gravity[c] * dt, v[c])
    if colliders:
        bx, by, bz, _ = blocked._decode_ids(ids, cfg)
        li = torch.arange(64, dtype=torch.int32, device=rec.device)
        lx, ly, lz = li // 16, (li // 4) % 4, li % 4
        gx = (bx[:, None] * 4 + lx).to(torch.float32) * cfg.dx
        gy = (by[:, None] * 4 + ly).to(torch.float32) * cfg.dx
        gz = (bz[:, None] * 4 + lz).to(torch.float32) * cfg.dx
        xg = torch.stack([gx, gy, gz], -1)  # (K, 64, 3)
        for c in colliders:
            if isinstance(c, DirichletRegion):
                m = c.mask(xg, t)
                vel = c.velocity if c.velocity else (0.0, 0.0, 0.0)
                for k in range(3):
                    v[k] = torch.where(m, float(vel[k]), v[k])
                continue
            phi = c.sdf(xg, t)
            band = (phi > c.band_lo * cfg.dx) & (phi <= c.band_hi * cfg.dx) & has_mass
            nrm = c.normal(xg, t, eps=0.5 * cfg.dx)
            bv = c.boundary_velocity(xg, t)
            n_c = [nrm[..., k] for k in range(3)]
            bv_c = [bv[..., k] for k in range(3)]
            # componentwise friction projection (reference mpm_fwd.h)
            mu = float(c.friction)
            sticky = mu == -1.0
            slip = mu <= -2.0
            mu_eff = -mu - 2.0 if slip else mu
            rel = [v[k] - bv_c[k] for k in range(3)]
            vn = sum(n_c[k] * rel[k] for k in range(3))
            vt = [rel[k] - vn * n_c[k] for k in range(3)]
            vt_norm = torch.sqrt(
                torch.clamp(sum(vt[k] * vt[k] for k in range(3)), min=1e-30)
            )
            scale = torch.clamp(vt_norm + torch.clamp(vn, max=0.0) * mu_eff, min=0.0) / vt_norm
            keep_n = 0.0 if slip else torch.clamp(vn, min=0.0)
            for k in range(3):
                proj = bv_c[k] if sticky else scale * vt[k] + keep_n * n_c[k] + bv_c[k]
                v[k] = torch.where(band, proj, v[k])
    return torch.cat(v, dim=1)
