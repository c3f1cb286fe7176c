"""Grid update on node records (torch counterpart of
``taichi_mpm_tpu.ops.substep.grid_update_flat``)."""

from __future__ import annotations

import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.levelset import DirichletRegion
from taichi_mpm_torch.ops import blocked


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
