"""Material ids, host-side parameter packing, the per-particle dt limit
and the potential energy over particle arrays (the parts of
``taichi_mpm_tpu.materials.models`` the port uses; the matrix-form forces
and return maps are ``materials.cforms``' component forms).

Parameter slot layout of the 8-wide per-particle ``params``:
  slot 0: mu_0      (water: k)
  slot 1: lambda_0  (water: gamma)
  slot 2: material-specific (snow hardening / sand alpha / vm yield / visco nu)
  slot 3: material-specific (snow theta_c / sand cohesion / visco kappa)
  slot 4: material-specific (snow theta_s / sand beta)
  slot 5: snow min_Jp
  slot 6: snow max_Jp
  slot 7: reserved
"""

from __future__ import annotations

import math

import torch

from taichi_mpm_torch.materials import cforms
from taichi_mpm_torch.materials.cforms import (  # noqa: F401  (re-exported ids)
    ELASTIC,
    JELLY,
    LINEAR,
    SAND,
    SNOW,
    VISCO,
    VON_MISES,
    WATER,
)
from taichi_mpm_torch.math.svd import polar_decomp, svd

MATERIAL_NAMES = {
    "elastic": ELASTIC,
    "jelly": JELLY,
    "snow": SNOW,
    "water": WATER,
    "sand": SAND,
    "von_mises": VON_MISES,
    "linear": LINEAR,
    "visco": VISCO,
}
MATERIAL_IDS = {v: k for k, v in MATERIAL_NAMES.items()}


def lame_parameters(E: float, nu: float):
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def pack_params(material: str, **kw) -> tuple:
    """Pack a material's config kwargs into the 8-slot param vector + aux0.

    Returns (mat_id, params[8], aux0); defaults mirror the reference's
    particle ``initialize`` methods.
    """
    p = [0.0] * 8
    m = MATERIAL_NAMES[material]
    aux0 = 0.0
    if m == ELASTIC:
        mu, lam = lame_parameters(kw.get("E", 5e3), kw.get("nu", 0.4))
        p[0], p[1] = kw.get("mu_0", mu), kw.get("lambda_0", lam)
    elif m == JELLY:
        mu, lam = lame_parameters(kw.get("E", 1e5), kw.get("nu", 0.3))
        p[0], p[1] = mu, lam
    elif m == SNOW:
        mu, lam = lame_parameters(
            kw.get("youngs_modulus", 1.4e5), kw.get("poisson_ratio", 0.2)
        )
        p[0] = kw.get("mu_0", mu)
        p[1] = kw.get("lambda_0", lam)
        p[2] = kw.get("hardening", 10.0)
        p[3] = kw.get("theta_c", 2.5e-2)
        p[4] = kw.get("theta_s", 7.5e-3)
        p[5] = kw.get("min_Jp", 0.6)
        p[6] = kw.get("max_Jp", 20.0)
        aux0 = kw.get("Jp", 1.0)
    elif m == WATER:
        p[0] = kw.get("k", 1e4)
        p[1] = kw.get("gamma", 7.0)
        aux0 = 1.0
    elif m == SAND:
        p[0] = kw.get("mu_0", 136038.0)
        p[1] = kw.get("lambda_0", 204057.0)
        phi = kw.get("friction_angle", 30.0) / 180.0 * 3.141592653
        sin_phi = math.sin(phi)
        p[2] = math.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi)
        p[3] = kw.get("cohesion", 0.0)
        p[4] = kw.get("beta", 1.0)
        aux0 = 0.0  # logJp
    elif m == VON_MISES:
        mu, lam = lame_parameters(
            kw.get("youngs_modulus", 5e3), kw.get("poisson_ratio", 0.4)
        )
        p[0], p[1] = mu, lam
        p[2] = kw.get("yield_stress", 1.0)
    elif m == LINEAR:
        mu, lam = lame_parameters(kw.get("E", 1e5), kw.get("nu", 0.3))
        p[0], p[1] = mu, lam
    elif m == VISCO:
        mu, lam = lame_parameters(
            kw.get("youngs_modulus", 4e4), kw.get("poisson_ratio", 0.4)
        )
        p[0], p[1] = mu, lam
        p[2] = kw.get("nu", 1e4)  # visco_nu (plastic flow rate)
        p[3] = kw.get("kappa", 0.0)
        aux0 = kw.get("tau", 1000.0)  # visco_tau (mutable -> aux)
    else:
        raise ValueError(material)
    return m, tuple(p), aux0


def param_slot(material: str, name: str, base_kw=None) -> int:
    """Slot in the 8-wide params vector storing kwarg `name` VERBATIM
    (backs texture-modulated per-particle params, ``*_tex``). Found by
    probing pack_params with two sentinel values; raises for kwargs that
    are derived (e.g. E feeds both Lame slots) or unused."""
    base_kw = dict(base_kw or {})
    probes = (0.1234567, 0.7654321)
    outs = []
    for probe in probes:
        kw = dict(base_kw)
        kw[name] = probe
        _, p, _ = pack_params(material, **kw)
        outs.append(p)
    slots = [i for i in range(8) if outs[0][i] != outs[1][i]]
    if len(slots) != 1 or any(
        outs[j][slots[0]] != probes[j] for j in range(2)
    ):
        raise ValueError(
            f"material {material!r} does not store {name!r} verbatim in "
            f"a single param slot; *_tex modulation unsupported for it"
        )
    return slots[0]


def dispatch_allowed_dt(active_materials, mat, F, aux, params, vol, mass, speed, dx):
    """Per-particle allowed dt of particle arrays (F (..., 3, 3), params
    (..., 8)): ``cforms.dispatch_allowed_dt`` on their components; +inf
    where unconstrained (jelly, linear)."""
    Fc = tuple(F[..., i, j] for i in range(3) for j in range(3))
    pc = tuple(params[..., k] for k in range(8))
    return cforms.dispatch_allowed_dt(active_materials, mat, Fc, aux, pc, vol, mass, speed, dx)


# -- potential energy (the conservation diagnostic) ----------------------------


def _det(F):
    return (F[..., 0, 0] * (F[..., 1, 1] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 1])
            - F[..., 0, 1] * (F[..., 1, 0] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 0])
            + F[..., 0, 2] * (F[..., 1, 0] * F[..., 2, 1] - F[..., 1, 1] * F[..., 2, 0]))


def potential_energy(mat_id: int, F, aux, params, vol):
    """Elastic potential energy per particle of material `mat_id` (F
    (..., 3, 3), params (..., 8)): linear's small-strain energy, jelly's
    fixed-corotated one (polar decomposition), elastic's Hencky one (SVD);
    0 for the other materials, as in the JAX package."""
    mu, lam = params[..., 0], params[..., 1]
    if mat_id == LINEAR:
        eye = torch.eye(3, dtype=F.dtype, device=F.device)
        e = 0.5 * (F + F.transpose(-1, -2)) - eye
        tr = torch.diagonal(e, dim1=-2, dim2=-1).sum(-1)
        return vol * (mu * torch.sum(e * e, (-2, -1)) + 0.5 * lam * tr ** 2)
    if mat_id == JELLY:
        J = _det(F)
        R, _ = polar_decomp(F)
        diff = F - R
        return vol * (mu * torch.sum(diff * diff, (-2, -1)) + 0.5 * lam * (J - 1.0) ** 2)
    if mat_id == ELASTIC:
        _, sig, _ = svd(F)
        log_s = torch.log(torch.clamp(torch.abs(sig), min=1e-6))
        return vol * (mu * torch.sum(log_s * log_s, -1) + 0.5 * lam * torch.sum(log_s, -1) ** 2)
    return torch.zeros(F.shape[:-2], dtype=F.dtype, device=F.device)


def dispatch_potential_energy(active_materials, mat, F, aux, params, vol):
    """``potential_energy`` of each particle by its material id `mat`."""
    out = torch.zeros(F.shape[:-2], dtype=F.dtype, device=F.device)
    for m in active_materials:
        out = torch.where(mat == m, potential_energy(m, F, aux, params, vol), out)
    return out
