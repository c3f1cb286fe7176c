"""Constitutive models (8) over particle arrays in matrix form (torch
counterpart of ``taichi_mpm_tpu.materials.models``): material ids, the
host-side parameter packing, and per material the force -vol P F^T, the
return map, the CFL dt limit and the potential energy, for F of shape
(..., d, d) with d = 2 or 3, in the JAX package's formulas and order of
operations. The dense path (``core.transfer``) and every 2-D scene use
these; the blocked path uses the component forms of
``materials.cforms``, as the JAX package's fused kernels do, whose bits
differ from these. The ``dispatch_*`` functions blend the materials of
the scene's static set by each particle's id.

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
from taichi_mpm_torch.math.svd import inv_transpose, mm as _mm, polar_decomp, polar_newton, svd

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


# -- small matrix helpers (2x2 / 3x3, unrolled as the JAX package's) ---------


def _mt(a):
    return a.transpose(-1, -2)


def _det(F):
    """Closed-form 2x2 / 3x3 determinant."""
    if F.shape[-1] == 2:
        return F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
    return (F[..., 0, 0] * (F[..., 1, 1] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 1])
            - F[..., 0, 1] * (F[..., 1, 0] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 0])
            + F[..., 0, 2] * (F[..., 1, 0] * F[..., 2, 1] - F[..., 1, 1] * F[..., 2, 0]))


def _eye_like(F):
    return torch.eye(F.shape[-1], dtype=F.dtype, device=F.device).expand(F.shape)


def sum_last(x):
    """x summed over its last axis in index order (jnp.sum over d <= 3)."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k]
    return out


def _prod_last(x):
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out * x[..., k]
    return out


def _trace(F):
    return sum_last(torch.diagonal(F, dim1=-2, dim2=-1))


def _fnorm2(P):
    """Sum of squares over the last two axes, row by row in index order."""
    return sum_last(sum_last(P * P))


def _clip(x, lo, hi):
    """jnp.clip: max then min, NaN propagating."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _scale_cols(U, s):
    """U * s[..., None, :]: column k of U times s_k."""
    return U * s[..., None, :]


def _recompose(U, s, V):
    return _mm(_scale_cols(U, s), _mt(V))


# -- stress (the reference's calculate_force = -vol P F^T) ----------------------


def _pft_fixed_corotated(F, mu, lam):
    """P F^T of fixed corotated: 2 mu (F - R) F^T + lam (J - 1) J I."""
    J = _det(F)
    R = polar_newton(F)
    return (2.0 * mu[..., None, None] * _mm(F - R, _mt(F))
            + (lam * (J - 1.0) * J)[..., None, None] * _eye_like(F))


def _pft_stvk_hencky(F, mu, lam):
    """P F^T of StVK with Hencky strain: P = U (2 mu S^-1 log S + lam
    tr(log S) S^-1) V^T."""
    U, sig, V = svd(F)
    s = torch.clamp(torch.abs(sig), min=1e-6)
    log_s = torch.log(s)
    inv_s = 1.0 / s
    center = (2.0 * mu[..., None] * inv_s * log_s
              + (lam * sum_last(log_s))[..., None] * inv_s)
    return _mm(_recompose(U, center, V), _mt(F))


def force_elastic(F, aux, params, vol):
    return -vol[..., None, None] * _pft_stvk_hencky(F, params[..., 0], params[..., 1])


def force_jelly(F, aux, params, vol):
    return -vol[..., None, None] * _pft_fixed_corotated(F, params[..., 0], params[..., 1])


def force_snow(F, aux, params, vol):
    """Fixed corotated with the hardening e^{h (1 - Jp)}."""
    e = torch.exp(params[..., 2] * (1.0 - aux))
    return -vol[..., None, None] * _pft_fixed_corotated(F, params[..., 0] * e,
                                                         params[..., 1] * e)


def force_water(F, aux, params, vol):
    """Weakly compressible EOS p = k (j^-gamma - 1): vol j p I."""
    k, gamma = params[..., 0], params[..., 1]
    p = k * (torch.pow(torch.clamp(aux, min=1e-6), -gamma) - 1.0)
    return (vol * aux * p)[..., None, None] * _eye_like(F)


force_sand = force_elastic
force_von_mises = force_elastic


def force_linear(F, aux, params, vol):
    """Small-strain linear elasticity."""
    mu, lam = params[..., 0], params[..., 1]
    I = _eye_like(F)
    d = F.shape[-1]
    P = (mu[..., None, None] * (F + _mt(F) - 2.0 * I)
         + (lam * (_trace(F) - d))[..., None, None] * I)
    return -vol[..., None, None] * _mm(P, _mt(F))


force_visco = force_jelly


# -- return maps (F update and plasticity); each returns (F, aux, count) -------


def _no_count(F):
    return torch.zeros(F.shape[:-2], dtype=torch.int32, device=F.device)


def plast_elastic(F, cdg, aux, params, dt):
    return _mm(cdg, F), aux, _no_count(F)


plast_jelly = plast_elastic
plast_linear = plast_elastic


def plast_snow(F, cdg, aux, params, dt):
    """Stomakhin's clamp of the singular values to [1 - theta_c, 1 +
    theta_s] with Jp tracking; the clamps let NaN through as the
    reference's ``!(x <= hi)`` does."""
    theta_c, theta_s = params[..., 3], params[..., 4]
    min_Jp, max_Jp = params[..., 5], params[..., 6]
    F = _mm(cdg, F)
    U, sig, V = svd(F)
    sig_c = _clip(sig, (1.0 - theta_c)[..., None], (1.0 + theta_s)[..., None])
    det_orig = _prod_last(sig)
    det_new = _prod_last(sig_c)
    F_new = _recompose(U, sig_c, V)
    Jp_new = aux * det_orig / det_new
    Jp_new = torch.where(Jp_new <= max_Jp, Jp_new, max_Jp)
    Jp_new = torch.where(Jp_new >= min_Jp, Jp_new, min_Jp)
    return F_new, Jp_new, _no_count(F)


def plast_water(F, cdg, aux, params, dt):
    """J tracked by the linearized determinant, floored at 0.1; F is
    left as it is. Counts the particles with J > 1."""
    d = F.shape[-1]
    j = torch.clamp(aux * (_trace(cdg) - (d - 1)), min=0.1)
    return F, j, (j > 1.0).to(torch.int32)


def _sand_strain(F, cdg, aux, params):
    """(U, sig, V, eps, tr, eps_hat, |eps_hat|, delta_gamma) of sand's
    return map on cdg F."""
    alpha, cohesion = params[..., 2], params[..., 3]
    mu0, lam0 = params[..., 0], params[..., 1]
    d = float(F.shape[-1])
    U, sig, V = svd(_mm(cdg, F))
    eps = torch.log(torch.clamp(torch.abs(sig), min=1e-4)) - cohesion[..., None]
    tr = sum_last(eps) + aux
    eps_hat = eps - (tr / d)[..., None]
    eps_hat_norm = torch.sqrt(sum_last(eps_hat * eps_hat))
    delta_gamma = eps_hat_norm + (d * lam0 + 2.0 * mu0) / (2.0 * mu0) * tr * alpha
    return U, sig, V, eps, tr, eps_hat, eps_hat_norm, delta_gamma


def sand_edges(F, cdg, aux, params):
    """(tr, delta_gamma) of sand's return map: it projects to the tip
    where tr >= 0 and onto the cone where delta_gamma > 0, so a lane
    with either within rounding of 0 may take either branch on two
    devices (``diagnostics.dense_sand_knife_edges``)."""
    out = _sand_strain(F, cdg, aux, params)
    return out[4], out[7]


def plast_sand(F, cdg, aux, params, dt):
    """Drucker-Prager return map with cohesion and the logJp volume
    correction. Counts the projected particles."""
    cohesion, beta = params[..., 3], params[..., 4]
    logJp = aux
    U, sig, V, eps, tr, eps_hat, eps_hat_norm, delta_gamma = _sand_strain(F, cdg, aux, params)

    # tr >= 0: projected to the tip
    sig_tip = torch.exp(cohesion)[..., None] * torch.ones_like(sig)
    logJp_A = beta * sum_last(eps) + logJp

    # tr < 0
    h_elastic = eps + cohesion[..., None]
    safe_norm = torch.clamp(eps_hat_norm, min=1e-20)
    h_yield = eps - (delta_gamma / safe_norm)[..., None] * eps_hat + cohesion[..., None]
    h = torch.where((delta_gamma <= 0.0)[..., None], h_elastic, h_yield)
    sig_B = torch.exp(h)

    case_A = tr >= 0.0
    sig_new = torch.where(case_A[..., None], sig_tip, sig_B)
    logJp_new = torch.where(case_A, logJp_A, torch.zeros_like(logJp))
    count = (case_A | (delta_gamma > 0.0)).to(torch.int32)
    return _recompose(U, sig_new, V), logJp_new, count


def plast_von_mises(F, cdg, aux, params, dt):
    """Von Mises yield on the Hencky strain, comparing the squared norm of
    its deviator with yield / (2 mu) as the reference does. Counts the
    yielded particles."""
    mu0, yield_stress = params[..., 0], params[..., 2]
    d = float(F.shape[-1])
    F = _mm(cdg, F)
    U, sig, V = svd(F)
    eps = torch.log(torch.clamp(torch.abs(sig), min=1e-6))
    tr = sum_last(eps)
    eps_hat = eps - (tr / d)[..., None]
    eps_hat_norm2 = sum_last(eps_hat * eps_hat)
    delta_gamma = eps_hat_norm2 - yield_stress / (2.0 * mu0)
    yielded = delta_gamma > 0.0
    safe = torch.clamp(eps_hat_norm2, min=1e-20)
    H = eps - (delta_gamma / safe)[..., None] * eps_hat
    sig_new = torch.where(yielded[..., None], torch.exp(H), sig)
    return _recompose(U, sig_new, V), aux, yielded.to(torch.int32)


def _inverse_small(F):
    """Inverse of 2x2 / 3x3 matrices by the adjugate, |det| floored at
    1e-20 (the JAX package inverts 3x3 by LU; the two differ in rounding
    only, and where F is singular)."""
    return _mt(inv_transpose(F))


def _visco_pk1_norm(F, mu, lam):
    """Frobenius norm of the fixed-corotated first Piola-Kirchhoff stress."""
    J = _det(F)
    R = polar_newton(F)
    FinvT = _mt(_inverse_small(F))
    P = (2.0 * mu[..., None, None] * (F - R)
         + (lam * (J - 1.0) * J)[..., None, None] * FinvT)
    return torch.sqrt(_fnorm2(P))


def plast_visco(F, cdg, aux, params, dt):
    """Shear-dependent viscoplastic flow; aux is the mutable yield
    threshold tau. The reference's recursive halving of the matrix
    exponential is unrolled to 4 levels, the first whose quadratic
    approximant has a positive determinant taken."""
    mu0, lam0 = params[..., 0], params[..., 1]
    visco_nu, visco_kappa = params[..., 2], params[..., 3]
    tau = aux
    d = float(F.shape[-1])
    I = _eye_like(F)
    s_full = cdg - I

    exp_approx = valid_any = None
    for k in range(4):
        s_k = s_full / float(2 ** k)
        r = _mm(0.5 * s_k + I, s_k) + I
        comp = r
        for _ in range(k):
            comp = _mm(comp, comp)
        ok = _det(r) > 0.0
        if exp_approx is None:
            exp_approx, valid_any = comp, ok
        else:
            exp_approx = torch.where((ok & ~valid_any)[..., None, None], comp, exp_approx)
            valid_any = valid_any | ok

    U, sig, V = svd(_mm(exp_approx, F))

    pnorm = _visco_pk1_norm(F, mu0, lam0)
    flow = dt * visco_nu * (pnorm - tau) / torch.clamp(pnorm, min=1e-20)
    gamma = torch.where(pnorm > 1e-5, _clip(flow, torch.zeros_like(flow),
                                            torch.ones_like(flow)), 0.0)
    det_sig = _prod_last(sig)
    scale = torch.where(
        torch.abs(det_sig) > 1e-5,
        1.0 / torch.pow(torch.clamp(torch.abs(det_sig), min=1e-20), 1.0 / d),
        1.0)
    middle = torch.pow(torch.clamp(sig * scale[..., None], min=1e-20), gamma[..., None])
    middle_inv = torch.where(torch.abs(middle) > 1e-5, 1.0 / middle, 1.0)
    F_new = _recompose(U, sig * middle_inv, V)

    U2, sig2, V2 = svd(F_new)
    F_new = _recompose(U2, torch.clamp(sig2, 0.1, 10.0), V2)
    return F_new, tau + visco_kappa * gamma * pnorm, _no_count(F)


# -- CFL sound-speed dt limit (+inf where the reference has none) --------------


def allowed_dt(mat_id: int, F, aux, params, vol, mass, speed, dx):
    """Per-particle allowed dt: dx / (sound speed + |v|); +inf for linear
    and jelly, which the reference leaves unconstrained."""
    mu0, lam0 = params[..., 0], params[..., 1]
    J = torch.clamp(_det(F), min=1e-8)
    rho0 = mass / torch.clamp(vol, min=1e-20)
    if mat_id in (ELASTIC, SAND, VON_MISES, VISCO):
        rho = rho0 / J
        K = 2.0 * mu0 / 3.0 + lam0
        c2 = 4.0 * mu0 / (3.0 * rho) + K * (1.0 - torch.log(J)) / rho0
        c = torch.sqrt(torch.clamp(c2, min=1e-20))
    elif mat_id == SNOW:
        rho = rho0 / torch.clamp(J * aux, min=1e-8)
        e = torch.exp(params[..., 2] * (1.0 - aux))
        c = torch.sqrt(torch.clamp((lam0 * e + 2.0 * mu0 * e) / rho, min=1e-20))
    elif mat_id == WATER:
        k, gamma = params[..., 0], params[..., 1]
        c = torch.sqrt(torch.clamp(
            k * gamma / torch.pow(torch.clamp(aux, min=0.1), gamma - 1.0), min=1e-20))
    else:
        return torch.full(F.shape[:-2], float("inf"), dtype=F.dtype, device=F.device)
    # a true division, as jnp's (torch divides a number by a tensor as
    # reciprocal(tensor) * number, which rounds twice)
    return torch.full_like(c, dx) / (c + speed)


# -- potential energy (the conservation diagnostic) ----------------------------


def potential_energy(mat_id: int, F, aux, params, vol):
    """Elastic potential energy per particle of material `mat_id`:
    linear's small-strain energy, jelly's fixed-corotated one (polar
    decomposition), elastic's Hencky one (SVD); 0 for the other
    materials, as in the JAX package."""
    mu, lam = params[..., 0], params[..., 1]
    if mat_id == LINEAR:
        e = 0.5 * (F + _mt(F)) - _eye_like(F)
        return vol * (mu * torch.sum(e * e, (-2, -1)) + 0.5 * lam * _trace(e) ** 2)
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


# -- dispatch over the scene's materials ---------------------------------------

FORCE_FNS = {
    ELASTIC: force_elastic, JELLY: force_jelly, SNOW: force_snow, WATER: force_water,
    SAND: force_sand, VON_MISES: force_von_mises, LINEAR: force_linear, VISCO: force_visco,
}

PLASTICITY_FNS = {
    ELASTIC: plast_elastic, JELLY: plast_jelly, SNOW: plast_snow, WATER: plast_water,
    SAND: plast_sand, VON_MISES: plast_von_mises, LINEAR: plast_linear, VISCO: plast_visco,
}


def dispatch_force(active_materials, mat, F, aux, params, vol):
    """-vol P F^T of each particle by its material id `mat`."""
    if len(active_materials) == 1:
        return FORCE_FNS[active_materials[0]](F, aux, params, vol)
    out = torch.zeros_like(F)
    for m in active_materials:
        out = torch.where((mat == m)[..., None, None], FORCE_FNS[m](F, aux, params, vol), out)
    return out


def dispatch_plasticity(active_materials, mat, F, cdg, aux, params, dt):
    """(F, aux, count) of each particle's return map by its material id."""
    if len(active_materials) == 1:
        return PLASTICITY_FNS[active_materials[0]](F, cdg, aux, params, dt)
    F_out, aux_out = torch.zeros_like(F), torch.zeros_like(aux)
    cnt = _no_count(F)
    for m in active_materials:
        Fm, am, cm = PLASTICITY_FNS[m](F, cdg, aux, params, dt)
        sel = mat == m
        F_out = torch.where(sel[..., None, None], Fm, F_out)
        aux_out = torch.where(sel, am, aux_out)
        cnt = torch.where(sel, cm, cnt)
    return F_out, aux_out, cnt


def dispatch_allowed_dt(active_materials, mat, F, aux, params, vol, mass, speed, dx):
    """Per-particle allowed dt by material id; +inf where unconstrained."""
    out = torch.full(F.shape[:-2], float("inf"), dtype=F.dtype, device=F.device)
    for m in active_materials:
        out = torch.where(mat == m, allowed_dt(m, F, aux, params, vol, mass, speed, dx), out)
    return out


def dispatch_potential_energy(active_materials, mat, F, aux, params, vol):
    """``potential_energy`` of each particle by its material id `mat`."""
    out = torch.zeros(F.shape[:-2], dtype=F.dtype, device=F.device)
    for m in active_materials:
        out = torch.where(mat == m, potential_energy(m, F, aux, params, vol), out)
    return out
