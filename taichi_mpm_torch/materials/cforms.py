"""Constitutive models in component form (3D), torch counterpart of
``taichi_mpm_tpu.materials.cforms``.

F is a 9-tuple, params an 8-tuple of tensors (slot layout in
``materials.models``), aux/vol plain tensors. Forces return the 9-tuple of
-vol * P F^T; plasticity returns (F_new 9-tuple, aux_new, count). These
plain-torch forms serve the CPU path and the kernels' plain twins; the
CUDA kernels repeat all eight per particle (``csrc/materials.cuh``).
"""

from __future__ import annotations

import torch

from taichi_mpm_torch.math.cmat3 import (
    c_add,
    c_col_scale,
    c_det,
    c_eye,
    c_fnorm2,
    c_inv_transpose,
    c_mm,
    c_mt,
    c_polar_newton,
    c_scale,
    c_sub,
    c_svd,
    c_trace,
    c_where,
)

# material ids (stable, mirror models.py)
ELASTIC, JELLY, SNOW, WATER, SAND, VON_MISES, LINEAR, VISCO = range(8)


def _pft_fixed_corotated(F, mu, lam):
    """2 mu (F - R) F^T + lam (J-1) J I."""
    J = c_det(F)
    R = c_polar_newton(F)
    diag = lam * (J - 1.0) * J
    out = c_scale(c_mm(c_sub(F, R), c_mt(F)), 2.0 * mu)
    return (
        out[0] + diag, out[1], out[2],
        out[3], out[4] + diag, out[5],
        out[6], out[7], out[8] + diag,
    )


def _pft_stvk_hencky(F, mu, lam):
    """U (2 mu S^-1 log S + lam tr(log S) S^-1) V^T F^T."""
    U, sig, V = c_svd(F)
    s = tuple(torch.clamp(torch.abs(x), min=1e-6) for x in sig)
    log_s = tuple(torch.log(x) for x in s)
    inv_s = tuple(1.0 / x for x in s)
    tr_log = log_s[0] + log_s[1] + log_s[2]
    center = tuple(
        2.0 * mu * i * l + lam * tr_log * i for i, l in zip(inv_s, log_s)
    )
    P = c_mm(c_col_scale(U, center), c_mt(V))
    return c_mm(P, c_mt(F))


def force_elastic(F, aux, params, vol):
    return c_scale(_pft_stvk_hencky(F, params[0], params[1]), -vol)


def force_jelly(F, aux, params, vol):
    return c_scale(_pft_fixed_corotated(F, params[0], params[1]), -vol)


def force_snow(F, aux, params, vol):
    e = torch.exp(params[2] * (1.0 - aux))
    return c_scale(
        _pft_fixed_corotated(F, params[0] * e, params[1] * e), -vol
    )


def force_water(F, aux, params, vol):
    k, gamma = params[0], params[1]
    j = aux
    p = k * (torch.pow(torch.clamp(j, min=1e-6), -gamma) - 1.0)
    diag = vol * j * p
    zero = torch.zeros_like(diag)
    return (diag, zero, zero, zero, diag, zero, zero, zero, diag)


force_sand = force_elastic
force_von_mises = force_elastic


def force_linear(F, aux, params, vol):
    mu, lam = params[0], params[1]
    tr = c_trace(F)
    sym = c_add(F, c_mt(F))
    I = c_eye(F[0])
    P = c_add(
        c_scale(c_sub(sym, c_scale(I, 2.0)), mu),
        c_scale(I, lam * (tr - 3.0)),
    )
    return c_scale(c_mm(P, c_mt(F)), -vol)


force_visco = force_jelly


# -- plasticity -------------------------------------------------------------


def _zero_count(aux):
    return torch.zeros_like(aux, dtype=torch.int32)


def plast_elastic(F, cdg, aux, params, dt):
    return c_mm(cdg, F), aux, _zero_count(aux)


plast_jelly = plast_elastic
plast_linear = plast_elastic


def plast_snow(F, cdg, aux, params, dt):
    theta_c, theta_s = params[3], params[4]
    min_Jp, max_Jp = params[5], params[6]
    F = c_mm(cdg, F)
    U, sig, V = c_svd(F)
    sig_c = tuple(
        torch.minimum(torch.maximum(s, 1.0 - theta_c), 1.0 + theta_s)
        for s in sig
    )
    det_orig = sig[0] * sig[1] * sig[2]
    det_new = sig_c[0] * sig_c[1] * sig_c[2]
    F_new = c_mm(c_col_scale(U, sig_c), c_mt(V))
    Jp = aux * det_orig / det_new
    Jp = torch.where(Jp <= max_Jp, Jp, max_Jp)
    Jp = torch.where(Jp >= min_Jp, Jp, min_Jp)
    return F_new, Jp, _zero_count(aux)


def plast_water(F, cdg, aux, params, dt):
    j = aux * (c_trace(cdg) - 2.0)
    j = torch.clamp(j, min=0.1)
    return F, j, (j > 1.0).to(torch.int32)


def _sand_strain(F, cdg, aux, params):
    """The SVD of cdg F and the sand return map's log strains: (U, V,
    eps, sum_eps, tr, eps_hat, ehn, delta_gamma)."""
    alpha, cohesion = params[2], params[3]
    mu0, lam0 = params[0], params[1]
    logJp = aux
    F = c_mm(cdg, F)
    U, sig, V = c_svd(F)

    eps = tuple(torch.log(torch.clamp(torch.abs(s), min=1e-4)) - cohesion
                for s in sig)
    sum_eps = eps[0] + eps[1] + eps[2]
    tr = sum_eps + logJp
    eps_hat = tuple(e - tr / 3.0 for e in eps)
    ehn = torch.sqrt(eps_hat[0] ** 2 + eps_hat[1] ** 2 + eps_hat[2] ** 2)
    delta_gamma = ehn + (3.0 * lam0 + 2.0 * mu0) / (2.0 * mu0) * tr * alpha
    return U, V, eps, sum_eps, tr, eps_hat, ehn, delta_gamma


def sand_edges(F, cdg, aux, params):
    """(tr, delta_gamma) of plast_sand: the map goes to the tip where
    tr >= 0 and onto the cone where delta_gamma > 0, so where either is
    within rounding of 0 two roundings of the same state may disagree."""
    *_, tr, _, _, delta_gamma = _sand_strain(F, cdg, aux, params)
    return tr, delta_gamma


def plast_sand(F, cdg, aux, params, dt):
    cohesion, beta = params[3], params[4]
    logJp = aux
    U, V, eps, sum_eps, tr, eps_hat, ehn, delta_gamma = _sand_strain(F, cdg, aux, params)

    sig_tip = torch.exp(cohesion)
    logJp_A = beta * sum_eps + logJp

    safe_norm = torch.clamp(ehn, min=1e-20)
    coef = delta_gamma / safe_norm
    elastic_case = delta_gamma <= 0.0
    h = tuple(
        torch.where(elastic_case, e + cohesion, e - coef * eh + cohesion)
        for e, eh in zip(eps, eps_hat)
    )
    sig_B = tuple(torch.exp(x) for x in h)

    case_A = tr >= 0.0
    sig_new = tuple(torch.where(case_A, sig_tip, sb) for sb in sig_B)
    logJp_new = torch.where(case_A, logJp_A, torch.zeros_like(logJp))
    F_new = c_mm(c_col_scale(U, sig_new), c_mt(V))
    count = (case_A | (delta_gamma > 0.0)).to(torch.int32)
    return F_new, logJp_new, count


def plast_von_mises(F, cdg, aux, params, dt):
    mu0 = params[0]
    yield_stress = params[2]
    F = c_mm(cdg, F)
    U, sig, V = c_svd(F)
    eps = tuple(torch.log(torch.clamp(torch.abs(s), min=1e-6)) for s in sig)
    tr = eps[0] + eps[1] + eps[2]
    eps_hat = tuple(e - tr / 3.0 for e in eps)
    ehn2 = eps_hat[0] ** 2 + eps_hat[1] ** 2 + eps_hat[2] ** 2
    delta_gamma = ehn2 - yield_stress / (2.0 * mu0)
    yielded = delta_gamma > 0.0
    safe = torch.clamp(ehn2, min=1e-20)
    coef = delta_gamma / safe
    sig_new = tuple(
        torch.where(yielded, torch.exp(e - coef * eh), s)
        for s, e, eh in zip(sig, eps, eps_hat)
    )
    F_new = c_mm(c_col_scale(U, sig_new), c_mt(V))
    return F_new, aux, yielded.to(torch.int32)


def _visco_pk1_norm(F, mu, lam):
    J = c_det(F)
    R = c_polar_newton(F)
    FinvT = c_inv_transpose(F)
    diag = lam * (J - 1.0) * J
    P = c_add(
        c_scale(c_sub(F, R), 2.0 * mu),
        c_scale(FinvT, diag),
    )
    return torch.sqrt(c_fnorm2(P))


def plast_visco(F, cdg, aux, params, dt):
    mu0, lam0 = params[0], params[1]
    visco_nu, visco_kappa = params[2], params[3]
    tau = aux
    I = c_eye(F[0])
    s_full = c_sub(cdg, I)

    exp_approx = None
    valid_any = None
    for k in range(4):
        s_k = c_scale(s_full, 1.0 / float(2 ** k))
        r = c_add(c_mm(c_add(c_scale(s_k, 0.5), I), s_k), I)
        comp = r
        for _ in range(k):
            comp = c_mm(comp, comp)
        ok = c_det(r) > 0.0
        if exp_approx is None:
            exp_approx, valid_any = comp, ok
        else:
            take = ok & ~valid_any
            exp_approx = c_where(take, comp, exp_approx)
            valid_any = valid_any | ok

    F_hat = c_mm(exp_approx, F)
    U, sig, V = c_svd(F_hat)

    pnorm = _visco_pk1_norm(F, mu0, lam0)
    gamma = torch.where(
        pnorm > 1e-5,
        torch.clamp(
            dt * visco_nu * (pnorm - tau) / torch.clamp(pnorm, min=1e-20),
            0.0, 1.0,
        ),
        0.0,
    )
    det_sig = sig[0] * sig[1] * sig[2]
    scale = torch.where(
        torch.abs(det_sig) > 1e-5,
        1.0 / torch.pow(torch.clamp(torch.abs(det_sig), min=1e-20), 1.0 / 3.0),
        1.0,
    )
    middle = tuple(
        torch.pow(torch.clamp(s * scale, min=1e-20), gamma) for s in sig
    )
    middle_inv = tuple(
        torch.where(torch.abs(m) > 1e-5, 1.0 / m, 1.0) for m in middle
    )
    F_new = c_mm(
        c_col_scale(U, tuple(s * mi for s, mi in zip(sig, middle_inv))),
        c_mt(V),
    )
    U2, sig2, V2 = c_svd(F_new)
    sig2 = tuple(torch.clamp(s, 0.1, 10.0) for s in sig2)
    F_new = c_mm(c_col_scale(U2, sig2), c_mt(V2))
    tau_new = tau + visco_kappa * gamma * pnorm
    return F_new, tau_new, _zero_count(aux)


# -- CFL sound-speed dt limit ----------------------------------------------


def allowed_dt(mat_id: int, F, aux, params, vol, mass, speed, dx):
    """Per-particle allowed dt; +inf where the reference returns 0
    (unconstrained)."""
    mu0, lam0 = params[0], params[1]
    J = torch.clamp(c_det(F), min=1e-8)
    rho0 = mass / torch.clamp(vol, min=1e-20)
    if mat_id in (ELASTIC, SAND, VON_MISES, VISCO):
        rho = rho0 / J
        K = 2.0 * mu0 / 3.0 + lam0
        c2 = 4.0 * mu0 / (3.0 * rho) + K * (1.0 - torch.log(J)) / rho0
        c = torch.sqrt(torch.clamp(c2, min=1e-20))
    elif mat_id == SNOW:
        Jt = J * aux
        rho = rho0 / torch.clamp(Jt, min=1e-8)
        e = torch.exp(params[2] * (1.0 - aux))
        c = torch.sqrt(torch.clamp((lam0 * e + 2.0 * mu0 * e) / rho, min=1e-20))
    elif mat_id == WATER:
        k, gamma = params[0], params[1]
        c = torch.sqrt(
            torch.clamp(
                k * gamma / torch.pow(torch.clamp(aux, min=0.1), gamma - 1.0),
                min=1e-20,
            )
        )
    else:  # LINEAR, JELLY: unconstrained
        return torch.full_like(aux, float("inf"))
    # a true division, as jnp's (torch computes scalar / tensor as
    # reciprocal(tensor) * scalar, which rounds twice)
    return torch.full_like(c, dx) / (c + speed)


def dispatch_allowed_dt(active_materials, mat, F, aux, params, vol, mass, speed, dx):
    """Per-particle allowed dt over the static active set (+inf for a
    lane of no active material)."""
    out = torch.full_like(aux, float("inf"))
    for m in active_materials:
        out = torch.where(mat == m, allowed_dt(m, F, aux, params, vol, mass, speed, dx), out)
    return out


FORCE_FNS = {
    ELASTIC: force_elastic,
    JELLY: force_jelly,
    SNOW: force_snow,
    WATER: force_water,
    SAND: force_sand,
    VON_MISES: force_von_mises,
    LINEAR: force_linear,
    VISCO: force_visco,
}

PLASTICITY_FNS = {
    ELASTIC: plast_elastic,
    JELLY: plast_jelly,
    SNOW: plast_snow,
    WATER: plast_water,
    SAND: plast_sand,
    VON_MISES: plast_von_mises,
    LINEAR: plast_linear,
    VISCO: plast_visco,
}


def dispatch_force(active_materials, mat, F, aux, params, vol):
    """Blend per-material forces over the static active set."""
    if len(active_materials) == 1:
        return FORCE_FNS[active_materials[0]](F, aux, params, vol)
    out = tuple(torch.zeros_like(F[0]) for _ in range(9))
    for m in active_materials:
        fm = FORCE_FNS[m](F, aux, params, vol)
        out = c_where(mat == m, fm, out)
    return out


def dispatch_plasticity(active_materials, mat, F, cdg, aux, params, dt):
    if len(active_materials) == 1:
        return PLASTICITY_FNS[active_materials[0]](F, cdg, aux, params, dt)
    F_out = tuple(torch.zeros_like(F[0]) for _ in range(9))
    aux_out = torch.zeros_like(aux)
    cnt = torch.zeros_like(aux, dtype=torch.int32)
    for m in active_materials:
        Fm, am, cm = PLASTICITY_FNS[m](F, cdg, aux, params, dt)
        sel = mat == m
        F_out = c_where(sel, Fm, F_out)
        aux_out = torch.where(sel, am, aux_out)
        cnt = torch.where(sel, cm, cnt)
    return F_out, aux_out, cnt
