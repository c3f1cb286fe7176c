// The eight materials per particle: the device counterpart of the forces
// and return maps of taichi_mpm_torch/materials/cforms.py (the twin of
// the JAX package's materials/cforms.py, which the TPU kernels run inside
// fused_pallas._build_pd and _finish_tile). Same formulas, same order of
// operations (see cmat3.cuh for what still rounds otherwise).
//
// The kernels are compiled for the scene's material set MATS (a bit set
// 1 << id). dispatch<MATS>(m, fn) calls fn with the lane's material as a
// compile-time constant, testing the set's materials from the highest id
// down; the lowest id of the set takes every other lane (a lane of a
// material outside the set is a caller's error: the API builds the set
// from the scene's materials). A set of one material tests nothing.
//
// NaN semantics follow the twin's: nan_max / nan_clip where it clamps
// (torch.clamp, maximum and minimum keep a NaN; fmaxf and fminf drop it),
// and each torch.where(cond, a, b) is cond ? a : b with the same
// comparison, so a NaN takes the branch the twin takes.
#pragma once

#include <cuda_runtime.h>

#include "cmat3.cuh"
#include "common.cuh"

namespace mpm {

constexpr int ELASTIC = 0, SNOW = 2, SAND = 4, VON_MISES = 5, LINEAR = 6, VISCO = 7;

template <int M>
struct Mat {
  static constexpr int id = M;
};

template <int MATS>
__host__ __device__ constexpr bool has(int id) {
  return ((MATS >> id) & 1) != 0;
}

template <int MATS>
__host__ __device__ constexpr bool single_material() {
  return MATS != 0 && (MATS & (MATS - 1)) == 0;
}

template <int MATS, int M = 7, class Fn>
__device__ __forceinline__ void dispatch(int m, Fn&& fn) {
  if constexpr (M >= 0) {
    if constexpr (!has<MATS>(M)) {
      dispatch<MATS, M - 1>(m, fn);
    } else if constexpr ((MATS & ((1 << M) - 1)) == 0) {
      fn(Mat<M>{});  // the lowest id of the set
    } else {
      if (m == M) {
        fn(Mat<M>{});
      } else {
        dispatch<MATS, M - 1>(m, fn);
      }
    }
  }
}

// The materials whose force (P2G) reads aux, and whose return map (G2P)
// reads aux and writes it back (von Mises keeps it, water's F stays).
constexpr int FORCE_AUX = (1 << SNOW) | (1 << WATER);
constexpr int PLAST_AUX = (1 << SNOW) | (1 << WATER) | (1 << SAND) | (1 << VISCO);

// The parameter slots (bit k: row RPAR + k) the return maps of the set
// MATS read: sand 0-4, snow 3-6, von Mises 0 and 2, visco 0-3.
template <int MATS>
__host__ __device__ constexpr int plast_param_slots() {
  return (has<MATS>(SAND) ? 0x1F : 0) | (has<MATS>(SNOW) ? 0x78 : 0) |
         (has<MATS>(VON_MISES) ? 0x5 : 0) | (has<MATS>(VISCO) ? 0xF : 0);
}

// -- forces: -vol * P F^T ---------------------------------------------------

// JELLY (mu, lam = params 0, 1), VISCO, and SNOW with hardened mu, lam:
// -vol * [2 mu (F - R) F^T + lam (J - 1) J I] (cforms._pft_fixed_corotated)
__device__ __forceinline__ void force_fixed_corotated(const float F[9], float mu, float lam,
                                                      float vol, float force[9]) {
  float Rm[9];
  polar_newton(F, Rm);
  const float J = det3(F);
  const float diag = lam * (J - 1.0f) * J;
  const float two_mu = 2.0f * mu;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float pft = (F[3 * i] - Rm[3 * i]) * F[3 * j] +
                  (F[3 * i + 1] - Rm[3 * i + 1]) * F[3 * j + 1] +
                  (F[3 * i + 2] - Rm[3 * i + 2]) * F[3 * j + 2];
      pft = pft * two_mu + (i == j ? diag : 0.0f);
      force[3 * i + j] = pft * -vol;
    }
  }
}

// ELASTIC, SAND, VON_MISES: -vol * U (2 mu S^-1 log S + lam tr(log S)
// S^-1) V^T F^T, S clamped to 1e-6 (cforms._pft_stvk_hencky)
__device__ __forceinline__ void force_hencky(const float F[9], float mu, float lam, float vol,
                                             float force[9]) {
  float U[9], sig[3], V[9];
  c_svd(F, U, sig, V);
  float log_s[3], inv_s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = nan_max(fabsf(sig[k]), 1e-6f);
    log_s[k] = logf(s);
    inv_s[k] = 1.0f / s;
  }
  const float tr_log = log_s[0] + log_s[1] + log_s[2];
  float center[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    center[k] = 2.0f * mu * inv_s[k] * log_s[k] + lam * tr_log * inv_s[k];
  }
  float P[9], pft[9];
  c_usvt(U, center, V, P);
  c_mmt(P, F, pft);
#pragma unroll
  for (int k = 0; k < 9; ++k) force[k] = pft[k] * -vol;
}

// LINEAR: -vol * [mu (F + F^T - 2 I) + lam (tr F - 3) I] F^T
// (cforms.force_linear; the identity's zeros multiply too, as there)
__device__ __forceinline__ void force_linear(const float F[9], float mu, float lam, float vol,
                                             float force[9]) {
  const float tr = F[0] + F[4] + F[8];
  const float q = lam * (tr - 3.0f);
  float P[9], pft[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      P[3 * i + j] = (F[3 * i + j] + F[3 * j + i] - 2.0f * eye) * mu + eye * q;
    }
  }
  c_mmt(P, F, pft);
#pragma unroll
  for (int k = 0; k < 9; ++k) force[k] = pft[k] * -vol;
}

// The force of material M from F, aux, the parameter slots par[] and vol.
template <int M>
__device__ __forceinline__ void material_force(const float F[9], float aux, const float par[8],
                                               float vol, float force[9]) {
  if constexpr (M == WATER) {
    // k = params[0], gamma = params[1], j = aux (cforms.force_water)
    const float diag = water_force_diag(aux, vol, par[0], par[1]);
#pragma unroll
    for (int k = 0; k < 9; ++k) force[k] = (k % 4 == 0) ? diag : 0.0f;
  } else if constexpr (M == JELLY || M == VISCO) {
    force_fixed_corotated(F, par[0], par[1], vol, force);
  } else if constexpr (M == SNOW) {
    const float e = expf(par[2] * (1.0f - aux));
    force_fixed_corotated(F, par[0] * e, par[1] * e, vol, force);
  } else if constexpr (M == LINEAR) {
    force_linear(F, par[0], par[1], vol, force);
  } else {  // ELASTIC, SAND, VON_MISES
    force_hencky(F, par[0], par[1], vol, force);
  }
}

// -- return maps --------------------------------------------------------------

// The return map's result: the new F (for water the old one), the new aux
// (the old one where the material keeps it) and the plastic event count.
struct Plastic {
  float F[9];
  float aux;
  int count;
};

// SNOW: F = cdg F clipped to singular values in [1 - theta_c, 1 + theta_s],
// Jp (aux) scaled by the clipped determinant and clamped to
// [min_Jp, max_Jp] (cforms.plast_snow)
__device__ __forceinline__ void plast_snow(const float Fc[9], float aux, const float par[8],
                                           Plastic& out) {
  float U[9], sig[3], V[9], sc[3];
  c_svd(Fc, U, sig, V);
#pragma unroll
  for (int k = 0; k < 3; ++k) sc[k] = nan_clip(sig[k], 1.0f - par[3], 1.0f + par[4]);
  const float det_orig = sig[0] * sig[1] * sig[2];
  const float det_new = sc[0] * sc[1] * sc[2];
  c_usvt(U, sc, V, out.F);
  float Jp = aux * det_orig / det_new;
  Jp = Jp <= par[6] ? Jp : par[6];
  Jp = Jp >= par[5] ? Jp : par[5];
  out.aux = Jp;
  out.count = 0;
}

// SAND: Drucker-Prager return map in log-strain space; aux is log Jp
// (cforms.plast_sand). An event where the state projects to the tip
// (tr >= 0) or onto the cone (delta_gamma > 0).
__device__ __forceinline__ void plast_sand(const float Fc[9], float logJp, const float par[8],
                                           Plastic& out) {
  const float mu0 = par[0], lam0 = par[1], alpha = par[2], cohesion = par[3], beta = par[4];
  float U[9], sig[3], V[9];
  c_svd(Fc, U, sig, V);
  float eps[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) eps[k] = logf(nan_max(fabsf(sig[k]), 1e-4f)) - cohesion;
  const float sum_eps = eps[0] + eps[1] + eps[2];
  const float tr = sum_eps + logJp;
  float eh[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) eh[k] = eps[k] - tr / 3.0f;
  const float ehn = sqrtf(eh[0] * eh[0] + eh[1] * eh[1] + eh[2] * eh[2]);
  const float sig_tip = expf(cohesion);
  const float logJp_A = beta * sum_eps + logJp;
  const float delta_gamma = ehn + (3.0f * lam0 + 2.0f * mu0) / (2.0f * mu0) * tr * alpha;
  const float coef = delta_gamma / nan_max(ehn, 1e-20f);
  const bool elastic_case = delta_gamma <= 0.0f;
  const bool case_A = tr >= 0.0f;
  float sn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float h = elastic_case ? eps[k] + cohesion : eps[k] - coef * eh[k] + cohesion;
    sn[k] = case_A ? sig_tip : expf(h);
  }
  c_usvt(U, sn, V, out.F);
  out.aux = case_A ? logJp_A : 0.0f;
  out.count = (case_A || delta_gamma > 0.0f) ? 1 : 0;
}

// VON_MISES: return map onto the yield surface in log-strain space; aux
// kept (cforms.plast_von_mises). An event where it yields.
__device__ __forceinline__ void plast_von_mises(const float Fc[9], float aux,
                                                const float par[8], Plastic& out) {
  float U[9], sig[3], V[9];
  c_svd(Fc, U, sig, V);
  float eps[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) eps[k] = logf(nan_max(fabsf(sig[k]), 1e-6f));
  const float tr = eps[0] + eps[1] + eps[2];
  float eh[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) eh[k] = eps[k] - tr / 3.0f;
  const float ehn2 = eh[0] * eh[0] + eh[1] * eh[1] + eh[2] * eh[2];
  const float delta_gamma = ehn2 - par[2] / (2.0f * par[0]);
  const bool yielded = delta_gamma > 0.0f;
  const float coef = delta_gamma / nan_max(ehn2, 1e-20f);
  float sn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) sn[k] = yielded ? expf(eps[k] - coef * eh[k]) : sig[k];
  c_usvt(U, sn, V, out.F);
  out.aux = aux;
  out.count = yielded ? 1 : 0;
}

// |P| of the fixed-corotated first Piola stress (cforms._visco_pk1_norm)
__device__ __forceinline__ float visco_pk1_norm(const float F[9], float mu, float lam) {
  float Rm[9], FinvT[9];
  const float J = det3(F);
  polar_newton(F, Rm);
  c_inv_transpose(F, FinvT);
  const float diag = lam * (J - 1.0f) * J;
  const float two_mu = 2.0f * mu;
  float P[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) P[k] = (F[k] - Rm[k]) * two_mu + FinvT[k] * diag;
  return sqrtf(c_fnorm2(P));
}

// VISCO: exp(cdg - I) F by the first of the approximations
// r_k^(2^k), r_k = (s/2^k / 2 + I) s/2^k + I, k = 0..3, whose det r_k > 0
// (k = 0 where none is); then the viscous flow of its singular values
// toward volume-preserving ones by gamma (from |P| against the yield
// stress tau = aux), and the singular values clamped to [0.1, 10]
// (cforms.plast_visco).
__device__ __forceinline__ void plast_visco(const float F[9], const float cdg[9], float tau,
                                            const float par[8], float dt, Plastic& out) {
  const float mu0 = par[0], lam0 = par[1], visco_nu = par[2], visco_kappa = par[3];
  float s_full[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) s_full[k] = cdg[k] - ((k % 4 == 0) ? 1.0f : 0.0f);
  float E[9];
  bool found = false;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    if (k > 0 && found) break;
    const float scale = 1.0f / (float)(1 << k);
    float sk[9], h[9], r[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      sk[i] = s_full[i] * scale;
      h[i] = sk[i] * 0.5f + ((i % 4 == 0) ? 1.0f : 0.0f);
    }
    c_mm(h, sk, r);
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = r[i] + ((i % 4 == 0) ? 1.0f : 0.0f);
    const bool ok = det3(r) > 0.0f;
    if (k == 0 || ok) {
#pragma unroll 1
      for (int j = 0; j < k; ++j) {
        float sq[9];
        c_mm(r, r, sq);
#pragma unroll
        for (int i = 0; i < 9; ++i) r[i] = sq[i];
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) E[i] = r[i];
    }
    found = ok;
  }
  float F_hat[9];
  c_mm(E, F, F_hat);
  float U[9], sig[3], V[9];
  c_svd(F_hat, U, sig, V);

  const float pnorm = visco_pk1_norm(F, mu0, lam0);
  const float gamma =
      pnorm > 1e-5f
          ? nan_clip(dt * visco_nu * (pnorm - tau) / nan_max(pnorm, 1e-20f), 0.0f, 1.0f)
          : 0.0f;
  const float det_sig = sig[0] * sig[1] * sig[2];
  const float scale = fabsf(det_sig) > 1e-5f
                          ? 1.0f / powf(nan_max(fabsf(det_sig), 1e-20f), 1.0f / 3.0f)
                          : 1.0f;
  float sm[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float middle = powf(nan_max(sig[k] * scale, 1e-20f), gamma);
    const float middle_inv = fabsf(middle) > 1e-5f ? 1.0f / middle : 1.0f;
    sm[k] = sig[k] * middle_inv;
  }
  float Fn[9];
  c_usvt(U, sm, V, Fn);
  float U2[9], sig2[3], V2[9];
  c_svd(Fn, U2, sig2, V2);
#pragma unroll
  for (int k = 0; k < 3; ++k) sig2[k] = nan_clip(sig2[k], 0.1f, 10.0f);
  c_usvt(U2, sig2, V2, out.F);
  out.aux = tau + visco_kappa * gamma * pnorm;
  out.count = 0;
}

// The return map of material M: F and cdg (the MLS update), aux, the
// parameter slots par[] and dt.
template <int M>
__device__ __forceinline__ void material_plasticity(const float F[9], const float cdg[9],
                                                    float aux, const float par[8], float dt,
                                                    Plastic& out) {
  if constexpr (M == WATER) {
    // cforms.plast_water: F unchanged, j = max(aux (tr cdg - 2), 0.1)
    out.aux = nan_max(aux * (cdg[0] + cdg[4] + cdg[8] - 2.0f), 0.1f);
#pragma unroll
    for (int k = 0; k < 9; ++k) out.F[k] = F[k];
    out.count = out.aux > 1.0f ? 1 : 0;
  } else if constexpr (M == VISCO) {
    plast_visco(F, cdg, aux, par, dt, out);
  } else {
    float Fc[9];  // cdg F
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Fc[3 * i + j] = cdg[3 * i] * F[j] + cdg[3 * i + 1] * F[3 + j] + cdg[3 * i + 2] * F[6 + j];
      }
    }
    if constexpr (M == SNOW) {
      plast_snow(Fc, aux, par, out);
    } else if constexpr (M == SAND) {
      plast_sand(Fc, aux, par, out);
    } else if constexpr (M == VON_MISES) {
      plast_von_mises(Fc, aux, par, out);
    } else {  // JELLY, ELASTIC, LINEAR (cforms.plast_elastic): F <- cdg F
#pragma unroll
      for (int k = 0; k < 9; ++k) out.F[k] = Fc[k];
      out.aux = aux;
      out.count = 0;
    }
  }
}

}  // namespace mpm
