// Shared device helpers of the port's MPM kernels: the packed-state row
// map (taichi_mpm_torch/ops/rows.py), the quadratic B-spline weight and
// NaN-propagating clamps that match jnp.maximum / jnp.clip, so a NaN
// reaches the finite check of the G2P finish exactly as in the JAX
// reference.
#pragma once

#include <cuda_runtime.h>

namespace mpm {

constexpr int NCH = 48;
constexpr int RX = 0, RV = 3, RF = 6, RC = 15;
constexpr int RAUX = 24, RMASS = 25, RVOL = 26, RPAR = 28, RACT = 36;
constexpr int RORG = 43, RMATF = 47;

// material ids (taichi_mpm_torch/materials/cforms.py) the kernels implement
constexpr int JELLY = 1, WATER = 3;

constexpr int TILE = 7;                       // halo nodes per axis (-1..5)
constexpr int TILE_NODES = TILE * TILE * TILE;  // 343

// Dense quadratic B-spline N(t), zero for |t| >= 1.5
// (ops/p2g_pallas._quadratic_weight in the JAX package).
__device__ __forceinline__ float quad_w(float t) {
  const float a = fabsf(t);
  const float inner = 0.75f - t * t;
  const float outer = 0.5f * (1.5f - a) * (1.5f - a);
  return a <= 0.5f ? inner : (a < 1.5f ? outer : 0.0f);
}

// max(a, b) that returns NaN when a is NaN (fmaxf would return b).
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}

__device__ __forceinline__ float nan_clip(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// Rotation factor of F by 6 scaled Newton iterations
// (math/cmat3.c_polar_newton, same formula and order).
__device__ __forceinline__ void polar_newton(const float F[9], float X[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) X[k] = F[k];
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
    const float a = X[0], b = X[1], c = X[2], d = X[3], e = X[4], f = X[5],
                g = X[6], h = X[7], i = X[8];
    float adj[9] = {e * i - f * h, f * g - d * i, d * h - e * g,
                    c * h - b * i, a * i - c * g, b * g - a * h,
                    b * f - c * e, c * d - a * f, a * e - b * d};
    const float det = a * adj[0] + b * adj[1] + c * adj[2];
    const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
    float nx2 = 0.0f, ni2 = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      adj[k] *= inv_det;  // now X^{-T}
      nx2 += X[k] * X[k];
      ni2 += adj[k] * adj[k];
    }
    const float gg = sqrtf(nan_max(sqrtf(ni2), 1e-20f) / nan_max(sqrtf(nx2), 1e-20f));
#pragma unroll
    for (int k = 0; k < 9; ++k) X[k] = 0.5f * (gg * X[k] + adj[k] / gg);
  }
}

// Water's equation of state: the diagonal of its force -vol P F^T is
// vol * j * k * (max(j, 1e-6)^-gamma - 1) (materials/cforms.force_water).
__device__ __forceinline__ float water_force_diag(float j, float vol, float k, float gamma) {
  const float p = k * (powf(nan_max(j, 1e-6f), -gamma) - 1.0f);
  return vol * j * p;
}

__device__ __forceinline__ float det3(const float A[9]) {
  return A[0] * (A[4] * A[8] - A[5] * A[7]) - A[1] * (A[3] * A[8] - A[5] * A[6]) +
         A[2] * (A[3] * A[7] - A[4] * A[6]);
}

}  // namespace mpm
