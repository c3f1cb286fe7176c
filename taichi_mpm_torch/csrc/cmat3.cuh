// 3x3 matrix helpers of the material code, per particle: the device
// counterpart of taichi_mpm_torch/math/cmat3.py (itself the twin of the
// JAX package's math/cmat3.py). A matrix is a row-major float[9]. Each
// function keeps the formula and the order of operations of the Python
// one, so the kernels agree with their plain twins to rounding: nvcc
// contracts a * b + c into one fused multiply-add where the twin rounds
// twice, and CUDA's logf, expf and powf may round otherwise than the
// host's libm (a few ulp).
//
// c_svd is the rotation-variant SVD of the reference: F^T F by 6 cyclic
// Jacobi sweeps over the pairs (0,1), (0,2), (1,2), the eigenvalues
// sorted descending by a three-swap network (strict <, so ties keep
// their order), V's last column flipped where det V < 0, and U by
// Gram-Schmidt on F V with the n > 1e-12 fallbacks.
//
// The rotation's 1/sqrt(1 + t^2) is 1.0f / sqrtf(...): IEEE square root
// and division, which the twin takes on every device (cmat3._rsqrt:
// torch.rsqrt on the CPU gives these bits); CUDA's rsqrtf, which
// torch.rsqrt is on the card, approximates it to 2 ulp. No
// --use_fast_math (ops/cuda_build.py).
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace mpm {

__device__ __forceinline__ void c_mm(const float A[9], const float B[9], float out[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
    }
  }
}

// A diag(s) B^T (c_mm(c_col_scale(A, s), c_mt(B)))
__device__ __forceinline__ void c_usvt(const float A[9], const float s[3], const float B[9],
                                       float out[9]) {
  float As[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) As[3 * i + k] = A[3 * i + k] * s[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] = As[3 * i] * B[3 * j] + As[3 * i + 1] * B[3 * j + 1] +
                       As[3 * i + 2] * B[3 * j + 2];
    }
  }
}

// A B^T (c_mm(A, c_mt(B)))
__device__ __forceinline__ void c_mmt(const float A[9], const float B[9], float out[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] +
                       A[3 * i + 2] * B[3 * j + 2];
    }
  }
}

__device__ __forceinline__ float c_fnorm2(const float A[9]) {
  float s = A[0] * A[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) s += A[k] * A[k];
  return s;
}

// A^{-T} = adj(A)^T / det, det clamped away from 0 as 1e-20 (keeping NaN)
__device__ __forceinline__ void c_inv_transpose(const float A[9], float out[9]) {
  const float a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5], g = A[6], h = A[7],
              i = A[8];
  out[0] = e * i - f * h;
  out[1] = f * g - d * i;
  out[2] = d * h - e * g;
  out[3] = c * h - b * i;
  out[4] = a * i - c * g;
  out[5] = b * g - a * h;
  out[6] = b * f - c * e;
  out[7] = c * d - a * f;
  out[8] = a * e - b * d;
  const float det = A[0] * out[0] + A[1] * out[1] + A[2] * out[2];
  const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = out[k] * inv_det;
}

// (c, s) of the Jacobi rotation that zeroes apq (cmat3._jacobi_rotation).
// sign(tau) is 0 at tau == 0 (torch.sign), where t = 1 then overrides it.
__device__ __forceinline__ void jacobi_rotation(float app, float aqq, float apq, float& c,
                                                float& s) {
  const bool trivial = fabsf(apq) < 1e-20f;
  const float safe_apq = trivial ? 1.0f : apq;
  const float tau = (aqq - app) / (2.0f * safe_apq);
  const float sgn = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : tau);  // keeps 0 and NaN
  float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  t = tau == 0.0f ? 1.0f : t;
  const float cc = 1.0f / sqrtf(1.0f + t * t);
  const float ss = t * cc;
  c = trivial ? 1.0f : cc;
  s = trivial ? 0.0f : ss;
}

// One Jacobi rotation on the pair (p, q) of the symmetric matrix held as
// its diagonal d[3] and off-diagonal o[3] = (a01, a02, a12), and on the
// eigenvector columns v[col][row] (cmat3.c_symmetric_eig's loop body).
template <int P, int Q>
__device__ __forceinline__ void jacobi_pair(float d[3], float o[3], float v[3][3]) {
  constexpr int R = 3 - P - Q;
  // index into o of the off-diagonal pair (i, j)
  constexpr int OPQ = P + Q - 1, ORP = R + P - 1, ORQ = R + Q - 1;
  const float app = d[P], aqq = d[Q], apq = o[OPQ];
  float c, s;
  jacobi_rotation(app, aqq, apq, c, s);
  const float arp = o[ORP], arq = o[ORQ];
  const float cc = c * c, ss = s * s, cs = c * s;
  d[P] = cc * app - 2.0f * cs * apq + ss * aqq;
  d[Q] = ss * app + 2.0f * cs * apq + cc * aqq;
  o[OPQ] = 0.0f;
  o[ORP] = c * arp - s * arq;
  o[ORQ] = s * arp + c * arq;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vp = v[P][i], vq = v[Q][i];
    v[P][i] = c * vp - s * vq;
    v[Q][i] = s * vp + c * vq;
  }
}

// the conditional swap of the sort network: column i before j when e[i] < e[j]
template <int I, int J>
__device__ __forceinline__ void cswap(float e[3], float v[3][3]) {
  const bool swap = e[I] < e[J];
  const float ei = e[I], ej = e[J];
  e[I] = swap ? ej : ei;
  e[J] = swap ? ei : ej;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float ci = v[I][r], cj = v[J][r];
    v[I][r] = swap ? cj : ci;
    v[J][r] = swap ? ci : cj;
  }
}

// x / max(|x|, 1e-12) per component; returns |x| (cmat3._normalize3)
__device__ __forceinline__ float normalize3(const float x[3], float u[3]) {
  const float n = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
  const float inv = 1.0f / nan_max(n, 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) u[k] = x[k] * inv;
  return n;
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// F = U diag(s) V^T with U, V rotations, s0 >= s1 >= |s2| and
// sign(s2) = sign(det F) (cmat3.c_svd).
__device__ __forceinline__ void c_svd(const float F[9], float U[9], float s[3], float V[9]) {
  // F^T F: its diagonal and (a01, a02, a12)
  float d[3], o[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = F[i] * F[i] + F[3 + i] * F[3 + i] + F[6 + i] * F[6 + i];
  o[0] = F[0] * F[1] + F[3] * F[4] + F[6] * F[7];
  o[1] = F[0] * F[2] + F[3] * F[5] + F[6] * F[8];
  o[2] = F[1] * F[2] + F[4] * F[5] + F[7] * F[8];
  float v[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};  // columns
#pragma unroll 1
  for (int sweep = 0; sweep < 6; ++sweep) {
    jacobi_pair<0, 1>(d, o, v);
    jacobi_pair<0, 2>(d, o, v);
    jacobi_pair<1, 2>(d, o, v);
  }
  cswap<0, 1>(d, v);
  cswap<0, 2>(d, v);
  cswap<1, 2>(d, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) V[3 * i + k] = v[k][i];
  }
  const float flip = det3(V) < 0.0f ? -1.0f : 1.0f;
  V[2] = V[2] * flip;
  V[5] = V[5] * flip;
  V[8] = V[8] * flip;

  float B[9];
  c_mm(F, V, B);  // columns b_k = F v_k
  const float b0[3] = {B[0], B[3], B[6]}, b1[3] = {B[1], B[4], B[7]};
  float u0[3], u1[3], u2[3];
  const float n0 = normalize3(b0, u0);
  const bool ok0 = n0 > 1e-12f;
  u0[0] = ok0 ? u0[0] : 1.0f;
  u0[1] = ok0 ? u0[1] : 0.0f;
  u0[2] = ok0 ? u0[2] : 0.0f;
  const float dot01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2];
  float b1p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) b1p[k] = b1[k] - dot01 * u0[k];
  const float n1 = normalize3(b1p, u1);
  // fallback: a unit vector orthogonal to u0
  const bool big1 = fabsf(u0[1]) > 0.9f;
  const float alt[3] = {0.0f, big1 ? 0.0f : 1.0f, big1 ? 1.0f : 0.0f};
  float cr[3], fb1[3];
  cross3(u0, alt, cr);
  normalize3(cr, fb1);
  const bool ok1 = n1 > 1e-12f;
#pragma unroll
  for (int k = 0; k < 3; ++k) u1[k] = ok1 ? u1[k] : fb1[k];
  cross3(u0, u1, u2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    U[3 * k] = u0[k];
    U[3 * k + 1] = u1[k];
    U[3 * k + 2] = u2[k];
  }
  s[0] = u0[0] * B[0] + u0[1] * B[3] + u0[2] * B[6];
  s[1] = u1[0] * B[1] + u1[1] * B[4] + u1[2] * B[7];
  s[2] = u2[0] * B[2] + u2[1] * B[5] + u2[2] * B[8];
}

}  // namespace mpm
