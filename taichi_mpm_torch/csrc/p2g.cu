// P2G for Hopper (sm_90a): two entry points over one node-accumulation
// stage.
//
// p2g_fused_launch (fused prep + P2G) replaces the TPU kernel
// taichi_mpm_tpu/ops/fused_pallas.py p2g_fused
// (_p2g_fused_kernel, _build_pd, with p2g_pallas._chunk_ops and
// tile_correct): for each active block slot, build every particle's P2G
// operand from the packed (48, Pw) state (m*v, m, the fused affine
// A = invD*m*C - invD*inv_dx*dt*force with the JELLY fixed-corotated or
// the WATER equation-of-state force; block-local position) and accumulate the slot's 7^3 halo tile of
// momentum and mass with quadratic B-spline weights.
//
// Semantics: tile node (i, j, k) is block-local node (i-1, j-1, k-1);
//   tile[c] += w * (m*v_c + sum_a A[c][a] * (pos_a - node_a))   c = 0..2
//   tile[3] += w * m
// where w is the tensor product of the dense per-axis weights over nodes
// -1..5 (a contribution outside the tile is dropped, as in the reference).
//
// The kernel is compiled for the scene's material set (MATS, a bit set
// 1 << id): a scene of one material reads only its own rows, and only a
// mixed scene reads row 47 to choose the force per particle.
//
// What bounds it on the H100: at 8M jelly particles the function reads 32
// of the 48 state rows of each particle once (act, x, v, F, C, mass, vol,
// mu, lambda, origin: ~1.02 GB; water reads aux instead of F) and
// writes K halo tiles of 5.5 KB (~0.16 GB), 0.35 ms at 3.35 TB/s; its
// ~1.8 kflop per particle (polar Newton, force, 27-node scatter) take
// 0.22 ms at 67 TFLOP/s. So the memory rate bounds
// it. What the design does about it: one CUDA block per slot streams
// the slot's contiguous sorted range [s, e) in coalesced 128-lane chunks,
// computes each particle once (one thread each) and stages the 16-value
// operand and 21 axis weights in shared memory, so the state is read
// exactly once. Then each thread owns fixed halo nodes (3 of the 343) and
// sums the staged particles in sorted order in registers. That order is
// fixed, so the kernel is deterministic: the same input gives the same
// bits, as in the reference. The node-owner loop visits every (node,
// particle) pair, 343 per particle where 27 carry weight, and skips zero
// weights: it is the simple form, not the fast one, and that loop, not
// memory, sets its time (chip_smoke.py prints it beside the bound).
//
// p2g_blocked_launch replaces the TPU kernels
// taichi_mpm_tpu/ops/p2g_pallas.py p2g_blocked and p2g_blocked_batched
// (the same function; the batched one takes 4 slots per program on the
// TPU, which a CUDA grid does not need): the same halo tiles, from a
// prebuilt (16, Pw) operand [m*v (3), m, A row-major (9), block-local
// pos (3)] (ops/p2g.prep_packed) instead of the state. A thread stages a
// particle by reading its 16 operand values and evaluating its 21 axis
// weights; the node-owner accumulation and the write are those of
// p2g_fused, so it is deterministic too. It reads 16 rows per particle in
// a slot range (~0.51 GB at 8M) and writes the live slots' tiles: bound by
// bytes (chip_smoke.py counts it), and set, as p2g_fused is, by the
// node-owner loop. It keeps none of the TPU form: no matmul fold of the
// weights into (112, 49) channels (_chunk_ops, tile_correct), no 512-lane
// chunked DMA, no bf16x3 split.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace mpm;

constexpr int THREADS = 128;  // one staged particle per thread
constexpr int NPT = 3;        // halo nodes per thread: 3 * 128 >= 343
constexpr int NV = 16;        // staged values: m*v (3), m, A (9), pos (3)
constexpr int NW = 24;        // staged weights: 7 per axis, padded to 24

struct P2GParams {
  float inv_dx;
  float invD;
  float cf_scale;  // invD * inv_dx * dt
  float gdt[3];    // gravity * dt, used when particle_gravity
  int particle_gravity;
};

// MATS: the scene's materials as a bit set (1 << id), as in g2p.cu.
template <int MATS>
__device__ __forceinline__ void stage_particle(const float* __restrict__ st, long long pw,
                                               long long p, const P2GParams& prm,
                                               float* __restrict__ sv,
                                               float* __restrict__ sw) {
  const float* S = st + p;
  auto R = [&](int r) { return S[(long long)r * pw]; };
  const bool act = R(RACT) > 0.5f;
  float C[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) C[k] = R(RC + k);
  const float mass = R(RMASS), vol = R(RVOL);
  const float k0 = R(RPAR), k1 = R(RPAR + 1);

  // force = -vol * P F^T of the particle's material (row 47 holds its id
  // as a value, read only in a mixed scene; the wrapper admits only the
  // materials handled here)
  const bool water = MATS == (1 << WATER) ||
                     (MATS != (1 << JELLY) && (int)R(RMATF) == WATER);
  float force[9];
  if (water) {
    // k = params[0], gamma = params[1], j = aux (cforms.force_water)
    const float diag = water_force_diag(R(RAUX), vol, k0, k1);
#pragma unroll
    for (int k = 0; k < 9; ++k) force[k] = (k % 4 == 0) ? diag : 0.0f;
  } else {
    // JELLY: -vol * [2 mu (F - R) F^T + lam (J - 1) J I], mu = params[0],
    // lam = params[1] (cforms.force_jelly / _pft_fixed_corotated)
    float F[9], Rm[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) F[k] = R(RF + k);
    polar_newton(F, Rm);
    const float J = det3(F);
    const float diag = k1 * (J - 1.0f) * J;
    const float two_mu = 2.0f * k0;
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
  float A[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    A[k] = act ? prm.invD * mass * C[k] - prm.cf_scale * force[k] : 0.0f;
  }
  const float m = act ? mass : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = R(RV + c);
    if (prm.particle_gravity) v += prm.gdt[c];
    sv[c] = m * v;
  }
  sv[3] = m;
#pragma unroll
  for (int k = 0; k < 9; ++k) sv[4 + k] = A[k];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // __fmul_rn: no FMA contraction, so the block-local position rounds
    // as in the plain version and the JAX reference (x * inv_dx, then
    // minus the origin); a fused multiply-add moves it by up to one ulp
    // of x * inv_dx (~4e-6 cells at res 125), ~1e-5 of a weight.
    const float pos = __fmul_rn(R(RX + a), prm.inv_dx) - R(RORG + a);
    sv[13 + a] = pos;
#pragma unroll
    for (int i = 0; i < TILE; ++i) sw[a * TILE + i] = quad_w(pos - (float)(i - 1));
  }
}

// How a thread stages one particle: the 16 operand values and the 21 axis
// weights. StageState builds them from the packed state (p2g_fused);
// StageOperand reads a prebuilt operand (p2g_blocked).
template <int MATS>
struct StageState {
  const float* __restrict__ st;
  P2GParams prm;
  __device__ __forceinline__ void operator()(long long pw, long long p, float* sv,
                                             float* sw) const {
    stage_particle<MATS>(st, pw, p, prm, sv, sw);
  }
};

struct StageOperand {
  const float* __restrict__ pd;
  __device__ __forceinline__ void operator()(long long pw, long long p, float* sv,
                                             float* sw) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) sv[k] = pd[(long long)k * pw + p];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = sv[13 + a];
#pragma unroll
      for (int i = 0; i < TILE; ++i) sw[a * TILE + i] = quad_w(pos - (float)(i - 1));
    }
  }
};

// One block per slot: stage the slot's sorted range [s, e) 128 particles
// at a time, each thread summing its own halo nodes in particle order.
template <class Stage>
__global__ void __launch_bounds__(THREADS)
p2g_kernel(Stage stage, long long pw, const int* __restrict__ s_arr,
           const int* __restrict__ e_arr, float* __restrict__ out) {
  __shared__ float sv[THREADS][NV];
  __shared__ float sw[THREADS][NW];
  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  // ranges clipped to the state, so a bad range reads nothing outside it
  const int s = max(s_arr[slot], 0);
  const int e = (int)min((long long)e_arr[slot], pw);

  int ni[NPT], nj[NPT], nk[NPT];
  bool own[NPT];
  float acc[NPT][4];
#pragma unroll
  for (int q = 0; q < NPT; ++q) {
    const int n = tid + q * THREADS;
    own[q] = n < TILE_NODES;
    const int nn = own[q] ? n : 0;
    ni[q] = nn / (TILE * TILE);
    nj[q] = (nn / TILE) % TILE;
    nk[q] = nn % TILE;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.0f;
  }

  for (int base = s; base < e; base += THREADS) {
    const int cnt = min(THREADS, e - base);
    if (tid < cnt) stage(pw, (long long)base + tid, sv[tid], sw[tid]);
    __syncthreads();
    for (int p = 0; p < cnt; ++p) {
      const float* w = sw[p];
      const float* v = sv[p];
#pragma unroll
      for (int q = 0; q < NPT; ++q) {
        const float wq = w[ni[q]] * w[TILE + nj[q]] * w[2 * TILE + nk[q]];
        if (own[q] && wq != 0.0f) {
          const float dx = v[13] - (float)(ni[q] - 1);
          const float dy = v[14] - (float)(nj[q] - 1);
          const float dz = v[15] - (float)(nk[q] - 1);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float mom = v[c] + v[4 + 3 * c] * dx + v[5 + 3 * c] * dy + v[6 + 3 * c] * dz;
            acc[q][c] += wq * mom;
          }
          acc[q][3] += wq * v[3];
        }
      }
    }
    __syncthreads();
  }

  float4* dst = reinterpret_cast<float4*>(out + (size_t)slot * TILE_NODES * 4);
#pragma unroll
  for (int q = 0; q < NPT; ++q) {
    if (own[q]) dst[tid + q * THREADS] = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
  }
}

}  // namespace

// Launch on `stream`. st: (48, pw) f32 packed state, rows 43-45 holding the
// sort-time block origins; s_arr/e_arr: (K,) i32 sorted particle ranges;
// out: (K, 7, 7, 7, 4) f32 halo tiles [i, j, k, c]; mats: the scene's
// materials as a bit set (JELLY and/or WATER). Returns cudaGetLastError().
extern "C" int p2g_fused_launch(const float* st, long long pw, const int* s_arr,
                                const int* e_arr, int K, float* out, float inv_dx,
                                float invD, float cf_scale, float gdt0, float gdt1,
                                float gdt2, int particle_gravity, int mats, void* stream) {
  P2GParams prm;
  prm.inv_dx = inv_dx;
  prm.invD = invD;
  prm.cf_scale = cf_scale;
  prm.gdt[0] = gdt0;
  prm.gdt[1] = gdt1;
  prm.gdt[2] = gdt2;
  prm.particle_gravity = particle_gravity;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 0) {
    if (mats == (1 << JELLY)) {
      p2g_kernel<<<K, THREADS, 0, s>>>(StageState<(1 << JELLY)>{st, prm}, pw, s_arr, e_arr,
                                       out);
    } else if (mats == (1 << WATER)) {
      p2g_kernel<<<K, THREADS, 0, s>>>(StageState<(1 << WATER)>{st, prm}, pw, s_arr, e_arr,
                                       out);
    } else {
      p2g_kernel<<<K, THREADS, 0, s>>>(StageState<(1 << JELLY) | (1 << WATER)>{st, prm}, pw,
                                       s_arr, e_arr, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`. pdata: (16, pw) f32 P2G operand [m*v (3), m, A
// row-major (9), block-local pos (3)]; s_arr/e_arr: (K,) i32 sorted
// particle ranges (s == e: an empty slot, zero tile); out: (K, 7, 7, 7, 4)
// f32 halo tiles [i, j, k, c]. Returns cudaGetLastError().
extern "C" int p2g_blocked_launch(const float* pdata, long long pw, const int* s_arr,
                                  const int* e_arr, int K, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 0) p2g_kernel<<<K, THREADS, 0, s>>>(StageOperand{pdata}, pw, s_arr, e_arr, out);
  return static_cast<int>(cudaGetLastError());
}
