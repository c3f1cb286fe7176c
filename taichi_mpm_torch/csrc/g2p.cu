// G2P for Hopper (sm_90a): the window gather, alone or fused with the finish.
//
// Both entry points gather, for every particle lane of the sorted packed
// (48, Pw) state,
//   v    = sum_n w_n gv_n
//   B_ca = sum_n w_n gv_n,c (pos_a - node_a)
// over the 3x3x3 quadratic support from its slot's 7^3 velocity window
// (pos = x * inv_dx - origin, the block-local position from rows 0-2 and
// 43-45). A lane whose slot key is K (no slot: inactive lanes, or a
// page-map overflow) gathers v = B = 0.
//
// g2p_fused_launch replaces the TPU kernel
// taichi_mpm_tpu/ops/fused_pallas.py g2p_fused (_g2p_fused_kernel,
// _finish_tile, with g2p_pallas.window_accum): after the gather it runs
// the resample tail in place: APIC/RPIC damping -> C,
// cdg = I - invD*dt*inv_dx*B, the return map of the lane's material
// (row 47: JELLY F <- cdg F with no plastic events; WATER F unchanged,
// aux = max(aux * (tr cdg - 2), 0.1), an event when aux > 1),
// x += dt*v clamped to [0, (res - clamp_eps)*dx], and the NaN scrub (a
// lane whose new x, v or F is not finite is deactivated and reset:
// x = v = C = 0, F = I, aux kept). Rows 0-24 and 36 are written. A lane
// whose row 36 is 0 passes through untouched. Per CUDA block it writes
// the partial max |v| over lanes still active and the partial
// plasticity count; the wrapper reduces them.
//
// g2p_blocked_launch replaces the TPU kernel
// taichi_mpm_tpu/ops/g2p_pallas.py g2p_blocked: the gather only, written
// to a (12, Pw) output, rows v (3) and B row-major (9) (the TPU form's
// four zero pad rows are dropped). It reads x and the origin rows
// straight from the state (the TPU kernel takes them as a separate
// block-local position operand) and does not look at row 36, as the TPU
// kernel does not.
//
// What bounds them on the H100: at 8M particles the fused kernel reads
// the active row of every lane, 15 state rows (x, origin, F) plus the
// material row and the key of each active lane, writes 24 rows (x, v, F,
// C), and reads the windows once (K * 4 KB, ~0.12 GB): ~1.4 GB, 0.43 ms
// at 3.35 TB/s, against ~1 kflop per particle (0.12 ms at 67 TFLOP/s).
// The gather alone reads the key and 6 rows of each lane and writes 12
// rows (~76 B per lane) plus the windows: ~0.7 GB, ~0.2 ms. Both are
// bound by the memory rate. What the design does about it: one thread per
// lane, so every row access is coalesced across the warp, and
// neighbouring lanes share a slot, so a window is fetched from device
// memory about once and served from L1/L2 after. There is no run-walk
// loop: each thread reads its own key, so unsorted keys cannot hang it
// (the TPU kernels' run walk needs sorted keys).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace mpm;

constexpr int THREADS = 256;

struct G2PParams {
  float dt;
  float inv_dx;
  float k_cdg;  // invD * dt * inv_dx
  float sym_w;  // 1 - rpic_damping
  float skew_w; // 1 - apic_damping
  float hi[3];  // (res - clamp_eps) * dx
  int apic;
};

// The window gather of one lane at block-local position pos (grid units)
// from slot `slot`'s window; v and B stay zero for a slot outside [0, K).
__device__ __forceinline__ void gather_window(const float pos[3], int slot,
                                              const float* __restrict__ win, int K,
                                              float v[3], float B[9]) {
  if (slot < 0 || slot >= K) return;
  const float* W = win + (size_t)slot * 3 * TILE_NODES;
  int base[3];
  float w[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // first node of the support; clamped so a non-finite position cannot
    // make an undefined float-to-int conversion
    const float b = fminf(fmaxf(floorf(pos[a] - 0.5f), -2.0f), 7.0f);
    base[a] = (int)b;
#pragma unroll
    for (int d = 0; d < 3; ++d) w[a][d] = quad_w(pos[a] - (b + (float)d));
  }
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int ix = base[0] + di + 1;  // tile index = node + 1
    if (ix < 0 || ix >= TILE) continue;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int iy = base[1] + dj + 1;
      if (iy < 0 || iy >= TILE) continue;
#pragma unroll
      for (int dk = 0; dk < 3; ++dk) {
        const int iz = base[2] + dk + 1;
        if (iz < 0 || iz >= TILE) continue;
        const float wn = w[0][di] * w[1][dj] * w[2][dk];
        const int idx = (ix * TILE + iy) * TILE + iz;
        const float d[3] = {pos[0] - (float)(ix - 1), pos[1] - (float)(iy - 1),
                            pos[2] - (float)(iz - 1)};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float wg = wn * __ldg(W + c * TILE_NODES + idx);
          v[c] += wg;
#pragma unroll
          for (int a = 0; a < 3; ++a) B[3 * c + a] += wg * d[a];
        }
      }
    }
  }
}

// MATS: the scene's materials as a bit set (1 << id). A scene of one
// material compiles its return map alone and never reads row 47.
template <int MATS>
__global__ void __launch_bounds__(THREADS)
g2p_kernel(float* __restrict__ st, long long pw, const int* __restrict__ keys,
           const float* __restrict__ win, int K, float* __restrict__ vmax_part,
           int* __restrict__ plast_part, G2PParams prm) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  float vmax = 0.0f;
  int count = 0;
  if (p < pw && st[(long long)RACT * pw + p] > 0.5f) {
    float* S = st + p;
    auto R = [&](int r) -> float& { return S[(long long)r * pw]; };
    float x[3], pos[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[a] = R(RX + a);
      pos[a] = __fmul_rn(x[a], prm.inv_dx) - R(RORG + a);  // as in p2g.cu
    }
    float v[3] = {0.0f, 0.0f, 0.0f};
    float B[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    gather_window(pos, keys[p], win, K, v, B);

    // -- finish (fused_pallas._finish_tile, same formulas and order) --
    float Cn[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float bij = B[3 * i + j], bji = B[3 * j + i];
        const float s = 0.5f * (bij + bji);
        Cn[3 * i + j] = prm.apic ? prm.sym_w * s + prm.skew_w * (bij - s) : 0.0f;
      }
    }
    float cdg[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) cdg[k] = ((k % 4 == 0) ? 1.0f : 0.0f) - prm.k_cdg * B[k];
    float F[9], Fn[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) F[k] = R(RF + k);
    const bool water = MATS == (1 << WATER) ||
                       (MATS != (1 << JELLY) && (int)R(RMATF) == WATER);
    float aux_new = 0.0f;
    if (water) {
      // cforms.plast_water: F unchanged, j = max(aux (tr cdg - 2), 0.1)
      aux_new = nan_max(R(RAUX) * (cdg[0] + cdg[4] + cdg[8] - 2.0f), 0.1f);
#pragma unroll
      for (int k = 0; k < 9; ++k) Fn[k] = F[k];
    } else {
      // JELLY (cforms.plast_elastic): F <- cdg F
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          Fn[3 * i + j] =
              cdg[3 * i] * F[j] + cdg[3 * i + 1] * F[3 + j] + cdg[3 * i + 2] * F[6 + j];
        }
      }
    }
    float xn[3];
    bool finite = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xn[a] = nan_clip(x[a] + __fmul_rn(prm.dt, v[a]), 0.0f, prm.hi[a]);
      finite = finite && isfinite(xn[a]) && isfinite(v[a]);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) finite = finite && isfinite(Fn[k]);

    if (finite) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        R(RX + a) = xn[a];
        R(RV + a) = v[a];
        vmax = fmaxf(vmax, fabsf(v[a]));
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        R(RF + k) = Fn[k];
        R(RC + k) = Cn[k];
      }
      if (water) {
        R(RAUX) = aux_new;
        count = aux_new > 1.0f ? 1 : 0;
      }
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        R(RX + a) = 0.0f;
        R(RV + a) = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        R(RF + k) = (k % 4 == 0) ? 1.0f : 0.0f;
        R(RC + k) = 0.0f;
      }
      R(RACT) = 0.0f;
    }
  }

  // block partials: max |v| (lanes still active) and the plasticity count
  __shared__ float smax[THREADS / 32];
  __shared__ int scnt[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smax[warp] = vmax;
    scnt[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = smax[0];
    int c = scnt[0];
    for (int i = 1; i < THREADS / 32; ++i) {
      m = fmaxf(m, smax[i]);
      c += scnt[i];
    }
    vmax_part[blockIdx.x] = m;
    plast_part[blockIdx.x] = c;
  }
}

__global__ void __launch_bounds__(THREADS)
g2p_blocked_kernel(const float* __restrict__ st, long long pw, const int* __restrict__ keys,
                   const float* __restrict__ win, int K, float inv_dx, float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= pw) return;
  float v[3] = {0.0f, 0.0f, 0.0f};
  float B[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int slot = keys[p];
  if (slot >= 0 && slot < K) {
    float pos[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pos[a] = __fmul_rn(st[(long long)(RX + a) * pw + p], inv_dx) -
               st[(long long)(RORG + a) * pw + p];  // as in p2g.cu
    }
    gather_window(pos, slot, win, K, v, B);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[(long long)c * pw + p] = v[c];
#pragma unroll
  for (int k = 0; k < 9; ++k) out[(long long)(3 + k) * pw + p] = B[k];
}

}  // namespace

extern "C" int g2p_blocks(long long pw) { return (int)((pw + THREADS - 1) / THREADS); }

// Launch on `stream`. st: (48, pw) f32 packed state, updated in place;
// keys: (pw,) i32 slot key per lane (K = none); win: (K, 3, 7, 7, 7) f32
// velocity windows; vmax_part/plast_part: (g2p_blocks(pw),) block partials;
// mats: the scene's materials as a bit set (JELLY and/or WATER).
// Returns cudaGetLastError().
extern "C" int g2p_fused_launch(float* st, long long pw, const int* keys, const float* win,
                                int K, float* vmax_part, int* plast_part, float dt,
                                float inv_dx, float k_cdg, float sym_w, float skew_w,
                                float hi0, float hi1, float hi2, int apic, int mats,
                                void* stream) {
  G2PParams prm;
  prm.dt = dt;
  prm.inv_dx = inv_dx;
  prm.k_cdg = k_cdg;
  prm.sym_w = sym_w;
  prm.skew_w = skew_w;
  prm.hi[0] = hi0;
  prm.hi[1] = hi1;
  prm.hi[2] = hi2;
  prm.apic = apic;
  const int blocks = g2p_blocks(pw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    if (mats == (1 << JELLY)) {
      g2p_kernel<(1 << JELLY)><<<blocks, THREADS, 0, s>>>(st, pw, keys, win, K, vmax_part,
                                                         plast_part, prm);
    } else if (mats == (1 << WATER)) {
      g2p_kernel<(1 << WATER)><<<blocks, THREADS, 0, s>>>(st, pw, keys, win, K, vmax_part,
                                                         plast_part, prm);
    } else {
      g2p_kernel<(1 << JELLY) | (1 << WATER)><<<blocks, THREADS, 0, s>>>(
          st, pw, keys, win, K, vmax_part, plast_part, prm);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`. st: (48, pw) f32 packed state (read only: rows 0-2
// and 43-45); keys: (pw,) i32 slot key per lane (K = none); win:
// (K, 3, 7, 7, 7) f32 velocity windows; out: (12, pw) f32 rows v (3) and
// B row-major (9). Returns cudaGetLastError().
extern "C" int g2p_blocked_launch(const float* st, long long pw, const int* keys,
                                  const float* win, int K, float inv_dx, float* out,
                                  void* stream) {
  const int blocks = g2p_blocks(pw);
  if (blocks > 0) {
    g2p_blocked_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        st, pw, keys, win, K, inv_dx, out);
  }
  return static_cast<int>(cudaGetLastError());
}
