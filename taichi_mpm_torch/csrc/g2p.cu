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
// (materials.cuh, any of the eight: F <- cdg F for jelly, elastic and
// linear; WATER F unchanged, aux = max(aux * (tr cdg - 2), 0.1), an event
// when aux > 1; the SVD-based maps of snow, sand, von Mises and visco,
// sand and von Mises counting their plastic events),
// x += dt*v clamped to [0, (res - clamp_eps)*dx], and the NaN scrub (a
// lane whose new x, v or F is not finite is deactivated and reset:
// x = v = C = 0, F = I, aux kept). Rows 0-14 (F of all but water lanes,
// and of any lane the scrub resets), 15-23, 24 (snow, water, sand, visco)
// and 36 are written. A lane whose row 36 is 0 passes through untouched.
// Per CUDA block it writes the partial max |v| over lanes still active
// and the partial plasticity count; the wrapper reduces them.
//
// g2p_blocked_launch replaces the TPU kernel
// taichi_mpm_tpu/ops/g2p_pallas.py g2p_blocked: the gather only, written
// to a (12, Pw) output, rows v (3) and B row-major (9) (the TPU form's
// four zero pad rows are dropped). It reads x and the origin rows
// straight from the state (the TPU kernel takes them as a separate
// block-local position operand) and does not look at row 36, as the TPU
// kernel does not. One thread per lane, gathering through L1.
//
// What bounds them on the H100: at 8M particles the fused kernel reads
// the active row of every lane, 15 state rows (x, origin, F) plus the
// material row and the key of each active lane, writes 24 rows (x, v, F,
// C), and reads the windows once (K * 4 KB, ~0.12 GB): ~1.4 GB, 0.42 ms
// at 3.35 TB/s, against ~1 kflop per particle (0.12 ms at 67 TFLOP/s).
// The gather alone reads the key and 6 rows of each lane and writes 12
// rows (~76 B per lane) plus the windows: ~0.7 GB, ~0.2 ms. Both are
// bound by the memory rate. One thread per lane, so every row access is
// coalesced across the warp. There is no run-walk loop: each thread reads
// its own key, so unsorted keys cannot hang them (the TPU kernels' run
// walk needs sorted keys).
//
// g2p_fused, one CUDA block of THREADS lanes (the TPU kernel prefetched
// the first windows of its 512-lane chunk into VMEM; here:)
// 1. Each lane issues the loads of its active row, key and state rows (x,
//    origin, F, and aux and row 47 where the material set needs them) at
//    once, so that they are in flight while the block stages its windows.
// 2. The smallest slot key lo among the block's active lanes (a block
//    reduction, as is the largest, hi) names up to STAGED windows, slots
//    [lo, min(hi + 1, lo + STAGED)), which the block copies into shared
//    memory with the three channels of a node interleaved: one 16-byte
//    shared load per support node where the device-memory gather makes
//    three scalar loads through L1. The keys of the main path are sorted,
//    so a block's lanes fall in one to three slots (a slot holds ~390
//    lanes at 8M, ~190 in the dam).
// 3. A lane whose slot is staged gathers from shared memory; any other (a
//    block spanning more slots, unsorted keys) gathers from device memory
//    as g2p_blocked does. Both paths run one gather body (gather_support)
//    on the same values, so a lane sums the same terms in the same order
//    either way: the bits do not depend on the path, or on the order of
//    the keys.
// 4. The finish; a water lane stores F only where the scrub resets it
//    (its F is otherwise unchanged). The return maps of snow, sand and
//    von Mises run one SVD (cmat3.cuh), visco two and a polar Newton
//    iteration: ~1.3 and ~3.4 kflop per lane against the ~0.8 kflop of
//    the gather, which makes visco's the one instantiation bound by
//    operations (chip_smoke.py counts both). Without fast math each IEEE
//    division or square root is a sequence of instructions, so the SMs
//    issue more than the flop count says: 1,625 SASS instructions a jelly
//    lane, 3,581-3,772 a snow, von Mises or sand lane, 7,473 a visco lane
//    (tools/sass_count.py), issue floors of 0.39, 0.86-0.90 and 1.79 ms at
//    8M and 1.98 GHz. On an H100 (NVIDIA H100 80GB HBM3, 700 W, PERF.md)
//    at 8M they take 1.19-1.38 ms (64 registers) and 3.45 ms (93
//    registers) against jelly's 0.59: 66% and 52% of the issue rate.
// A window's nodes stay in the dense 49 i + 7 j + k order: lanes in the
// seeded lattice order read the same or neighbouring nodes at a time, and
// random positions defeat any fixed layout. Blocks of 128 lanes with 22 KB
// of shared memory and at most 63 registers let 8-9 blocks reside on an SM
// under the largest shared-memory carveout, which the launch asks for.
// What limits it now is the row stream for the builds without an SVD: at
// 8M the kernel takes ~1.16x the time of its rows alone with v = B = 0,
// and the staged gather alone about two thirds of that
// (tools/g2p_variants.py, PERF.md); for the return maps with an SVD, the
// issue rate of their dependent chains. Splitting the block into a gather
// warpgroup and a return-map warpgroup with their own register budgets
// (setmaxnreg; tools/g2p_split.cu) was slower on every such build at 8M:
// the register file holds as many warps either way, and the gather, now
// half of them, took 0.96 ms alone (sand 1.81 against 1.38 ms, visco
// 4.03-4.08 against 3.27-3.49; PERF.md).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "materials.cuh"

// One library per material set, as in p2g.cu: -DTMT_MATS=<set> compiles
// g2p_fused for that set alone, TMT_MATS=0 the material-free g2p_blocked.
#ifndef TMT_MATS
#define TMT_MATS 0
#endif
constexpr int WRONG_LIBRARY = -1;

namespace {

using namespace mpm;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// windows of a g2p_fused block staged in shared memory (5,488 B each)
constexpr int STAGED = 4;
// g2p_fused's shared-memory carveout: the largest, i.e. the least L1, so
// that 8-9 blocks reside whatever STAGED is (at the CUDA default, 2
// windows or 256 lanes ran 0.69 ms at 8M against 0.58; PERF.md)
constexpr int CARVEOUT = cudaSharedmemCarveoutMaxShared;

struct G2PParams {
  float dt;
  float inv_dx;
  float k_cdg;  // invD * dt * inv_dx
  float sym_w;  // 1 - rpic_damping
  float skew_w; // 1 - apic_damping
  float hi[3];  // (res - clamp_eps) * dx
  int apic;
};

// The gather of one lane at block-local position pos (grid units) over its
// 27 support nodes; fetch(idx, g) gives the three channels of window node
// idx. Every path of both kernels runs this body.
template <class Fetch>
__device__ __forceinline__ void gather_support(const float pos[3], Fetch fetch, float v[3],
                                               float B[9]) {
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
        float g[3];
        fetch(idx, g);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float wg = wn * g[c];
          v[c] += wg;
#pragma unroll
          for (int a = 0; a < 3; ++a) B[3 * c + a] += wg * d[a];
        }
      }
    }
  }
}

// The gather from slot `slot`'s window in device memory; v and B stay
// zero for a slot outside [0, K).
__device__ __forceinline__ void gather_window(const float pos[3], int slot,
                                              const float* __restrict__ win, int K,
                                              float v[3], float B[9]) {
  if (slot < 0 || slot >= K) return;
  const float* W = win + (size_t)slot * 3 * TILE_NODES;
  gather_support(
      pos,
      [&](int idx, float g[3]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) g[c] = __ldg(W + c * TILE_NODES + idx);
      },
      v, B);
}

// The state rows the finish reads besides x and the origin: F, and
// where the material set needs them aux (snow, water, sand, visco), the
// parameter slots of its return maps (materials.cuh) and row 47.
template <int MATS>
struct FinishRows {
  static constexpr bool kAux = (MATS & PLAST_AUX) != 0;
  static constexpr int kPar = plast_param_slots<MATS>();
  static constexpr bool kMixed = !single_material<MATS>();
  float F[9];
  float aux = 0.0f;
  float par[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float matf = 0.0f;

  template <class Load>
  __device__ __forceinline__ void load(Load ld) {
#pragma unroll
    for (int k = 0; k < 9; ++k) F[k] = ld(RF + k);
    if (kAux) aux = ld(RAUX);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if ((kPar >> k) & 1) par[k] = ld(RPAR + k);
    }
    if (kMixed) matf = ld(RMATF);
  }
};

// MATS: the scene's materials as a bit set (1 << id). A scene of one
// material compiles its return map alone and never reads row 47.
template <int MATS>
__global__ void __launch_bounds__(THREADS)
g2p_kernel(float* __restrict__ st, long long pw, const int* __restrict__ keys,
           const float* __restrict__ win, int K, float* __restrict__ vmax_part,
           int* __restrict__ plast_part, G2PParams prm) {
  __shared__ float4 staged[STAGED > 0 ? STAGED * TILE_NODES : 1];
  __shared__ int kmin_w[WARPS], kmax_w[WARPS];
  __shared__ float smax[WARPS];
  __shared__ int scnt[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool in = p < pw;
  float* S = st + (in ? p : 0);  // this lane's column: row r at S[r * pw]
  auto ld = [&](int r) { return S[(long long)r * pw]; };
  auto put = [&](int r, float value) { S[(long long)r * pw] = value; };

  // 1. this lane's loads, all issued before the block waits
  bool active = false;
  int slot = K;
  float x[3] = {0.0f, 0.0f, 0.0f}, org[3] = {0.0f, 0.0f, 0.0f};
  FinishRows<MATS> rows;
  if (in) {
    active = ld(RACT) > 0.5f;
    slot = keys[p];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[a] = ld(RX + a);
      org[a] = ld(RORG + a);
    }
    rows.load(ld);  // in flight while the block stages its windows
  }

  // 2. the block's staged windows: slots [lo, lo + n)
  const bool keyed = active && slot >= 0 && slot < K;
  const int kmin = __reduce_min_sync(0xffffffffu, keyed ? slot : INT_MAX);
  const int kmax = __reduce_max_sync(0xffffffffu, keyed ? slot : -1);
  if (lane == 0) {
    kmin_w[warp] = kmin;
    kmax_w[warp] = kmax;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    lo = min(lo, kmin_w[i]);
    hi = max(hi, kmax_w[i]);
  }
  const int n = hi < lo ? 0 : min(hi - lo + 1, STAGED);
  for (int i = threadIdx.x; i < n * TILE_NODES; i += THREADS) {
    const int w = i / TILE_NODES, node = i - w * TILE_NODES;
    const float* W = win + (size_t)(lo + w) * 3 * TILE_NODES + node;
    staged[i] = make_float4(__ldg(W), __ldg(W + TILE_NODES), __ldg(W + 2 * TILE_NODES), 0.0f);
  }
  __syncthreads();

  float vmax = 0.0f;
  int count = 0;
  if (active) {
    float pos[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) pos[a] = __fmul_rn(x[a], prm.inv_dx) - org[a];  // as in p2g.cu
    float v[3] = {0.0f, 0.0f, 0.0f};
    float B[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    // 3. the gather: from shared memory where the slot is staged
    if (slot >= lo && slot - lo < n) {
      const float4* W = staged + (slot - lo) * TILE_NODES;
      gather_support(
          pos,
          [&](int idx, float g[3]) {
            const float4 q = W[idx];
            g[0] = q.x;
            g[1] = q.y;
            g[2] = q.z;
          },
          v, B);
    } else {
      gather_window(pos, slot, win, K, v, B);
    }

    // 4. the finish (fused_pallas._finish_tile, same formulas and order)
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
    // the return map of the lane's material (materials.cuh); what it
    // writes back: F (all but water), aux (snow, water, sand, visco)
    Plastic pl;
    bool write_F = true, write_aux = false;
    dispatch<MATS>(single_material<MATS>() ? 0 : (int)rows.matf, [&](auto mat) {
      constexpr int M = decltype(mat)::id;
      material_plasticity<M>(rows.F, cdg, rows.aux, rows.par, prm.dt, pl);
      write_F = M != WATER;
      write_aux = ((PLAST_AUX >> M) & 1) != 0;
    });
    const float* Fn = pl.F;
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
        put(RX + a, xn[a]);
        put(RV + a, v[a]);
        vmax = fmaxf(vmax, fabsf(v[a]));
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) put(RC + k, Cn[k]);
      if (write_aux) put(RAUX, pl.aux);
      if (write_F) {
#pragma unroll
        for (int k = 0; k < 9; ++k) put(RF + k, Fn[k]);
      }
      count = pl.count;
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        put(RX + a, 0.0f);
        put(RV + a, 0.0f);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        put(RF + k, (k % 4 == 0) ? 1.0f : 0.0f);
        put(RC + k, 0.0f);
      }
      put(RACT, 0.0f);
    }
  }

  // block partials: max |v| (lanes still active) and the plasticity count
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if (lane == 0) {
    smax[warp] = vmax;
    scnt[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = smax[0];
    int c = scnt[0];
    for (int i = 1; i < WARPS; ++i) {
      m = fmaxf(m, smax[i]);
      c += scnt[i];
    }
    vmax_part[blockIdx.x] = m;
    plast_part[blockIdx.x] = c;
  }
}

#if TMT_MATS == 0
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
#endif

template <int MATS>
cudaError_t launch_fused(int blocks, cudaStream_t s, float* st, long long pw, const int* keys,
                         const float* win, int K, float* vmax_part, int* plast_part,
                         const G2PParams& prm) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      g2p_kernel<MATS>, cudaFuncAttributePreferredSharedMemoryCarveout, CARVEOUT);
  if (carveout != cudaSuccess) return carveout;
  g2p_kernel<MATS><<<blocks, THREADS, 0, s>>>(st, pw, keys, win, K, vmax_part, plast_part, prm);
  return cudaGetLastError();
}

}  // namespace


extern "C" int g2p_blocks(long long pw) { return (int)((pw + THREADS - 1) / THREADS); }

// The shape of a g2p_fused block: lanes per block and windows staged.
extern "C" int g2p_block_lanes() { return THREADS; }
extern "C" int g2p_staged_windows() { return STAGED; }

// Launch on `stream`. st: (48, pw) f32 packed state, updated in place;
// keys: (pw,) i32 slot key per lane (K = none); win: (K, 3, 7, 7, 7) f32
// velocity windows; vmax_part/plast_part: (g2p_blocks(pw),) block partials;
// mats: the scene's materials as a bit set, which must be TMT_MATS.
// Returns cudaGetLastError(), or WRONG_LIBRARY.
extern "C" int g2p_fused_launch(float* st, long long pw, const int* keys, const float* win,
                                int K, float* vmax_part, int* plast_part, float dt,
                                float inv_dx, float k_cdg, float sym_w, float skew_w,
                                float hi0, float hi1, float hi2, int apic, int mats,
                                void* stream) {
#if TMT_MATS != 0
  if (mats != TMT_MATS) return WRONG_LIBRARY;
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
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_fused<TMT_MATS>(blocks, static_cast<cudaStream_t>(stream), st,
                                                 pw, keys, win, K, vmax_part, plast_part, prm));
#else
  return WRONG_LIBRARY;
#endif
}

// Launch on `stream`. st: (48, pw) f32 packed state (read only: rows 0-2
// and 43-45); keys: (pw,) i32 slot key per lane (K = none); win:
// (K, 3, 7, 7, 7) f32 velocity windows; out: (12, pw) f32 rows v (3) and
// B row-major (9). Returns cudaGetLastError(), or WRONG_LIBRARY outside
// the material-free library.
extern "C" int g2p_blocked_launch(const float* st, long long pw, const int* keys,
                                  const float* win, int K, float inv_dx, float* out,
                                  void* stream) {
#if TMT_MATS == 0
  const int blocks = g2p_blocks(pw);
  if (blocks > 0) {
    g2p_blocked_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        st, pw, keys, win, K, inv_dx, out);
  }
  return static_cast<int>(cudaGetLastError());
#else
  return WRONG_LIBRARY;
#endif
}
