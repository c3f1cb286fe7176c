// The return-map builds of g2p_fused split into a gather and a return-map
// warpgroup: the design measured against the port's g2p_kernel (one thread
// gathering and mapping each lane) by tools/g2p_variants.py svd. Not part
// of the port: nothing in taichi_mpm_torch calls it.
//
// It includes the port's g2p.cu (g2p_kernel's gather, finish and return
// maps, unchanged) and exports its own g2p_fused_launch, the port's being
// renamed, so that the variant tool loads it in place of the port's
// library. Build (one library per material set, as the port's):
//   nvcc <ops/cuda_build.NVCC_FLAGS> -DTMT_MATS=<set> \
//        -I taichi_mpm_torch/csrc -o g2p_split.so tools/g2p_split.cu
#define g2p_fused_launch g2p_kernel_launch
#include "g2p.cu"
#undef g2p_fused_launch

#include <algorithm>

#include "pipeline.cuh"

namespace {

// bar.sync on named barrier `id` (1-15; 0 is __syncthreads) for `threads`
// threads, whole warps.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The warpgroup's registers per thread from here on (a multiple of 8 in
// [24, 256]; sm_90a); every warp of the warpgroup runs the same one.
template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(REGS));
}

// g2p_kernel's finish of C from the gathered B (APIC/RPIC damping, or 0
// without APIC) and its NaN scrub, as it writes them inline.
__device__ __forceinline__ void finish_C(const float B[9], const G2PParams& prm, float Cn[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float bij = B[3 * i + j], bji = B[3 * j + i];
      const float s = 0.5f * (bij + bji);
      Cn[3 * i + j] = prm.apic ? prm.sym_w * s + prm.skew_w * (bij - s) : 0.0f;
    }
  }
}

template <class Put>
__device__ __forceinline__ void scrub(Put put) {
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

// The builds with an SVD in their return map (a material set with snow,
// sand, von Mises or visco) as a persistent block of one gather warpgroup
// and WS_MAPS return-map warpgroups, each with its own register budget
// (setmaxnreg). The block walks the tiles of THREADS lanes b, b + grid,
// ... (a tile is one CUDA block of g2p_kernel: the same lanes, the same
// staged windows, the same partials). For each tile the gather warpgroup
// (one thread per lane) does g2p_kernel's steps 1-3, forms C, cdg and the
// advected x, writes x, v and C of the lanes whose x and v are finite,
// and hands cdg, max |v| and the lane's flags to a map warpgroup through
// a ring of WS_STAGES stages in shared memory (tile i of the block: stage
// i % WS_STAGES, map warpgroup i % WS_MAPS). The map warpgroup loads the
// lane's F, aux and return-map parameters itself, runs the return map,
// writes F and aux, or resets the lane where the new F is not finite (x =
// v = C = 0, F = I, inactive, as g2p_kernel's scrub), and writes the
// tile's partials. Each lane's arithmetic is g2p_kernel's.
constexpr int WS_MAPS = 1;  // return-map warpgroups per block
constexpr int WS_THREADS = THREADS * (1 + WS_MAPS);
constexpr int WS_STAGES = 2 * WS_MAPS;
constexpr int NAMED_GATHER = 1;  // named barriers: the gather warpgroup's; map m's 2 + m

// Blocks per SM that the launch bounds ask for, and the registers per
// thread of the gather and of the map warpgroups; the kernel is compiled
// for kLaunch = 65536 / (WS_THREADS kMinBlocks) registers (rounded down to
// 8), which the warpgroups' budgets share out. Visco's two SVDs and polar
// iteration get the larger map budget.
template <int MATS>
struct WsBudget {
  static constexpr bool kVisco = has<MATS>(VISCO);
  static constexpr int kMinBlocks = kVisco ? 3 : 4;
  static constexpr int kGather = kVisco ? 56 : 48;
  static constexpr int kMap = kVisco ? 104 : 80;
  static constexpr int kLaunch = 65536 / (WS_THREADS * kMinBlocks) / 8 * 8;
  static_assert(kGather + WS_MAPS * kMap <= (1 + WS_MAPS) * kLaunch,
                "the warpgroups' registers exceed the block's");
};

// The state one gather thread loads for its lane of a tile.
struct GatherLane {
  bool in = false, active = false;
  int slot = 0;
  float x[3] = {0.0f, 0.0f, 0.0f}, org[3] = {0.0f, 0.0f, 0.0f};
};

template <int MATS>
__global__ void __launch_bounds__(WS_THREADS, WsBudget<MATS>::kMinBlocks)
g2p_ws_kernel(float* __restrict__ st, long long pw, const int* __restrict__ keys,
              const float* __restrict__ win, int K, float* __restrict__ vmax_part,
              int* __restrict__ plast_part, G2PParams prm, int tiles) {
  __shared__ float4 staged[STAGED * TILE_NODES];
  __shared__ int kmin_w[WARPS], kmax_w[WARPS];
  __shared__ float hand_cdg[WS_STAGES][9][THREADS];
  __shared__ float hand_vabs[WS_STAGES][THREADS];
  __shared__ int hand_flag[WS_STAGES][THREADS];  // 1: active, 2: x and v finite
  __shared__ float red_max[WS_MAPS][2][WARPS];
  __shared__ int red_cnt[WS_MAPS][2][WARPS];
  __shared__ unsigned long long full[WS_STAGES], empty[WS_STAGES];
  using Budget = WsBudget<MATS>;
  const int group = threadIdx.x / THREADS;  // 0: gather; 1 + m: return-map warpgroup m
  const int t = threadIdx.x % THREADS;
  const int lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x, grid = gridDim.x;
  const int n_local = b < tiles ? (tiles - 1 - b) / grid + 1 : 0;
  if (threadIdx.x < WS_STAGES) {
    mbar_init(&full[threadIdx.x], THREADS);
    mbar_init(&empty[threadIdx.x], THREADS);
  }
  fence_barrier_init();
  __syncthreads();

  if (group == 0) {
    regs_dec<Budget::kGather>();
    auto load = [&](int i) {
      GatherLane g;
      const long long p = (long long)(b + i * grid) * THREADS + t;
      g.in = p < pw;
      if (g.in) {
        const float* S = st + p;
        g.active = S[(long long)RACT * pw] > 0.5f;
        g.slot = keys[p];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          g.x[a] = S[(long long)(RX + a) * pw];
          g.org[a] = S[(long long)(RORG + a) * pw];
        }
      } else {
        g.slot = K;
      }
      return g;
    };
    GatherLane cur;
    if (n_local > 0) cur = load(0);
    for (int i = 0; i < n_local; ++i) {
      GatherLane nxt;
      if (i + 1 < n_local) nxt = load(i + 1);  // in flight while this tile runs
      const long long p = (long long)(b + i * grid) * THREADS + t;
      float* S = st + (cur.in ? p : 0);
      auto put = [&](int row, float value) { S[(long long)row * pw] = value; };

      // the staged windows, as in g2p_kernel
      const bool keyed = cur.active && cur.slot >= 0 && cur.slot < K;
      const int kmin = __reduce_min_sync(0xffffffffu, keyed ? cur.slot : INT_MAX);
      const int kmax = __reduce_max_sync(0xffffffffu, keyed ? cur.slot : -1);
      if (lane == 0) {
        kmin_w[warp] = kmin;
        kmax_w[warp] = kmax;
      }
      named_sync(NAMED_GATHER, THREADS);
      int lo = INT_MAX, hi = -1;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        lo = min(lo, kmin_w[w]);
        hi = max(hi, kmax_w[w]);
      }
      const int n = hi < lo ? 0 : min(hi - lo + 1, STAGED);
      for (int j = t; j < n * TILE_NODES; j += THREADS) {
        const int w = j / TILE_NODES, node = j - w * TILE_NODES;
        const float* W = win + (size_t)(lo + w) * 3 * TILE_NODES + node;
        staged[j] = make_float4(__ldg(W), __ldg(W + TILE_NODES), __ldg(W + 2 * TILE_NODES), 0.0f);
      }
      named_sync(NAMED_GATHER, THREADS);

      float cdg[9];
      float vabs = 0.0f;
      int flag = 0;
#pragma unroll
      for (int k = 0; k < 9; ++k) cdg[k] = (k % 4 == 0) ? 1.0f : 0.0f;
      if (cur.active) {
        float pos[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) pos[a] = __fmul_rn(cur.x[a], prm.inv_dx) - cur.org[a];
        float v[3] = {0.0f, 0.0f, 0.0f};
        float B[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (cur.slot >= lo && cur.slot - lo < n) {
          const float4* W = staged + (cur.slot - lo) * TILE_NODES;
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
          gather_window(pos, cur.slot, win, K, v, B);
        }
        float Cn[9];
        finish_C(B, prm, Cn);
#pragma unroll
        for (int k = 0; k < 9; ++k) cdg[k] = ((k % 4 == 0) ? 1.0f : 0.0f) - prm.k_cdg * B[k];
        float xn[3];
        bool finite = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          xn[a] = nan_clip(cur.x[a] + __fmul_rn(prm.dt, v[a]), 0.0f, prm.hi[a]);
          finite = finite && isfinite(xn[a]) && isfinite(v[a]);
        }
        flag = finite ? 3 : 1;
        if (finite) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            put(RX + a, xn[a]);
            put(RV + a, v[a]);
            vabs = fmaxf(vabs, fabsf(v[a]));
          }
#pragma unroll
          for (int k = 0; k < 9; ++k) put(RC + k, Cn[k]);
        }
      }

      const int q = i % WS_STAGES;
      if (i >= WS_STAGES) mbar_wait(&empty[q], (i / WS_STAGES - 1) & 1);
#pragma unroll
      for (int k = 0; k < 9; ++k) hand_cdg[q][k][t] = cdg[k];
      hand_vabs[q][t] = vabs;
      hand_flag[q][t] = flag;
      mbar_arrive(&full[q]);
      cur = nxt;
    }
  } else {
    regs_inc<Budget::kMap>();
    const int m = group - 1;
    for (int i = m; i < n_local; i += WS_MAPS) {
      const int tile = b + i * grid;
      const long long p = (long long)tile * THREADS + t;
      const bool in = p < pw;
      float* S = st + (in ? p : 0);
      auto ld = [&](int row) { return S[(long long)row * pw]; };
      auto put = [&](int row, float value) { S[(long long)row * pw] = value; };
      FinishRows<MATS> rows;
      if (in) rows.load(ld);  // in flight while the tile's gather runs

      const int q = i % WS_STAGES;
      mbar_wait(&full[q], (i / WS_STAGES) & 1);
      float cdg[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) cdg[k] = hand_cdg[q][k][t];
      const float vabs = hand_vabs[q][t];
      const int flag = hand_flag[q][t];
      if (i + WS_STAGES < n_local) mbar_arrive(&empty[q]);

      float vmax = 0.0f;
      int count = 0;
      if (flag & 1) {
        Plastic pl;
        bool store_F = true, store_aux = false;
        dispatch<MATS>(single_material<MATS>() ? 0 : (int)rows.matf, [&](auto mat) {
          constexpr int M = decltype(mat)::id;
          material_plasticity<M>(rows.F, cdg, rows.aux, rows.par, prm.dt, pl);
          store_F = M != WATER;
          store_aux = ((PLAST_AUX >> M) & 1) != 0;
        });
        bool finite = (flag & 2) != 0;
#pragma unroll
        for (int k = 0; k < 9; ++k) finite = finite && isfinite(pl.F[k]);
        if (finite) {
          if (store_aux) put(RAUX, pl.aux);
          if (store_F) {
#pragma unroll
            for (int k = 0; k < 9; ++k) put(RF + k, pl.F[k]);
          }
          vmax = vabs;
          count = pl.count;
        } else {
          scrub(put);
        }
      }

      // the tile's partials: max |v| (lanes still active), plasticity count
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
        count += __shfl_xor_sync(0xffffffffu, count, off);
      }
      const int parity = (i / WS_MAPS) & 1;
      if (lane == 0) {
        red_max[m][parity][warp] = vmax;
        red_cnt[m][parity][warp] = count;
      }
      named_sync(NAMED_GATHER + 1 + m, THREADS);
      if (t == 0) {
        float mx = red_max[m][parity][0];
        int c = red_cnt[m][parity][0];
        for (int w = 1; w < WARPS; ++w) {
          mx = fmaxf(mx, red_max[m][parity][w]);
          c += red_cnt[m][parity][w];
        }
        vmax_part[tile] = mx;
        plast_part[tile] = c;
      }
    }
  }
}

// Returns REGISTER_BUDGET where the compiled kernel holds fewer registers
// than its warpgroups' budgets ask for (setmaxnreg.inc would wait for them
// forever).
constexpr int REGISTER_BUDGET = -2;

template <int MATS>
int launch_split(int blocks, cudaStream_t s, float* st, long long pw, const int* keys,
                 const float* win, int K, float* vmax_part, int* plast_part,
                 const G2PParams& prm) {
  using Budget = WsBudget<MATS>;
  static cudaFuncAttributes attr{};
  static const cudaError_t setup = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        g2p_ws_kernel<MATS>, cudaFuncAttributePreferredSharedMemoryCarveout, CARVEOUT);
    return e != cudaSuccess ? e : cudaFuncGetAttributes(&attr, g2p_ws_kernel<MATS>);
  }();
  if (setup != cudaSuccess) return static_cast<int>(setup);
  if (THREADS * (Budget::kGather + WS_MAPS * Budget::kMap) > WS_THREADS * attr.numRegs) {
    return REGISTER_BUDGET;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, g2p_ws_kernel<MATS>, WS_THREADS, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = std::min(blocks, std::max(per_sm, 1) * sms);
  g2p_ws_kernel<MATS><<<grid, WS_THREADS, 0, s>>>(st, pw, keys, win, K, vmax_part, plast_part,
                                                  prm, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g2p_fused_launch's interface (csrc/g2p.cu), on the split kernel.
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
  return launch_split<TMT_MATS>(blocks, static_cast<cudaStream_t>(stream), st, pw, keys, win, K,
                                vmax_part, plast_part, prm);
#else
  return WRONG_LIBRARY;
#endif
}
