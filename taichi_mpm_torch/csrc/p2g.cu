// P2G for Hopper (sm_90a): two entry points over one accumulation stage.
//
// p2g_fused_launch (fused prep + P2G) replaces the TPU kernel
// taichi_mpm_tpu/ops/fused_pallas.py p2g_fused
// (_p2g_fused_kernel, _build_pd, with p2g_pallas._chunk_ops and
// tile_correct): for each active block slot, build every particle's P2G
// operand from the packed (48, Pw) state (m*v, m, the fused affine
// A = invD*m*C - invD*inv_dx*dt*force with the force of the particle's
// material, any of the eight of materials.cuh; block-local position) and
// accumulate the slot's 7^3 halo tile of momentum and mass with quadratic
// B-spline weights.
//
// p2g_blocked_launch replaces the TPU kernels
// taichi_mpm_tpu/ops/p2g_pallas.py p2g_blocked and p2g_blocked_batched
// (the same function; the batched one takes 4 slots per program on the
// TPU, which a CUDA grid does not need): the same halo tiles, from a
// prebuilt (16, Pw) operand [m*v (3), m, A row-major (9), block-local
// pos (3)] (ops/p2g.prep_packed) instead of the state. It keeps none of
// the TPU form: no matmul fold of the weights into (112, 49) channels
// (_chunk_ops, tile_correct), no 512-lane chunked DMA, no bf16x3 split.
// The TPU fed the scatter to its matrix unit because its vector unit has
// no scatter; here a slot's product would be a (343 x n) weight matrix,
// ~92% zeros, times an (n x 4) operand, no work for the tensor cores.
//
// Semantics: tile node (i, j, k) is block-local node (i-1, j-1, k-1);
//   tile[c] += w * (m*v_c + sum_a A[c][a] * (pos_a - node_a))   c = 0..2
//   tile[3] += w * m
// where w is the tensor product of the per-axis quadratic weights (a
// contribution outside the tile is dropped, as in the reference). The
// kernel is compiled for the scene's material set (MATS, a bit set
// 1 << id; one library per set, see the end of this file): a scene of one
// material reads only its own rows, and only a mixed scene reads row 47
// to choose the force per particle.
//
// What bounds it on the H100. Bytes: at 8M jelly particles p2g_fused
// reads 32 of the 48 state rows of each particle once (act, x, v, F, C,
// mass, vol, mu, lambda, origin: ~1.02 GB; water reads aux instead of F)
// and writes the live slots' tiles of 5.5 KB (~0.11 GB): 0.34 ms at
// 3.35 TB/s; p2g_blocked reads 16 operand rows (~0.51 GB): 0.19 ms.
// Operations: ~1.7 kflop per jelly particle (polar Newton, force, the 9
// support weights, 27 nodes x 31) take 0.2 ms at 67 TFLOP/s; the SVD of
// the Hencky force (elastic, sand, von Mises) adds ~0.5 kflop and 5
// special functions. So bytes bound them all (chip_smoke.py counts them).
// But without fast math each IEEE division or square root, one operation
// in that count, is a sequence of instructions, and the Hencky force's
// SVD holds 72 of them: the SMs issue 3,382 SASS instructions a jelly
// particle and 4,066 a Hencky one (tools/sass_count.py: a round's staging
// and its 32 scatter iterations over its 32 particles), an issue floor of
// 0.81 and 0.97 ms at 8M and 1.98 GHz, above the bytes' 0.34. Each
// particle then puts 27 four-channel terms into nodes that its neighbours
// share, one after the other in sorted order.
// On an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md) at 8M jelly takes
// 1.09 ms. The Hencky builds took 2.02-2.04 in one warp staging and then
// scattering each round (102 registers): the SVD's 18 dependent Jacobi
// rotations did not hide behind the warp's own scatter. They now run
// p2g_ws_kernel (below): 1.57 ms.
//
// The accumulation stage, one warp per slot:
// 1. Stage: lane l takes particle base + l of the slot's sorted range
//    [s, e), 32 per round. Its rows are loaded into registers a round
//    ahead (Stage::load), so that they arrive while the warp accumulates
//    the round before; then Stage::build forms its 16 operand values
//    (StageState from the state, StageOperand from the operand) and
//    write_record puts them in the warp's buffer in shared memory with,
//    per axis and support node, the weight and pos - node, and the tile
//    corner of the support (first node floor(pos - 0.5) per axis).
// 2. Accumulate: the warp walks the staged particles in sorted order.
//    Lane l < 27 owns one support offset (di, dj, dk) and adds the
//    particle's term into that node of the warp's tile in shared memory
//    (one float4 read-modify-write), skipping a zero weight; a node
//    outside the tile has weight 0. __syncwarp between particles orders
//    the updates two lanes make to one node for successive particles.
//    That is 27 lanes per particle, where the node-owner loop this
//    replaces visited all 343 tile nodes (13x the work) and synchronised
//    the block twice per round of 128 particles.
// 3. Write: the tile goes out in coalesced float4 stores; an empty slot
//    (s >= e) writes zeros.
//
// Determinism: every node sums the same terms (the same staged values,
// weight products and momentum expressions) in the same order as the
// node-owner loop did: over the slot's particles in sorted order, zero
// weights skipped, from +0. So the tiles keep that kernel's bits, and the
// same input gives the same bits on every run, as in the reference; no
// atomics. A weight is non-zero only within 1.5 cells of the particle,
// and every such node inside the tile is one of the 27 support nodes, so
// no term is lost.
//
// Shared layout: tile node (i, j, k) sits at 51 i + 7 j + k (355 float4
// instead of 343), and lanes take their offsets in the order of
// kLaneOffset, so that the 8 lanes of each quarter-warp touch 8 distinct
// 16-byte bank groups in the read-modify-write: 4 shared-memory wavefronts
// per access, where the dense 49 i + 7 j + k layout needs 7. A record is
// 9 float4, an odd number, so 8 lanes' float4 stores to their own records
// also hit distinct bank groups.
//
// What limits it now is the SM's shared-memory pipe: per particle the
// warp reads the staged values as broadcasts (3 float4 and a float2), each
// lane its 3 (weight, offset) pairs, and 27 lanes read and write a float4
// of the tile, some 24 pipe cycles per particle; p2g_fused's jelly staging
// (the polar Newton iteration) overlaps that only in part (PERF.md). In
// the Hencky builds it is the staging: at 8M the producers alone (the
// consumer adding one value a round) take 1.32 ms, the scatter alone
// (producers writing constant records) 0.96, both together 1.57 at 64
// registers and 8 blocks per SM (24 producer warps), 1.78 at ptxas's 80
// registers and 6 blocks. More producers per slot or another ring did not
// help (4 producers 1.61, 3 stages 1.59, 8 stages 2.06, 2 producers and 2
// stages 1.79; tools/p2g_variants.py hencky), nor did this schedule help
// the other builds (jelly 1.22 against 1.10), which keep p2g_kernel.

#include <cuda_runtime.h>

#include "common.cuh"
#include "materials.cuh"
#include "pipeline.cuh"

// One library per material set: nvcc -DTMT_MATS=<set> compiles p2g_fused
// for that set alone (ops/cuda_build.py builds each set at its first use),
// and TMT_MATS=0 the material-free p2g_blocked. An entry point that the
// library was not built for returns WRONG_LIBRARY, which the wrapper
// raises.
#ifndef TMT_MATS
#define TMT_MATS 0
#endif
constexpr int WRONG_LIBRARY = -1;

namespace {

using namespace mpm;

// Slots per block, one warp each. One balances best: a block frees its
// shared memory as soon as its slot is done (2 and 4 were slower at 8M;
// PERF.md).
constexpr int WARPS = 1;
constexpr int THREADS = 32 * WARPS;
constexpr int NV = 16;       // operand values: m*v (3), m, A (9), pos (3)
constexpr int SUPPORT = 27;  // support nodes, one lane each
// A staged record, 9 float4: m*v (3), m, A (9), the tile corner of the
// support (int bits), 2 spare words; then per axis a and support node d
// the pair (weight, pos_a - node) at float2 R_PAIR + 3a + d.
constexpr int R_CORNER = 13, R_PAIR = 8;
constexpr int REC4 = 9;
constexpr int SI = 51, SJ = 7;  // shared tile strides of i and j
constexpr int TILE_SMEM = SI * (TILE - 1) + SJ * (TILE - 1) + TILE;  // 355

// Lane l < 27 owns support offset kLaneOffset[l] = di*9 + dj*3 + dk: each
// quarter-warp's 8 offsets fall on 8 distinct values of
// (SI di + SJ dj + dk) mod 8, i.e. 8 bank groups of the float4 tile.
__constant__ unsigned char kLaneOffset[32] = {0,  1,  2,  9,  10, 11, 6,  3,  4,  5,  12,
                                              13, 14, 21, 18, 7,  8,  15, 16, 17, 24, 25,
                                              22, 19, 20, 26, 23, 0,  0,  0,  0,  0};

struct P2GParams {
  float inv_dx;
  float invD;
  float cf_scale;  // invD * inv_dx * dt
  float gdt[3];    // gravity * dt, used when particle_gravity
  int particle_gravity;
};

// The 16 operand values of a particle from its state rows (raw[r]: row r,
// for the rows that StageState::load reads).
// MATS: the scene's materials as a bit set (1 << id), as in g2p.cu.
template <int MATS>
__device__ __forceinline__ void stage_particle(const float* raw, const P2GParams& prm,
                                               float* __restrict__ sv) {
  auto R = [&](int r) { return raw[r]; };
  const bool act = R(RACT) > 0.5f;
  float C[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) C[k] = R(RC + k);
  const float mass = R(RMASS), vol = R(RVOL);

  // force = -vol * P F^T of the particle's material (materials.cuh; row
  // 47 holds its id as a value, read only in a mixed scene). A material
  // reads only its own rows: F (all but water), aux (snow, water) and
  // the parameter slots 0-1, and 2 for snow.
  float F[9], par[8];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = R(RF + k);
#pragma unroll
  for (int k = 0; k < 8; ++k) par[k] = R(RPAR + k);
  const int mat_id = single_material<MATS>() ? 0 : (int)R(RMATF);
  float force[9];
  dispatch<MATS>(mat_id, [&](auto mat) {
    material_force<decltype(mat)::id>(F, R(RAUX), par, vol, force);
  });
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
    sv[13 + a] = __fmul_rn(R(RX + a), prm.inv_dx) - R(RORG + a);
  }
}

// How a lane stages one particle: load reads its rows into registers
// (raw, NRAW entries), build turns them into the 16 operand values.
// StageState builds them from the packed state (p2g_fused); StageOperand
// reads a prebuilt operand (p2g_blocked).
template <int MATS>
struct StageState {
  const float* __restrict__ st;
  P2GParams prm;
  static constexpr int NRAW = NCH;  // indexed by row; only the rows read get registers
  __device__ __forceinline__ void load(long long pw, long long p, float* raw) const {
    const float* S = st + p;
    auto L = [&](int r) { raw[r] = S[(long long)r * pw]; };
    L(RACT);
    L(RMASS);
    L(RVOL);
    L(RPAR);
    L(RPAR + 1);
    if (has<MATS>(SNOW)) L(RPAR + 2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      L(RX + c);
      L(RV + c);
      L(RORG + c);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) L(RC + k);
    if (MATS != (1 << WATER)) {
#pragma unroll
      for (int k = 0; k < 9; ++k) L(RF + k);
    }
    if ((MATS & FORCE_AUX) != 0) L(RAUX);
    if (!single_material<MATS>()) L(RMATF);
  }
  __device__ __forceinline__ void build(const float* raw, float* sv) const {
    stage_particle<MATS>(raw, prm, sv);
  }
};

struct StageOperand {
  const float* __restrict__ pd;
  static constexpr int NRAW = NV;
  __device__ __forceinline__ void load(long long pw, long long p, float* raw) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) raw[k] = pd[(long long)k * pw + p];
  }
  __device__ __forceinline__ void build(const float* raw, float* sv) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) sv[k] = raw[k];
  }
};

// The staged record of a particle with operand values sv. Per axis, its
// support starts at node floor(pos - 0.5), clamped to +-8 so that a far or
// non-finite position gives a small integer whose support lies outside the
// tile; a support node's pair is its weight N(pos - node) and pos - node,
// the same float expressions as quad_w(pos - (i - 1)) and the offset for
// tile index i = node + 1, with weight 0 where the node lies outside the
// tile (so that the node is skipped, as a zero weight is).
__device__ __forceinline__ void write_record(const float* sv, float4* __restrict__ rec) {
  float r[4 * REC4];
#pragma unroll
  for (int k = 0; k < R_CORNER; ++k) r[k] = sv[k];
  r[R_CORNER + 1] = r[R_CORNER + 2] = 0.0f;
  int b[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = sv[13 + a];
    const float bf = fminf(fmaxf(floorf(pos - 0.5f), -8.0f), 8.0f);
    b[a] = (int)bf;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float dx = pos - (bf + (float)d);
      const int t = b[a] + 1 + d;  // tile index
      r[2 * (R_PAIR + 3 * a + d)] = (t >= 0 && t < TILE) ? quad_w(dx) : 0.0f;
      r[2 * (R_PAIR + 3 * a + d) + 1] = dx;
    }
  }
  r[R_CORNER] = __int_as_float(SI * (b[0] + 1) + SJ * (b[1] + 1) + (b[2] + 1));
#pragma unroll
  for (int q = 0; q < REC4; ++q) {
    rec[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  }
}

// A warp adds `cnt` staged records, in order, into the shared tile: lane
// l < 27 adds each particle's term into its support node kLaneOffset[l],
// skipping a zero weight; __syncwarp between particles orders the updates
// two lanes make to one node for successive particles.
__device__ __forceinline__ void scatter_round(const float4 (*rec)[REC4], int cnt,
                                              float4* __restrict__ tile, int lane) {
  const bool mine = lane < SUPPORT;
  const int o = kLaneOffset[lane];
  const int di = o / 9, dj = (o / 3) % 3, dk = o % 3;
  const int off = SI * di + SJ * dj + dk;
  for (int p = 0; p < cnt; ++p) {
    const float2* pair = reinterpret_cast<const float2*>(rec[p]) + R_PAIR;
    if (mine) {
      const float2 x = pair[di], y = pair[3 + dj], z = pair[6 + dk];
      const float wq = x.x * y.x * z.x;
      if (wq != 0.0f) {
        float v[R_CORNER];  // m*v, m, A
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 a = rec[p][q];
          v[4 * q] = a.x;
          v[4 * q + 1] = a.y;
          v[4 * q + 2] = a.z;
          v[4 * q + 3] = a.w;
        }
        const float2 a8 = reinterpret_cast<const float2*>(rec[p])[6];
        v[12] = a8.x;
        const float dx = x.y, dy = y.y, dz = z.y;
        float4* t = tile + __float_as_int(a8.y) + off;
        float4 acc = *t;
        float mom = v[0] + v[4] * dx + v[5] * dy + v[6] * dz;
        acc.x += wq * mom;
        mom = v[1] + v[7] * dx + v[8] * dy + v[9] * dz;
        acc.y += wq * mom;
        mom = v[2] + v[10] * dx + v[11] * dy + v[12] * dz;
        acc.z += wq * mom;
        acc.w += wq * v[3];
        *t = acc;
      }
    }
    __syncwarp();
  }
}

// A warp writes the slot's tile out in coalesced float4 stores.
__device__ __forceinline__ void write_tile(const float4* __restrict__ tile, float* __restrict__ out,
                                           int slot, int lane) {
  float4* dst = reinterpret_cast<float4*>(out + (size_t)slot * TILE_NODES * 4);
  for (int n = lane; n < TILE_NODES; n += 32) {
    dst[n] = tile[SI * (n / (TILE * TILE)) + SJ * ((n / TILE) % TILE) + n % TILE];
  }
}

// One warp per slot: stage the slot's sorted range [s, e) 32 particles
// at a time, then add each staged particle, in order, into its 27
// support nodes of the warp's shared tile.
template <class Stage>
__global__ void __launch_bounds__(THREADS)
p2g_kernel(Stage stage, long long pw, const int* __restrict__ s_arr,
           const int* __restrict__ e_arr, int K, float* __restrict__ out) {
  __shared__ float4 tiles[WARPS][TILE_SMEM];
  __shared__ float4 recs[WARPS][32][REC4];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = blockIdx.x * WARPS + warp;
  if (slot >= K) return;
  float4* tile = tiles[warp];
  float4(*rec)[REC4] = recs[warp];
  // ranges clipped to the state, so a bad range reads nothing outside it
  const int s = max(s_arr[slot], 0);
  const int e = (int)min((long long)e_arr[slot], pw);

  for (int n = lane; n < TILE_SMEM; n += 32) tile[n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncwarp();

  float raw[Stage::NRAW];
  if (lane < e - s) stage.load(pw, (long long)s + lane, raw);
  for (int base = s; base < e; base += 32) {
    const int cnt = min(32, e - base);
    if (lane < cnt) {
      float sv[NV];
      stage.build(raw, sv);
      write_record(sv, rec[lane]);
    }
    __syncwarp();
    // the next round's rows load while this round accumulates
    if (lane < e - base - 32) stage.load(pw, (long long)base + 32 + lane, raw);
    scatter_round(rec, cnt, tile, lane);
  }

  write_tile(tile, out, slot, lane);
}

// The Hencky builds (a material set with elastic, sand or von Mises): one
// slot per block of 1 + WS_PRODUCERS warps, so that the SVD staging of
// later rounds runs beside the scatter of the round before. The producer
// warps stage the slot's rounds of 32 particles in turn (producer j takes
// rounds j, j + WS_PRODUCERS, ...) into a ring of WS_STAGES record
// buffers; the consumer warp zeroes the tile, adds the rounds in order as
// p2g_kernel does (scatter_round: the same records, the same order, the
// same bits), and writes the tile out. Round r lives in stage
// r % WS_STAGES: its producer waits until the consumer has emptied the
// stage of round r - WS_STAGES, writes its records and arrives at the
// stage's full barrier (32 arrivals, one per lane); the consumer waits
// for it and, where a later round needs the stage, arrives at its empty
// barrier (32 arrivals). Sizes, from the staging and scatter times above:
// 3 producers and 4 stages (24 KB of shared memory), and launch bounds of
// 8 blocks per SM, which hold the producers to 64 registers.
template <int MATS>
__host__ __device__ constexpr bool hencky_build() {
  return has<MATS>(ELASTIC) || has<MATS>(SAND) || has<MATS>(VON_MISES);
}

constexpr int WS_PRODUCERS = 3;
constexpr int WS_STAGES = 4;
constexpr int WS_MIN_BLOCKS = 8;  // blocks per SM the launch bounds ask for: 64 registers
constexpr int WS_THREADS = 32 * (1 + WS_PRODUCERS);
// A producer waits for the empty phase of round r - WS_STAGES; with fewer
// stages than producers it could reach that wait while the consumer has
// not finished round r - 2 WS_STAGES, whose phase has the same parity.
static_assert(WS_STAGES >= WS_PRODUCERS, "the ring needs a stage per producer");

template <class Stage>
__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
p2g_ws_kernel(Stage stage, long long pw, const int* __restrict__ s_arr,
              const int* __restrict__ e_arr, float* __restrict__ out) {
  __shared__ float4 tile[TILE_SMEM];
  __shared__ float4 ring[WS_STAGES][32][REC4];
  __shared__ unsigned long long full[WS_STAGES], empty[WS_STAGES];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = blockIdx.x;
  // ranges clipped to the state, so a bad range reads nothing outside it
  const int s = max(s_arr[slot], 0);
  const int e = (int)min((long long)e_arr[slot], pw);
  const int rounds = e > s ? (e - s + 31) / 32 : 0;
  if (threadIdx.x < WS_STAGES) {
    mbar_init(&full[threadIdx.x], 32);
    mbar_init(&empty[threadIdx.x], 32);
  }
  fence_barrier_init();
  __syncthreads();

  if (warp == 0) {  // the consumer
    for (int n = lane; n < TILE_SMEM; n += 32) tile[n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();
    for (int r = 0; r < rounds; ++r) {
      const int q = r % WS_STAGES;
      mbar_wait(&full[q], (r / WS_STAGES) & 1);
      scatter_round(ring[q], min(32, e - s - 32 * r), tile, lane);
      if (r + WS_STAGES < rounds) mbar_arrive(&empty[q]);
    }
    write_tile(tile, out, slot, lane);
  } else {  // producer warp - 1
    float rows[Stage::NRAW];
    for (int r = warp - 1; r < rounds; r += WS_PRODUCERS) {
      const int base = s + 32 * r;
      const int cnt = min(32, e - base);
      float sv[NV];
      if (lane < cnt) {
        stage.load(pw, (long long)base + lane, rows);
        stage.build(rows, sv);
      }
      const int q = r % WS_STAGES;
      if (r >= WS_STAGES) mbar_wait(&empty[q], (r / WS_STAGES - 1) & 1);
      if (lane < cnt) write_record(sv, ring[q][lane]);
      mbar_arrive(&full[q]);
    }
  }
}

template <class Stage>
void launch(const Stage& stage, long long pw, const int* s_arr, const int* e_arr, int K,
            float* out, cudaStream_t s) {
  p2g_kernel<<<(K + WARPS - 1) / WARPS, THREADS, 0, s>>>(stage, pw, s_arr, e_arr, K, out);
}

template <class Stage>
cudaError_t launch_ws(const Stage& stage, long long pw, const int* s_arr, const int* e_arr,
                      int K, float* out, cudaStream_t s) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      p2g_ws_kernel<Stage>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return carveout;
  p2g_ws_kernel<<<K, WS_THREADS, 0, s>>>(stage, pw, s_arr, e_arr, out);
  return cudaGetLastError();
}

// p2g_fused of material set MATS: the Hencky builds warp-specialised, the
// others as p2g_kernel
template <int MATS>
cudaError_t launch_fused(const StageState<MATS>& stage, long long pw, const int* s_arr,
                         const int* e_arr, int K, float* out, cudaStream_t s) {
  if constexpr (hencky_build<MATS>()) {
    return launch_ws(stage, pw, s_arr, e_arr, K, out, s);
  } else {
    launch(stage, pw, s_arr, e_arr, K, out, s);
    return cudaGetLastError();
  }
}

}  // namespace


// Launch on `stream`. st: (48, pw) f32 packed state, rows 43-45 holding the
// sort-time block origins; s_arr/e_arr: (K,) i32 sorted particle ranges;
// out: (K, 7, 7, 7, 4) f32 halo tiles [i, j, k, c]; mats: the scene's
// materials as a bit set, which must be TMT_MATS. Returns
// cudaGetLastError(), or WRONG_LIBRARY.
extern "C" int p2g_fused_launch(const float* st, long long pw, const int* s_arr,
                                const int* e_arr, int K, float* out, float inv_dx,
                                float invD, float cf_scale, float gdt0, float gdt1,
                                float gdt2, int particle_gravity, int mats, void* stream) {
#if TMT_MATS != 0
  if (mats != TMT_MATS) return WRONG_LIBRARY;
  P2GParams prm;
  prm.inv_dx = inv_dx;
  prm.invD = invD;
  prm.cf_scale = cf_scale;
  prm.gdt[0] = gdt0;
  prm.gdt[1] = gdt1;
  prm.gdt[2] = gdt2;
  prm.particle_gravity = particle_gravity;
  if (K == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_fused(StageState<TMT_MATS>{st, prm}, pw, s_arr, e_arr, K, out,
                                       static_cast<cudaStream_t>(stream)));
#else
  return WRONG_LIBRARY;
#endif
}

// Launch on `stream`. pdata: (16, pw) f32 P2G operand [m*v (3), m, A
// row-major (9), block-local pos (3)]; s_arr/e_arr: (K,) i32 sorted
// particle ranges (s == e: an empty slot, zero tile); out: (K, 7, 7, 7, 4)
// f32 halo tiles [i, j, k, c]. Returns cudaGetLastError(), or
// WRONG_LIBRARY outside the material-free library.
extern "C" int p2g_blocked_launch(const float* pdata, long long pw, const int* s_arr,
                                  const int* e_arr, int K, float* out, void* stream) {
#if TMT_MATS == 0
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 0) launch(StageOperand{pdata}, pw, s_arr, e_arr, K, out, s);
  return static_cast<int>(cudaGetLastError());
#else
  return WRONG_LIBRARY;
#endif
}
