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
// Yet on an H100 at 8M the Hencky staging takes 2.06 ms against jelly's
// 1.10 (102 registers against 96; PERF.md): a lane stages one particle
// at a time, and the SVD's 18 dependent Jacobi rotations do not hide
// behind the warp's scatter. What the kernels spend beyond
// that goes to the scatter: each particle puts 27 four-channel terms into
// nodes that its neighbours share, one after the other in sorted order.
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
// (the polar Newton iteration) overlaps that only in part (PERF.md).

#include <cuda_runtime.h>

#include "common.cuh"
#include "materials.cuh"

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
  const bool mine = lane < SUPPORT;
  const int o = kLaneOffset[lane];
  const int di = o / 9, dj = (o / 3) % 3, dk = o % 3;
  const int off = SI * di + SJ * dj + dk;
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

  float4* dst = reinterpret_cast<float4*>(out + (size_t)slot * TILE_NODES * 4);
  for (int n = lane; n < TILE_NODES; n += 32) {
    dst[n] = tile[SI * (n / (TILE * TILE)) + SJ * ((n / TILE) % TILE) + n % TILE];
  }
}

template <class Stage>
void launch(const Stage& stage, long long pw, const int* s_arr, const int* e_arr, int K,
            float* out, cudaStream_t s) {
  p2g_kernel<<<(K + WARPS - 1) / WARPS, THREADS, 0, s>>>(stage, pw, s_arr, e_arr, K, out);
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
  if (K > 0) {
    launch(StageState<TMT_MATS>{st, prm}, pw, s_arr, e_arr, K, out,
           static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
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
