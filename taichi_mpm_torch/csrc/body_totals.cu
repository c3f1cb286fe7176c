// Body impulse totals in particle order, for the dense CPIC path on Hopper
// (sm_90a).
//
// This kernel replaces no TPU kernel. The JAX package sums the impulses
// and torques that the coloured transfers put on each rigid body
// (rigid/body.py accumulate_impulses, a scatter-add in particle order)
// with XLA on the TPU or the CPU; the port's CPU path sums them in the
// same order (utils.index_add_ordered into one row per stencil offset and
// body). A body's total is a small sum of large contact impulses, and
// every substep integrates it into the body's velocity and spin, so the
// order of the sum decides the last bits of the bodies. Torch's masked
// sums on the card reduce as a tree, and a deterministic scatter into a
// few rows runs each row in one thread over every lane (82 of 91 ms of a
// dense CPIC substep of the 100k wheel). This kernel sums each row in
// particle order, so the card gives the CPU's bits for the same addends.
//
// Semantics: for each leading row l (a stencil offset, or one row),
// body r and component c
//   out[l, r, c] = (((+0 + v[l, i0, c]) + v[l, i1, c]) + ...)
// over the lanes i0 < i1 < ... with rid[l, i] == r, for two value arrays
// (the impulses J, ca components, and the torques, cb components) read
// with one pass over rid. A lane with rid -1 (not valid) adds nothing;
// its value is not read. The plain twin is ops/body_sums.body_totals_plain.
//
// What bounds it on the H100: bytes. The function reads rid once (int64,
// as the dense CPIC path hands it over), the values of the
// valid lanes (4 (ca + cb) bytes each) and writes L R (ca + cb) floats. At
// the dense 100k wheel's P2G call (27 offsets x 100,000 lanes, 3 bodies,
// 3 + 3 components, a few hundred valid lanes) that is 21.6 MB of rid,
// 6.45 us at 3.35 TB/s; at G2P's penalty totals (one row of 100,000) 0.8
// MB, 0.24 us. The adds (one a valid lane and component) are nothing at
// 67 TFLOP/s.
//
// The design it replaces (0.2434-0.2524 ms at the wheel's P2G call
// on an H100 80GB HBM3 at 700 W, share 0.026) ran one warp per (row,
// body): 81 warps there, 3 at G2P's call, each walking its row in
// N / 1,024 dependent steps, a round trip to memory for each step's rids
// and one more for each hit's values. The card waited on load latency with
// a few warps resident.
//
// Design: two launches on the caller's stream; no float atomics, no tree.
// 1. body_totals_mark scans rid across the card: a block of 256 threads
//    per tile of 2,048 lanes of a row (1,323 blocks at the wheel's P2G
//    call), eight independent coalesced loads a thread, so the loads
//    stream at bandwidth instead of in dependent steps. For each body it
//    writes a ballot word per 32 lanes (mask[l, r, word]) and the tile's
//    hit count (count[l, r, tile]).
// 2. body_totals_sum runs one block per (row, body). It reads the row's
//    tile counts at once and lists the tiles with hits in order (a block
//    scan). It takes them in batches of up to 64 tiles and 8,192 hits, the
//    batch's mask words spread over the threads, all loads in flight, and
//    turns them into the batch's hit lanes in lane order (a block scan of
//    the words' popcounts) in shared memory. It then loads the hits'
//    values with a thread per hit and component, in windows of 3,072
//    values, all of a window's loads in flight, and thread c adds
//    component c of the window's hits in lane order, its shared-memory
//    loads issued 16 ahead of the adds. The only dependent chain left is
//    the float adds of the hits, in the CPU's order: a body that holds
//    every lane of a row still adds N times, one after the other. A row
//    with a few hits costs three round trips (counts, words, values),
//    whatever its length.
// chip_smoke.py times the kernels on the dense wheel's own rows.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_C = 6;  // ca + cb: 3 + 3 in 3-D, 2 + 1 in 2-D
constexpr int MARK_THREADS = 256;
constexpr int MARK_STEPS = 8;  // mask words a warp ballots for each body
constexpr int TILE_WORDS = (MARK_THREADS / 32) * MARK_STEPS;  // 64
constexpr int TILE_LANES = 32 * TILE_WORDS;                   // 2,048
constexpr int SUM_THREADS = 256;
constexpr int SUM_WARPS = SUM_THREADS / 32;
constexpr int BATCH_LANES = 8192;  // the most hits a batch lists in shared memory
constexpr int BATCH_TILES = 64;    // the most tiles of a batch: 16 words a thread
constexpr int THREAD_WORDS = BATCH_TILES * TILE_WORDS / SUM_THREADS;  // 16
constexpr int WINDOW_LOADS = 12;                           // values a thread stages per window
constexpr int WINDOW_VALUES = SUM_THREADS * WINDOW_LOADS;  // 512 hits of 6 components
constexpr int CHAIN_LOADS = 16;  // shared-memory loads a chain issues before its adds

// Exclusive prefix sum of v over the block's SUM_THREADS threads, in
// thread order; *total gets the sum. Every thread of the block calls it.
__device__ int block_exclusive_scan(int v, int* total, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < SUM_WARPS ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < SUM_WARPS; d <<= 1) {
      const int y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    if (lane < SUM_WARPS) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = (warp ? s_warp[warp - 1] : 0) + x - v;
  *total = s_warp[SUM_WARPS - 1];
  __syncthreads();  // s_warp is free for the next scan
  return before;
}

// v as a body in [0, R), or -1
__device__ __forceinline__ int body_of(long long v, int R) {
  return v >= 0 && v < R ? static_cast<int>(v) : -1;
}

// Block (l, tile): lanes [tile * TILE_LANES, + TILE_LANES) of row l. Warp w
// ballots words tile * TILE_WORDS + w * MARK_STEPS + s, s < MARK_STEPS.
__global__ void __launch_bounds__(MARK_THREADS)
    body_totals_mark(const long long* __restrict__ rid, long long N, int R,
                     long long tiles, long long words, unsigned* __restrict__ mask,
                     int* __restrict__ count) {
  __shared__ int s_hits[MARK_THREADS / 32];
  const long long l = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long w0 = tile * TILE_WORDS + warp * MARK_STEPS;
  int body[MARK_STEPS];
#pragma unroll
  for (int s = 0; s < MARK_STEPS; ++s) {  // all its loads in flight at once
    const long long i = (w0 + s) * 32 + lane;
    body[s] = i < N ? body_of(rid[l * N + i], R) : -1;
  }
  for (int r = 0; r < R; ++r) {
    unsigned mine = 0;
    int hits = 0;
#pragma unroll
    for (int s = 0; s < MARK_STEPS; ++s) {
      const unsigned m = __ballot_sync(FULL, body[s] == r);
      if (lane == s) mine = m;
      hits += __popc(m);
    }
    const long long w = w0 + lane;
    if (lane < MARK_STEPS && w < words) mask[(l * R + r) * words + w] = mine;
    if (lane == 0) s_hits[warp] = hits;
    __syncthreads();
    if (threadIdx.x == 0) {
      int t = 0;
#pragma unroll
      for (int k = 0; k < MARK_THREADS / 32; ++k) t += s_hits[k];
      count[(l * R + r) * tiles + tile] = t;
    }
    __syncthreads();
  }
}

// Block (l, r): the totals of body r over row l, in lane order.
__global__ void __launch_bounds__(SUM_THREADS)
    body_totals_sum(const float* __restrict__ a, int ca, const float* __restrict__ b, int cb,
                    const unsigned* __restrict__ mask, const int* __restrict__ count,
                    long long N, int R, long long tiles, long long words,
                    float* __restrict__ out_a, float* __restrict__ out_b) {
  __shared__ int s_lane[BATCH_LANES];     // a batch's hit lanes, from its chunk's first lane
  __shared__ float s_val[WINDOW_VALUES];  // a window's values, hit-major
  __shared__ int s_tile[SUM_THREADS];     // a chunk's tiles with hits, in order
  __shared__ int s_end[SUM_THREADS];      // their hits' inclusive prefix sum
  __shared__ int s_warp[SUM_WARPS];
  const long long row = blockIdx.x;  // l * R + r
  const long long l = row / R;
  const int c_all = ca + cb;
  const int per_window = WINDOW_VALUES / c_all;
  const unsigned* mk = mask + row * words;
  const int* ct = count + row * tiles;
  const float* al = a + l * N * ca;
  const float* bl = b + l * N * cb;
  float acc = 0.0f;
  // chunks of SUM_THREADS tiles, a thread per tile's count
  for (long long t0 = 0; t0 < tiles; t0 += SUM_THREADS) {
    const long long t = t0 + threadIdx.x;
    const int n = t < tiles ? ct[t] : 0;
    int n_tiles, n_all;
    const int at = block_exclusive_scan(n > 0, &n_tiles, s_warp);
    const int end = block_exclusive_scan(n, &n_all, s_warp) + n;
    if (n > 0) {
      s_tile[at] = threadIdx.x;
      s_end[at] = end;
    }
    __syncthreads();
    const long long lane0 = t0 * TILE_LANES;
    // batches: the next tiles with hits, at most BATCH_TILES of them and
    // BATCH_LANES hits (a tile holds at most TILE_LANES, so at least one)
    for (int k0 = 0, nb; k0 < n_tiles; k0 += nb) {
      const int base = k0 ? s_end[k0 - 1] : 0;
      const int kt = k0 + static_cast<int>(threadIdx.x);
      nb = __syncthreads_count(threadIdx.x < BATCH_TILES && kt < n_tiles &&
                               s_end[kt] - base <= BATCH_LANES);
      int per = 1;  // words a thread reads: the batch's words spread over the threads
      while (per * SUM_THREADS < nb * TILE_WORDS) per <<= 1;
      const int bw = threadIdx.x * per;  // this thread's first word in the batch
      int rel = 0;  // that word, from the chunk's first word
      if (bw < nb * TILE_WORDS) rel = s_tile[k0 + bw / TILE_WORDS] * TILE_WORDS + bw % TILE_WORDS;
      unsigned m[THREAD_WORDS];
      int hits = 0;
#pragma unroll
      for (int j = 0; j < THREAD_WORDS; ++j) {  // independent loads, all in flight
        const long long w = t0 * TILE_WORDS + rel + j;
        m[j] = j < per && bw < nb * TILE_WORDS && w < words ? mk[w] : 0u;
        hits += __popc(m[j]);
      }
      int n_hits;
      int p = block_exclusive_scan(hits, &n_hits, s_warp);
#pragma unroll
      for (int j = 0; j < THREAD_WORDS; ++j)
        for (unsigned mm = m[j]; mm; mm &= mm - 1) s_lane[p++] = (rel + j) * 32 + __ffs(mm) - 1;
      __syncthreads();
      for (int h0 = 0; h0 < n_hits; h0 += per_window) {
        const int nv = min(per_window, n_hits - h0) * c_all;
        float v[WINDOW_LOADS];
#pragma unroll
        for (int u = 0; u < WINDOW_LOADS; ++u) {  // a thread per hit and component, all in flight
          const int q = threadIdx.x + u * SUM_THREADS;
          v[u] = 0.0f;
          if (q < nv) {
            const int h = q / c_all, c = q - h * c_all;
            const long long i = lane0 + s_lane[h0 + h];
            v[u] = c < ca ? al[i * ca + c] : bl[i * cb + (c - ca)];
          }
        }
#pragma unroll
        for (int u = 0; u < WINDOW_LOADS; ++u) {
          const int q = threadIdx.x + u * SUM_THREADS;
          if (q < nv) s_val[q] = v[u];
        }
        __syncthreads();
        if (threadIdx.x < c_all) {  // one chain of adds a component, in lane order
          const float* sv = s_val + threadIdx.x;
          int q = 0;
          for (; q + CHAIN_LOADS * c_all <= nv; q += CHAIN_LOADS * c_all) {
            float x[CHAIN_LOADS];  // loaded ahead of the adds that wait on them
#pragma unroll
            for (int k = 0; k < CHAIN_LOADS; ++k) x[k] = sv[q + k * c_all];
#pragma unroll
            for (int k = 0; k < CHAIN_LOADS; ++k) acc = acc + x[k];
          }
          for (; q < nv; q += c_all) acc = acc + sv[q];
        }
        __syncthreads();
      }
    }
  }
  if (threadIdx.x < ca) out_a[row * ca + threadIdx.x] = acc;
  else if (threadIdx.x < c_all) out_b[row * cb + (threadIdx.x - ca)] = acc;
}

long long tiles_of(long long N) { return (N + TILE_LANES - 1) / TILE_LANES; }
long long words_of(long long N) { return (N + 31) / 32; }

}  // namespace

// The 32-bit words of scratch that body_totals_launch needs for (L, N, R):
// the mask words and the tile counts of every (row, body).
extern "C" long long body_totals_scratch_words(int L, long long N, int R) {
  return static_cast<long long>(L) * R * (words_of(N) + tiles_of(N));
}

// Launch on `stream`. a: (L, N, ca) f32, b: (L, N, cb) f32, rid: (L, N)
// int64, a body in [0, R) or -1 (the lane adds nothing); scratch:
// body_totals_scratch_words(L, N, R) words, not read before written;
// out_a: (L, R, ca), out_b: (L, R, cb) f32, every entry written. 1 <= ca,
// 0 <= cb, ca + cb <= 6. Returns cudaGetLastError(), or -2 for arguments
// the kernels do not take.
extern "C" int body_totals_launch(const float* a, int ca, const float* b, int cb,
                                  const long long* rid, int L, long long N, int R,
                                  void* scratch, float* out_a, float* out_b, void* stream) {
  if (ca < 1 || cb < 0 || ca + cb > MAX_C || L < 0 || N < 0 || R < 1) return -2;
  const long long tiles = tiles_of(N), words = words_of(N);
  const long long rows = static_cast<long long>(L) * R;
  if (static_cast<long long>(L) * tiles > 0x7fffffffLL || rows > 0x7fffffffLL) return -2;
  unsigned* mask = static_cast<unsigned*>(scratch);
  int* count = reinterpret_cast<int*>(mask + rows * words);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > 0 && tiles > 0) {
    body_totals_mark<<<static_cast<unsigned>(L * tiles), MARK_THREADS, 0, s>>>(
        rid, N, R, tiles, words, mask, count);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (rows > 0)
    body_totals_sum<<<static_cast<unsigned>(rows), SUM_THREADS, 0, s>>>(
        a, ca, b, cb, mask, count, N, R, tiles, words, out_a, out_b);
  return static_cast<int>(cudaGetLastError());
}
