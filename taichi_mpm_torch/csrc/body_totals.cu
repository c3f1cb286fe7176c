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
// Design: one warp per (row, body). The warp walks the lanes in steps of
// 32 x 32: each thread loads 32 rids (coalesced, all in flight at once)
// and the warp ballots the lanes of its body in each chunk of 32. Then,
// chunk by chunk and hit by hit in lane order, thread k < ca + cb loads
// component k of the hit lane and adds it: one float add per hit and
// component, in order, with no atomics and no shuffles, so the result has
// the same bits on every launch. A lane of another body costs its rid's
// load and nothing in the dependent chain of adds.
//
// What bounds it on the H100: bytes. The function reads rid once (4 bytes
// a lane), the values of the valid lanes (4 (ca + cb) bytes each) and
// writes L R (ca + cb) floats; at the dense 100k wheel's P2G call (27
// offsets x 100,000 lanes, 3 bodies, 3 + 3 components) that is ~10.8 MB
// plus the valid lanes', ~3.2 us at 3.35 TB/s; the adds (6 a valid lane)
// are nothing at 67 TFLOP/s. The kernel cannot reach that: a warp's walk
// is N / 1024 dependent steps, each a round trip to memory for its rids,
// plus one for each hit's values, and only L R warps run (81 there, 3 for
// G2P's penalty totals over one row), so it waits on load latency
// (chip_smoke.py measures it).

#include <cuda_runtime.h>

namespace {

constexpr int CHUNKS = 32;    // chunks of 32 lanes whose rids a step loads
constexpr int MAX_C = 6;      // ca + cb: 3 + 3 in 3-D, 2 + 1 in 2-D
constexpr int WARPS_PER_BLOCK = 4;

__global__ void body_totals_kernel(const float* __restrict__ a, int ca,
                                   const float* __restrict__ b, int cb,
                                   const int* __restrict__ rid, int L, long long N, int R,
                                   float* __restrict__ out_a, float* __restrict__ out_b) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= static_cast<long long>(L) * R) return;  // the whole warp leaves together
  const int l = static_cast<int>(warp / R);
  const int r = static_cast<int>(warp % R);
  const int* rr = rid + l * N;
  // thread k < ca reads component k of J, ca <= k < ca + cb component k - ca of tau
  const bool reads = lane < ca + cb;
  const float* src = lane < ca ? a + l * N * ca + lane : b + l * N * cb + (lane - ca);
  const int stride = lane < ca ? ca : cb;
  float acc = 0.0f;
  for (long long base = 0; base < N; base += 32 * CHUNKS) {
    unsigned mask[CHUNKS];
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const long long i = base + 32 * u + lane;
      mask[u] = __ballot_sync(0xffffffffu, i < N && rr[i] == r);
    }
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      unsigned m = mask[u];
      while (m) {  // the same mask in every thread of the warp
        const long long i = base + 32 * u + (__ffs(m) - 1);
        m &= m - 1;
        if (reads) acc = acc + src[i * stride];
      }
    }
  }
  if (lane < ca) out_a[(static_cast<long long>(l) * R + r) * ca + lane] = acc;
  else if (reads) out_b[(static_cast<long long>(l) * R + r) * cb + (lane - ca)] = acc;
}

}  // namespace

// Launch on `stream`. a: (L, N, ca) f32, b: (L, N, cb) f32, rid: (L, N)
// i32 (a body in [0, R), or -1: the lane adds nothing); out_a: (L, R, ca),
// out_b: (L, R, cb) f32, every entry written. 1 <= ca, 0 <= cb,
// ca + cb <= 6. Returns cudaGetLastError(), or -2 for components the
// kernel does not take.
extern "C" int body_totals_launch(const float* a, int ca, const float* b, int cb,
                                  const int* rid, int L, long long N, int R, float* out_a,
                                  float* out_b, void* stream) {
  if (ca < 1 || cb < 0 || ca + cb > MAX_C) return -2;
  const long long warps = static_cast<long long>(L) * R;
  if (warps > 0) {
    const int threads = 32 * WARPS_PER_BLOCK;
    const long long blocks = (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    body_totals_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, ca, b, cb, rid, L, N, R, out_a,
                                                              out_b);
  }
  return static_cast<int>(cudaGetLastError());
}
