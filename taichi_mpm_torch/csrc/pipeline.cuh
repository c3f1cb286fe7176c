// Hand-over between the warps of a warp-specialised block (sm_90): the
// shared-memory barriers (mbarrier) that p2g.cu's Hencky builds pass
// records through.
//
// An mbarrier counts arrivals: a phase completes when `count` threads
// have arrived, and a waiter asks whether the phase of a given parity has
// completed. Arrive releases the arriving thread's earlier writes (shared
// and device memory) and a completed wait acquires them, at CTA scope.
// A ring stage s used for rounds r = s, s + S, s + 2S, ... is full for
// round r at parity (r / S) & 1, and empty again for round r + S once the
// consumer arrives at its empty barrier at parity (r / S) & 1.
//
// A wait that has not completed after WAIT_LIMIT_CYCLES (about 8.7 s at
// the H100's 1.98 GHz) traps, so that a fault in a hand-over shows as a
// failed launch (the wrapper raises on the next synchronisation) instead
// of a kernel that never ends.
#pragma once

#include <cuda_runtime.h>

namespace mpm {

constexpr long long WAIT_LIMIT_CYCLES = 1LL << 34;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread initialises; then fence_barrier_init and __syncthreads before
// any thread uses the barrier.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared.b64 state, [%0];\n\t}" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
  }
}

}  // namespace mpm
