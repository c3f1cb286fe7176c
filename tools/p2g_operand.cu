// The two-pass yardstick of p2g_fused's Hencky builds: a pass that builds
// the 16-row P2G operand [m*v (3), m, A (9), block-local pos (3)] of every
// lane from the packed state, with p2g_fused's own staging code
// (StageState: the material force, the affine A), into device memory; the
// port's p2g_blocked kernel then scatters it. chip_smoke.py --kernel-tree
// times the two passes beside p2g_fused on the 8M state of each Hencky
// material. Not part of the port: nothing in taichi_mpm_torch calls it.
//
// Build (one library per material set, as the port's):
//   nvcc <ops/cuda_build.NVCC_FLAGS> -DTMT_MATS=<set> \
//        -I taichi_mpm_torch/csrc -o p2g_operand.so tools/p2g_operand.cu
#include "p2g.cu"

namespace {

constexpr int OPERAND_THREADS = 128;

template <int MATS>
__global__ void __launch_bounds__(OPERAND_THREADS)
operand_kernel(StageState<MATS> stage, long long pw, float* __restrict__ pd) {
  const long long p = (long long)blockIdx.x * OPERAND_THREADS + threadIdx.x;
  if (p >= pw) return;
  float raw[StageState<MATS>::NRAW];
  float sv[NV];
  stage.load(pw, p, raw);
  stage.build(raw, sv);
#pragma unroll
  for (int k = 0; k < NV; ++k) pd[k * pw + p] = sv[k];
}

}  // namespace

// Launch on `stream`. st: (48, pw) f32 packed state; pd: (16, pw) f32
// operand out; the parameters as p2g_fused_launch's. Returns
// cudaGetLastError(), or WRONG_LIBRARY.
extern "C" int p2g_operand_launch(const float* st, long long pw, float* pd, float inv_dx,
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
  const long long blocks = (pw + OPERAND_THREADS - 1) / OPERAND_THREADS;
  if (blocks > 0) {
    operand_kernel<TMT_MATS><<<(unsigned)blocks, OPERAND_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        StageState<TMT_MATS>{st, prm}, pw, pd);
  }
  return static_cast<int>(cudaGetLastError());
#else
  return WRONG_LIBRARY;
#endif
}
