// Shared-memory probe: the SM cycles that one warp-wide shared load takes,
// for the load patterns of the P2G accumulation (taichi_mpm_torch/csrc/
// p2g.cu): a broadcast of 16, 8 or 4 bytes (the staged values), 32 lanes
// of float4 on 32 consecutive float4, 27 lanes of float4 at a tile's
// 3x3x3 support in the kernel's layout (51 i + 7 j + k, lanes in the order
// of kLaneOffset) and in the dense one (49 i + 7 j + k, lanes in order),
// and 27 lanes reading 3 distinct words (the weights of one axis).
//
//   nvcc -O3 -gencode arch=compute_90a,code=sm_90a -o /tmp/smem_probe tools/smem_probe.cu
//   /tmp/smem_probe
//
// Two blocks of 1,024 threads per SM loop 16,384 times over one load and
// an add; the time over the loads per SM, in cycles at the card's clock
// rate, is an upper bound of a load's cost: the loop's own instructions
// set a floor, which the cheapest pattern (the 4-byte broadcast) shows.
#include <cstdio>
#include <cuda_runtime.h>
__constant__ unsigned char kPerm[32] = {0,1,2,9,10,11,6,3,4,5,12,13,14,21,18,7,8,15,16,17,24,25,22,19,20,26,23,0,0,0,0,0};
template <int MODE>
__global__ void probe(float* out, int iters) {
  __shared__ float4 s[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) s[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int o = kPerm[lane];
  const int off51 = 51 * (o / 9) + 7 * ((o / 3) % 3) + o % 3;
  const int off49 = 49 * (lane / 9) + 7 * ((lane / 3) % 3) + lane % 3;
  unsigned base = (unsigned)__cvta_generic_to_shared(s);
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int c = (it * 37) & 1023;
    float a = 0, b = 0, cc = 0, d = 0;
    if (MODE == 0) {  // LDS.128 broadcast
      asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];" : "=f"(a), "=f"(b), "=f"(cc), "=f"(d) : "r"(base + c * 16));
    } else if (MODE == 1) {  // LDS.32 broadcast
      asm volatile("ld.shared.f32 %0, [%1];" : "=f"(a) : "r"(base + c * 16));
    } else if (MODE == 2) {  // LDS.128, 32 lanes contiguous
      asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];" : "=f"(a), "=f"(b), "=f"(cc), "=f"(d) : "r"(base + (c + lane) * 16));
    } else if (MODE == 3) {  // LDS.128, 27 lanes at the 51/7/1 layout, permuted
      if (lane < 27) asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];" : "=f"(a), "=f"(b), "=f"(cc), "=f"(d) : "r"(base + (c + off51) * 16));
    } else if (MODE == 4) {  // LDS.128, 27 lanes at the dense 49/7/1 layout
      if (lane < 27) asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];" : "=f"(a), "=f"(b), "=f"(cc), "=f"(d) : "r"(base + (c + off49) * 16));
    } else if (MODE == 5) {  // LDS.32, 3 distinct words among 27 lanes
      if (lane < 27) asm volatile("ld.shared.f32 %0, [%1];" : "=f"(a) : "r"(base + c * 16 + 4 * (o / 9)));
    } else if (MODE == 6) {  // LDS.64 broadcast
      asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];" : "=f"(a), "=f"(b) : "r"(base + c * 16));
    }
    acc += a + b + cc + d;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
template <int MODE>
void run(const char* name, float* out, int sms) {
  const int iters = 1 << 14, blocks = sms * 2, threads = 1024;
  probe<MODE><<<blocks, threads>>>(out, 16);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  probe<MODE><<<blocks, threads>>>(out, iters);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  int clk; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  const double warp_instr_per_sm = (double)blocks * threads / 32 * iters / sms;
  printf("%-40s %8.3f ms  %6.3f cycles per warp-load per SM (at %d MHz)\n", name, ms,
         ms * 1e-3 * clk * 1e3 / warp_instr_per_sm, clk / 1000);
}
int main() {
  float* out; cudaMalloc(&out, 1 << 24);
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run<0>("LDS.128 broadcast", out, sms);
  run<6>("LDS.64 broadcast", out, sms);
  run<1>("LDS.32 broadcast", out, sms);
  run<2>("LDS.128 32 lanes contiguous", out, sms);
  run<3>("LDS.128 27 lanes 51/7/1 permuted", out, sms);
  run<4>("LDS.128 27 lanes 49/7/1", out, sms);
  run<5>("LDS.32 27 lanes 3 words", out, sms);
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
