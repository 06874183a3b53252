// The rate at which one H100 issues `mma.sync` (m16n8k8 tf32 and m16n8k16
// bf16), with independent accumulators and no memory traffic: the ceiling of
// a kernel built on that instruction, to set beside the published tensor-core
// peaks (which `wgmma` reaches). Not part of the library: build and run it
// alone on the card,
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate mma_rate.cu
//   ./mma_rate
// It prints, for 4 or 16 accumulators a warp and 4, 8 or 16 warps an SM, the
// TFLOP/s reached and the time one instruction holds a sub-core.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
template <int ACCS, bool BF16>
__global__ void bench(float* out, int iters) {
  float acc[ACCS][4];
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b[2] = {threadIdx.x * 3, threadIdx.x * 5};
  for (int i = 0; i < ACCS; ++i) for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ACCS; ++i) {
      if (BF16) {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0; for (int i = 0; i < ACCS; ++i) for (int r = 0; r < 4; ++r) s += acc[i][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int ACCS, bool BF16>
void run(int warps_per_sm, float* out) {
  int iters = 20000;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  bench<ACCS, BF16><<<132, warps_per_sm * 32>>>(out, 100);
  cudaEventRecord(e0);
  bench<ACCS, BF16><<<132, warps_per_sm * 32>>>(out, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double mmas_per_subcore = double(iters) * ACCS * warps_per_sm / 4.0;
  double flop = double(iters) * ACCS * warps_per_sm * 132 * (BF16 ? 4096.0 : 2048.0);
  printf("%s accs %2d warps/SM %2d: %.3f ms, %.1f TFLOP/s, %.2f ns per mma per sub-core (x1.755 GHz = %.2f clk)\n",
         BF16 ? "bf16 m16n8k16" : "tf32 m16n8k8 ", ACCS, warps_per_sm, ms, flop / ms / 1e9,
         ms * 1e6 / mmas_per_subcore, ms * 1e6 / mmas_per_subcore * 1.755);
}
int main() {
  float* out; cudaMalloc(&out, 132 * 1024 * 4);
  run<4, false>(8, out); run<16, false>(8, out); run<4, false>(16, out); run<16, false>(16, out); run<16,false>(4,out);
  run<4, true>(8, out); run<16, true>(8, out); run<4, true>(16, out); run<16, true>(16, out); run<16,true>(4,out);
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
