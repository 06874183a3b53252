// Shared helpers of the port's kernels: storage types, PReLU, and the
// per-channel column sum that both InstanceNorm kernels reduce with.
//
// Storage is float or __nv_bfloat16; all arithmetic is float32, like the
// Pallas kernels these replace (statistics stay f32 under bf16 compute).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ctseg {

// Codes the Python wrappers pass for the storage type.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// InstanceNorm epsilon (torch InstanceNorm2d default, EPS in the Pallas ops).
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// jnp.where(xhat >= 0, xhat, alpha * xhat): NaN takes the alpha branch.
__device__ __forceinline__ float prelu(float v, float alpha) {
  return v >= 0.f ? v : alpha * v;
}

// Sum of `v` over threadIdx.y for each threadIdx.x column, for a block of
// (32, kRows) threads; every thread gets its column's total. `buf` is
// kRows x 32 floats of shared memory, free again when this returns.
template <int kRows>
__device__ __forceinline__ float column_sum(float v, float (*buf)[32]) {
  buf[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int stride = kRows / 2; stride > 0; stride >>= 1) {
    if (threadIdx.y < stride) {
      buf[threadIdx.y][threadIdx.x] += buf[threadIdx.y + stride][threadIdx.x];
    }
    __syncthreads();
  }
  const float total = buf[0][threadIdx.x];
  __syncthreads();
  return total;
}

}  // namespace ctseg

// Message for a cudaError_t code, for the Python wrappers' exceptions.
extern "C" const char* ctseg_error_string(int code);
