// Shared helpers of the port's kernels: storage types, PReLU, 16-byte
// cp.async, and the per-channel column sum of K2's FP32-pipe norm.
//
// Storage is float or __nv_bfloat16; all arithmetic is float32, like the
// Pallas kernels these replace (statistics stay f32 under bf16 compute).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Two floats rounded to nearest even into one 32-bit pair of bfloat16, the
// first in the low half (the lower address).
__device__ __forceinline__ unsigned int pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&h);
}

// jnp.where(xhat >= 0, xhat, alpha * xhat): NaN takes the alpha branch.
__device__ __forceinline__ float prelu(float v, float alpha) {
  return v >= 0.f ? v : alpha * v;
}

// 16 bytes global -> shared, or 16 zero bytes when !pred (src is then only
// required to be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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
