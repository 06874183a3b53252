// K1 forward: InstanceNorm(affine=False, eps=1e-5) + PReLU(one shared alpha)
// over an (N, S, C)-contiguous tensor (S = H*W, channels fastest: the NHWC
// view of a channels_last activation).
//
// Replaces: ctseg_tpu/ops/pallas/instance_norm.py::fused_instance_norm_prelu,
// forward (_forward: _fwd_resident, or _stats_stream + _normalize_stream).
// Same statistics: one pass, E[x] and E[x^2] in float32, var = E[x^2]-E[x]^2
// clamped at 0, xhat = (x - mean) * rsqrt(var + eps), y = PReLU(xhat) stored
// in x's type.
//
// What bounds it on an H100: memory. It does a few flops per element and
// reads x twice (stats, then normalize) and writes y once: three transfers
// of the element size per element. The TPU kernel kept a whole (H, W, C-tile) slab in VMEM to
// read x once; a Hopper SM has 227 KB of shared memory, less than one
// 128x128x64 slab, so the second read comes from L2 or HBM instead.
//
// Design: one block per (sample, 32-channel tile). The 32 lanes of a warp
// take 32 neighbouring channels of one pixel, so every load is one coalesced
// segment; the 16 warps stride over the pixels, which replaces the TPU's
// sequential H grid. A column sum in shared memory combines the 16 partials.
// Known weakness, left for a later change: at (32, 256, 256, 10) this is 32
// blocks for 132 SMs, with 22 of 32 lanes idle. A split-spatial two-phase
// reduction is the fix.
#include "common.cuh"

namespace {

constexpr int kTileC = 32;  // channels per block: one per lane
constexpr int kRows = 16;   // warps per block, striding over pixels

template <typename T>
__global__ void __launch_bounds__(kTileC * kRows)
    in_prelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                        const float* __restrict__ alpha, int s, int c) {
  __shared__ float buf[kRows][32];
  const int ch = blockIdx.x * kTileC + threadIdx.x;
  const bool active = ch < c;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * c + ch;

  float sum = 0.f;
  float sum_sq = 0.f;
  if (active) {
    for (int p = threadIdx.y; p < s; p += kRows) {
      const float v = ctseg::to_float(x[base + static_cast<size_t>(p) * c]);
      sum += v;
      sum_sq += v * v;
    }
  }
  sum = ctseg::column_sum<kRows>(sum, buf);
  sum_sq = ctseg::column_sum<kRows>(sum_sq, buf);
  if (!active) return;

  const float mean = sum / static_cast<float>(s);
  const float d = sum_sq / static_cast<float>(s) - mean * mean;
  const float var = d < 0.f ? 0.f : d;  // clamp; NaN passes like jnp.maximum
  const float inv = rsqrtf(var + ctseg::kEps);
  const float a = alpha[0];
  for (int p = threadIdx.y; p < s; p += kRows) {
    const size_t i = base + static_cast<size_t>(p) * c;
    const float xhat = (ctseg::to_float(x[i]) - mean) * inv;
    y[i] = ctseg::from_float<T>(ctseg::prelu(xhat, a));
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const void* alpha, int n, int s,
                   int c, cudaStream_t stream) {
  const dim3 grid((c + kTileC - 1) / kTileC, n);
  const dim3 block(kTileC, kRows);
  in_prelu_fwd_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const float*>(alpha), s, c);
  return cudaGetLastError();
}

}  // namespace

// x, y: (n, s, c) contiguous, of the type `dtype` names; alpha: one float32
// on the device. Launches on `stream`, allocates nothing, returns the
// launch's cudaError_t.
extern "C" int ctseg_in_prelu_fwd(const void* x, void* y, const void* alpha,
                                  int n, int s, int c, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch<float>(x, y, alpha, n, s, c, st);
    case ctseg::kBFloat16:
      return launch<__nv_bfloat16>(x, y, alpha, n, s, c, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ctseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
