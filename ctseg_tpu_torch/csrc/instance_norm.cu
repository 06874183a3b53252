// K1: InstanceNorm(affine=False, eps=1e-5) + PReLU(one shared alpha) over an
// (N, S, C)-contiguous tensor (S = H*W, channels fastest: the NHWC view of a
// channels_last activation), forward and backward.
//
// Replaces: ctseg_tpu/ops/pallas/instance_norm.py::fused_instance_norm_prelu,
// forward (_forward: _fwd_resident, or _stats_stream + _normalize_stream) and
// backward (_bwd_rule: _bwd_resident, or _ghstats_stream + _dx_stream).
// Same statistics: one pass, E[x] and E[x^2] in float32, var = E[x^2]-E[x]^2
// clamped at 0, xhat = (x - mean) * rsqrt(var + eps), y = PReLU(xhat) stored
// in x's type. The training forward also writes the per-(sample, channel)
// float32 mean and var, the residuals of _fwd_rule; the backward recomputes
// xhat from the saved x, mean and var:
//   gh = g * (xhat >= 0 ? 1 : alpha)
//   dx = rsqrt(var + eps) * (gh - mean(gh) - xhat * mean(gh * xhat))
//   dalpha = sum(g * min(xhat, 0)), as per-(sample, channel-tile) partials
//   that the wrapper sums (the Pallas kernel's SMEM partials; no atomics).
//
// What bounds it on an H100: memory. The forward reads x twice (stats, then
// normalize) and writes y once; the backward reads x and g twice (sums, then
// dx) and writes dx once. The TPU kernel kept a whole (H, W, C-tile) slab in
// VMEM to read x once; a Hopper SM has 227 KB of shared memory, less than
// one 128x128x64 slab, so the second read comes from L2 or HBM instead.
//
// Design: one block per (sample, 32-channel tile). The 32 lanes of a warp
// take 32 neighbouring channels of one pixel, so every load is one coalesced
// segment; the 16 warps stride over the pixels, which replaces the TPU's
// sequential H grid. A column sum in shared memory combines the 16 partials.
// Known weakness, left for a later change: at (N, 256, 256, 10) this is N
// blocks with 22 of 32 lanes idle. A split-spatial two-phase reduction is
// the fix.
#include "common.cuh"

namespace {

constexpr int kTileC = 32;  // channels per block: one per lane
constexpr int kRows = 16;   // warps per block, striding over pixels

template <typename T>
__global__ void __launch_bounds__(kTileC * kRows)
    in_prelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                        const float* __restrict__ alpha,
                        float* __restrict__ mean_out,
                        float* __restrict__ var_out, int s, int c) {
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
  if (mean_out != nullptr && threadIdx.y == 0) {
    mean_out[static_cast<size_t>(blockIdx.y) * c + ch] = mean;
    var_out[static_cast<size_t>(blockIdx.y) * c + ch] = var;
  }
  const float inv = rsqrtf(var + ctseg::kEps);
  const float a = alpha[0];
  for (int p = threadIdx.y; p < s; p += kRows) {
    const size_t i = base + static_cast<size_t>(p) * c;
    const float xhat = (ctseg::to_float(x[i]) - mean) * inv;
    y[i] = ctseg::from_float<T>(ctseg::prelu(xhat, a));
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileC * kRows)
    in_prelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ mean,
                        const float* __restrict__ var,
                        const float* __restrict__ alpha, T* __restrict__ dx,
                        float* __restrict__ dalpha_parts, int s, int c) {
  __shared__ float buf[kRows][32];
  const int ch = blockIdx.x * kTileC + threadIdx.x;
  const bool active = ch < c;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * c + ch;
  const size_t stat = static_cast<size_t>(blockIdx.y) * c + ch;
  const float m = active ? mean[stat] : 0.f;
  const float inv = active ? rsqrtf(var[stat] + ctseg::kEps) : 0.f;
  const auto xhat_at = [=](size_t i) {
    return (ctseg::to_float(x[i]) - m) * inv;
  };
  ctseg::in_prelu_bwd_block<kRows>(
      g, dx, dalpha_parts + static_cast<size_t>(blockIdx.y) * gridDim.x +
                 blockIdx.x,
      xhat_at, inv, alpha[0], s, c, base, active, buf);
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, const void* alpha,
                       void* mean_out, void* var_out, int n, int s, int c,
                       cudaStream_t stream) {
  const dim3 grid((c + kTileC - 1) / kTileC, n);
  const dim3 block(kTileC, kRows);
  in_prelu_fwd_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const float*>(alpha), static_cast<float*>(mean_out),
      static_cast<float*>(var_out), s, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const void* mean,
                       const void* var, const void* alpha, void* dx,
                       void* dalpha_parts, int n, int s, int c,
                       cudaStream_t stream) {
  const dim3 grid((c + kTileC - 1) / kTileC, n);
  const dim3 block(kTileC, kRows);
  in_prelu_bwd_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(alpha), static_cast<T*>(dx),
      static_cast<float*>(dalpha_parts), s, c);
  return cudaGetLastError();
}

}  // namespace

// Forward. x, y: (n, s, c) contiguous, of the type `dtype` names; alpha: one
// float32 on the device. mean_out, var_out: (n, c) float32 for the training
// forward, or both null (serving: no extra writes). Launches on `stream`,
// allocates nothing, returns the launch's cudaError_t.
extern "C" int ctseg_in_prelu_fwd(const void* x, void* y, const void* alpha,
                                  void* mean_out, void* var_out, int n, int s,
                                  int c, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((mean_out == nullptr) != (var_out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch_fwd<float>(x, y, alpha, mean_out, var_out, n, s, c, st);
    case ctseg::kBFloat16:
      return launch_fwd<__nv_bfloat16>(x, y, alpha, mean_out, var_out, n, s,
                                       c, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward (K1b). x, g, dx: (n, s, c) contiguous, of the type `dtype`
// names; mean, var: (n, c) float32 from the training forward; alpha: one
// float32; dalpha_parts: (n, ceil(c / 32)) float32, one partial per block.
extern "C" int ctseg_in_prelu_bwd(const void* x, const void* g,
                                  const void* mean, const void* var,
                                  const void* alpha, void* dx,
                                  void* dalpha_parts, int n, int s, int c,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch_bwd<float>(x, g, mean, var, alpha, dx, dalpha_parts, n, s,
                               c, st);
    case ctseg::kBFloat16:
      return launch_bwd<__nv_bfloat16>(x, g, mean, var, alpha, dx,
                                       dalpha_parts, n, s, c, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ctseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
