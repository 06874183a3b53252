// K2: PReLU(InstanceNorm(conv3x3_same(x, w) + b)), NHWC, forward and the
// fused PReLU + InstanceNorm backward.
//
// Replaces: ctseg_tpu/ops/pallas/conv_block.py::fused_conv3x3_in_prelu,
// forward (_run_forward / _fwd_kernel), and with it the float32 prototype
// ctseg_tpu/ops/pallas/conv_fused.py::conv3x3_in_prelu (same function); and
// conv_block.py::in_prelu_bwd (_bwd_kernel), the backward from the saved
// residuals. Same arithmetic: products of the stored values accumulated in
// float32, + bias, then TWO-pass statistics per (sample, channel): mean,
// then the centred variance mean((y - mean)^2), rsqrt(var + eps), PReLU.
// The training forward (train=True) also writes xhat in x's type and rsinv
// = rsqrt(var + eps) as (N, Cout) float32, so the backward never re-runs the
// convolution:
//   gh = g * (xhat >= 0 ? 1 : alpha)
//   dy = rsinv * (gh - mean(gh) - xhat * mean(gh * xhat))
//   dalpha = sum(g * min(xhat, 0)), as per-(sample, channel-tile) partials.
// The conv's own gradients (dx, dw, db from dy) are cuDNN's, as the JAX rule
// leaves them to XLA.
//
// What bounds it on an H100: at the UNet's widths the conv is compute-bound
// (2*9*Cin flops per output against 4 bytes written; 4.8 GFLOP per slice at
// the 16x16, 1024->1024 bottom site), and the norm and its backward are
// memory-bound. This first version runs the conv on the FP32 pipes (no
// tensor cores), as an implicit GEMM: M = N*H*W output pixels, N = Cout,
// K = 9*Cin taken tap by tap. Each 256-thread block computes a 128-pixel x
// 64-channel tile; each step stages a 128 x 16 slice of the (zero-padded)
// input and a 16 x 64 slice of the weights in shared memory, and every
// thread accumulates an 8 x 4 register tile, so each staged value is reused
// 64 or 128 times. The conv output goes to a float32 scratch (the TPU kept
// it in VMEM; a per-sample slab is up to 4 MB here, beyond shared memory),
// and a second kernel reads it three times (mean, variance, normalize) in
// coalesced 32-channel rows. The backward kernel reads g and xhat twice
// (sums, then dy) and writes dy once, one block per (sample, 32 channels).
// wgmma on bf16 inputs, TMA staging and keeping the statistics in the
// conv's epilogue are later work.
#include "common.cuh"

namespace {

constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // input channels per step
constexpr int kTM = 8;    // pixels per thread
constexpr int kTN = 4;    // output channels per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;   // As row padding, keeps float4 rows aligned
constexpr int kAPerThread = kBM * kBK / kThreads;    // 8
constexpr int kBPerThread = kBK * kBN / kThreads;    // 4
static_assert(kThreads % kBK == 0 && kThreads % kBN == 0, "loader layout");

// out[m, co] = b[co] + sum_{tap, ci} x[pixel m shifted by tap, ci] * w[tap, ci, co]
// x: (n, h, wd, cin); w: (3, 3, cin, cout); out: (n*h*wd, cout) float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_bias_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int n, int h, int wd,
                        int cin, int cout) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int hw = h * wd;
  const int total = n * hw;
  const int m0 = blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;

  // Input loader: this thread stages input channel (tid % kBK) of pixels
  // tid / kBK + j * (kThreads / kBK); 16 lanes read 16 neighbouring channels.
  const int a_ci = tid % kBK;
  int a_img[kAPerThread];  // first pixel of the sample, in pixels
  int a_y[kAPerThread];
  int a_x[kAPerThread];
#pragma unroll
  for (int j = 0; j < kAPerThread; ++j) {
    const int m = m0 + tid / kBK + j * (kThreads / kBK);
    if (m < total) {
      const int img = m / hw;
      const int rem = m - img * hw;
      a_img[j] = img * hw;
      a_y[j] = rem / wd;
      a_x[j] = rem - (rem / wd) * wd;
    } else {
      a_img[j] = 0;
      a_y[j] = -4;  // every tap lands outside the image: loads zero
      a_x[j] = -4;
    }
  }
  // Weight loader: output channel (tid % kBN) of input channels
  // tid / kBN + j * (kThreads / kBN); a warp reads 32 neighbouring channels.
  const int b_co = tid % kBN;

  // Compute layout: pixels tm*kTM.. and output channels tn*kTN...
  const int tn = tid % (kBN / kTN);
  const int tm = tid / (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < cin; c0 += kBK) {
      const int ci = c0 + a_ci;
#pragma unroll
      for (int j = 0; j < kAPerThread; ++j) {
        const int yy = a_y[j] + dy;
        const int xx = a_x[j] + dx;
        float v = 0.f;
        if (ci < cin && yy >= 0 && yy < h && xx >= 0 && xx < wd) {
          v = ctseg::to_float(
              x[static_cast<size_t>(a_img[j] + yy * wd + xx) * cin + ci]);
        }
        As[a_ci][tid / kBK + j * (kThreads / kBK)] = v;
      }
#pragma unroll
      for (int j = 0; j < kBPerThread; ++j) {
        const int k = tid / kBN + j * (kThreads / kBN);
        const int co = co0 + b_co;
        float v = 0.f;
        if (c0 + k < cin && co < cout) {
          v = ctseg::to_float(
              w[(static_cast<size_t>(tap) * cin + c0 + k) * cout + co]);
        }
        Bs[k][b_co] = v;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][tm * kTM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[k][tm * kTM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tn * kTN]);
        const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[kTN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + tm * kTM + i;
    if (m >= total) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int co = co0 + tn * kTN + j;
      if (co < cout) {
        out[static_cast<size_t>(m) * cout + co] = acc[i][j] + bias[co];
      }
    }
  }
}

constexpr int kTileC = 32;  // channels per block: one per lane
constexpr int kRows = 16;   // warps per block, striding over pixels

// Two-pass InstanceNorm + PReLU of the float32 conv output, per (sample,
// 32-channel tile): mean, centred variance, then normalize and store in T.
// With xhat_out and rsinv_out (training), also stores xhat in T and rsinv.
template <typename T>
__global__ void __launch_bounds__(kTileC * kRows)
    in_prelu_two_pass_kernel(const float* __restrict__ y, T* __restrict__ out,
                             const float* __restrict__ alpha,
                             T* __restrict__ xhat_out,
                             float* __restrict__ rsinv_out, int s, int c) {
  __shared__ float buf[kRows][32];
  const int ch = blockIdx.x * kTileC + threadIdx.x;
  const bool active = ch < c;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * c + ch;

  float sum = 0.f;
  if (active) {
    for (int p = threadIdx.y; p < s; p += kRows) {
      sum += y[base + static_cast<size_t>(p) * c];
    }
  }
  const float mean = ctseg::column_sum<kRows>(sum, buf) / static_cast<float>(s);

  float sq = 0.f;
  if (active) {
    for (int p = threadIdx.y; p < s; p += kRows) {
      const float d = y[base + static_cast<size_t>(p) * c] - mean;
      sq += d * d;
    }
  }
  const float var = ctseg::column_sum<kRows>(sq, buf) / static_cast<float>(s);
  if (!active) return;

  const float rsinv = rsqrtf(var + ctseg::kEps);
  const float a = alpha[0];
  if (xhat_out != nullptr) {
    if (threadIdx.y == 0) {
      rsinv_out[static_cast<size_t>(blockIdx.y) * c + ch] = rsinv;
    }
    for (int p = threadIdx.y; p < s; p += kRows) {
      const size_t i = base + static_cast<size_t>(p) * c;
      const float xhat = (y[i] - mean) * rsinv;
      out[i] = ctseg::from_float<T>(ctseg::prelu(xhat, a));
      xhat_out[i] = ctseg::from_float<T>(xhat);
    }
    return;
  }
  for (int p = threadIdx.y; p < s; p += kRows) {
    const size_t i = base + static_cast<size_t>(p) * c;
    out[i] = ctseg::from_float<T>(ctseg::prelu((y[i] - mean) * rsinv, a));
  }
}

// K2b: the PReLU + InstanceNorm backward from the saved xhat and rsinv, per
// (sample, 32-channel tile); see ctseg::in_prelu_bwd_block.
template <typename T>
__global__ void __launch_bounds__(kTileC * kRows)
    in_prelu_bwd_saved_kernel(const T* __restrict__ g,
                              const T* __restrict__ xhat,
                              const float* __restrict__ rsinv,
                              const float* __restrict__ alpha,
                              T* __restrict__ dy,
                              float* __restrict__ dalpha_parts, int s, int c) {
  __shared__ float buf[kRows][32];
  const int ch = blockIdx.x * kTileC + threadIdx.x;
  const bool active = ch < c;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * c + ch;
  const float scale =
      active ? rsinv[static_cast<size_t>(blockIdx.y) * c + ch] : 0.f;
  const auto xhat_at = [=](size_t i) { return ctseg::to_float(xhat[i]); };
  ctseg::in_prelu_bwd_block<kRows>(
      g, dy, dalpha_parts + static_cast<size_t>(blockIdx.y) * gridDim.x +
                 blockIdx.x,
      xhat_at, scale, alpha[0], s, c, base, active, buf);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* alpha, void* scratch, void* out,
                   void* xhat_out, void* rsinv_out, int n, int h, int wd,
                   int cin, int cout, cudaStream_t stream) {
  const int total = n * h * wd;
  const dim3 conv_grid((total + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  conv3x3_bias_kernel<T><<<conv_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<float*>(scratch), n, h, wd,
      cin, cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 norm_grid((cout + kTileC - 1) / kTileC, n);
  in_prelu_two_pass_kernel<T><<<norm_grid, dim3(kTileC, kRows), 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<T*>(out),
      static_cast<const float*>(alpha), static_cast<T*>(xhat_out),
      static_cast<float*>(rsinv_out), h * wd, cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* xhat, const void* rsinv,
                       const void* alpha, void* dy, void* dalpha_parts, int n,
                       int s, int c, cudaStream_t stream) {
  const dim3 grid((c + kTileC - 1) / kTileC, n);
  in_prelu_bwd_saved_kernel<T><<<grid, dim3(kTileC, kRows), 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(xhat),
      static_cast<const float*>(rsinv), static_cast<const float*>(alpha),
      static_cast<T*>(dy), static_cast<float*>(dalpha_parts), s, c);
  return cudaGetLastError();
}

}  // namespace

// Forward. x: (n, h, wd, cin) and w: (3, 3, cin, cout), contiguous, of the
// type `dtype` names; bias: (cout,) float32; alpha: one float32; scratch:
// (n, h, wd, cout) float32; out: (n, h, wd, cout) of x's type. xhat_out
// (like out) and rsinv_out ((n, cout) float32) for the training forward, or
// both null (serving). All on the device. Launches both kernels on `stream`,
// allocates nothing, returns the first failing launch's cudaError_t.
extern "C" int ctseg_conv3x3_in_prelu_fwd(const void* x, const void* w,
                                          const void* bias, const void* alpha,
                                          void* scratch, void* out,
                                          void* xhat_out, void* rsinv_out,
                                          int n, int h, int wd, int cin,
                                          int cout, int dtype, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((xhat_out == nullptr) != (rsinv_out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch<float>(x, w, bias, alpha, scratch, out, xhat_out,
                           rsinv_out, n, h, wd, cin, cout, st);
    case ctseg::kBFloat16:
      return launch<__nv_bfloat16>(x, w, bias, alpha, scratch, out, xhat_out,
                                   rsinv_out, n, h, wd, cin, cout, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward (K2b). g, xhat, dy: (n, s, c) contiguous, of the type `dtype`
// names; rsinv: (n, c) float32; alpha: one float32; dalpha_parts:
// (n, ceil(c / 32)) float32, one partial per block.
extern "C" int ctseg_in_prelu_bwd_saved(const void* g, const void* xhat,
                                        const void* rsinv, const void* alpha,
                                        void* dy, void* dalpha_parts, int n,
                                        int s, int c, int dtype, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch_bwd<float>(g, xhat, rsinv, alpha, dy, dalpha_parts, n, s,
                               c, st);
    case ctseg::kBFloat16:
      return launch_bwd<__nv_bfloat16>(g, xhat, rsinv, alpha, dy,
                                       dalpha_parts, n, s, c, st);
    default:
      return cudaErrorInvalidValue;
  }
}
