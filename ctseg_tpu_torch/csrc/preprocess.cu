// K4: the degree-2 train transform in one pass. Raw HU slices (N, H, W)
// float32 and per-sample draws (top, left, k, flip) -> an (N, S, S, 3)
// float32 batch, the NHWC view of a channels_last NCHW model input.
//
// Replaces: ctseg_tpu/ops/pallas/preprocess.py::fused_window_normalize (HU
// windowing x3 + per-channel normalize), extended by the moves of
// ctseg_tpu/transforms/pipelines.py::_degree_2 that sit between the two:
// random crop to S, rot90 by k, then a flip of W. Those moves only relocate
// pixels, so each output pixel reads the one source pixel they map it to:
//   j1 = flip ? S-1-j : j                    (flip of the rotated crop)
//   k=0: (r, c) = (i, j1)          k=1: (r, c) = (j1, S-1-i)
//   k=2: (r, c) = (S-1-i, S-1-j1)  k=3: (r, c) = (S-1-j1, i)
//   source = (top + r, left + c)             (np.rot90's index map)
// and runs, per window, clip to [lo, hi], (v - lo) / den, (v - mean) / std
// with the float32 constants the wrapper passes (den = hi - lo + 1e-8 as
// float32). Each step is one IEEE operation (true division, no multiply-add
// to contract), so the output equals the plain torch chain bit for bit.
// With identity draws (top = left = k = flip = 0, S = H = W) it is exactly
// fused_window_normalize.
//
// What bounds it on an H100: memory; 4 bytes read and 12 written per output
// pixel, a few flops. One thread per output pixel; a warp writes 384
// contiguous bytes. Reads are a gather: contiguous rows for k in {0, 2},
// a column walk for k in {1, 3}, served from L2 (a 280x280 slice is 314 KB).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWindows = 3;
constexpr int kParams = 5;  // lo, hi, den, mean, std per window

__global__ void __launch_bounds__(kThreads)
    window_normalize_kernel(const float* __restrict__ images,
                            const int* __restrict__ top,
                            const int* __restrict__ left,
                            const int* __restrict__ rot,
                            const int* __restrict__ flip,
                            const float* __restrict__ params,
                            float* __restrict__ out, int h, int w, int s) {
  const int n = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= s * s) return;
  const int i = pix / s;
  const int j = pix - i * s;
  const int j1 = flip[n] ? s - 1 - j : j;
  int r, c;
  switch (rot[n] & 3) {
    case 0: r = i; c = j1; break;
    case 1: r = j1; c = s - 1 - i; break;
    case 2: r = s - 1 - i; c = s - 1 - j1; break;
    default: r = s - 1 - j1; c = i; break;
  }
  float* o = out + (static_cast<size_t>(n) * s * s + pix) * kWindows;
  const int y = top[n] + r;
  const int x = left[n] + c;
  if (y < 0 || y >= h || x < 0 || x >= w) {
    // A draw outside the slice: no read out of bounds, and a NaN that the
    // loss cannot hide.
    for (int ch = 0; ch < kWindows; ++ch) o[ch] = __int_as_float(0x7fc00000);
    return;
  }
  const float v = images[(static_cast<size_t>(n) * h + y) * w + x];
#pragma unroll
  for (int ch = 0; ch < kWindows; ++ch) {
    const float* p = params + ch * kParams;
    const float lo = p[0], hi = p[1];
    // torch.clamp: NaN passes through.
    const float clipped = v < lo ? lo : (v > hi ? hi : v);
    const float shifted = (clipped - lo) / p[2];
    o[ch] = (shifted - p[3]) / p[4];
  }
}

}  // namespace

// images: (n, h, w) float32; top, left, rot, flip: (n,) int32; params:
// (3, 5) float32 (lo, hi, den, mean, std per window); out: (n, s, s, 3)
// float32. All on the device, contiguous. A draw that reaches outside the
// slice gives NaN pixels. Launches on `stream`, allocates nothing.
extern "C" int ctseg_window_normalize(const void* images, const void* top,
                                      const void* left, const void* rot,
                                      const void* flip, const void* params,
                                      void* out, int n, int h, int w, int s,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((s * s + kThreads - 1) / kThreads, n);
  window_normalize_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), static_cast<const int*>(top),
      static_cast<const int*>(left), static_cast<const int*>(rot),
      static_cast<const int*>(flip), static_cast<const float*>(params),
      static_cast<float*>(out), h, w, s);
  return cudaGetLastError();
}
