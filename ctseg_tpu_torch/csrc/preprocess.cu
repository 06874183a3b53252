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
// float32). Each step is one correctly rounded IEEE operation (no rounding
// more, no multiply-add to contract), so the output equals the plain torch
// chain bit for bit. With identity draws (top = left = k = flip = 0, S = H =
// W) it is exactly fused_window_normalize.
//
// The two divisions by constants are correctly rounded quotients computed
// from the correctly rounded reciprocal y = RN(1 / b) that the wrapper passes
// (div_rn): q = RN(a y), then twice q + RN(a - b q) y with the remainder by
// a fused multiply-add. The first correction leaves q within half an ulp and
// a hair of a / b; so the second one's remainder is exact and, by
// Markstein's theorem (y within half an ulp of 1 / b, q faithful), its
// result is a / b correctly rounded, for a numerator of 0, NaN, or a
// magnitude in [2^-64, 2^64] (no quotient or remainder leaves the normal
// range). The wrapper's constants make every numerator so (ops/
// preprocess.py::_params checks them) except where the value itself is
// nonzero and below 2^-64 in magnitude: such a pixel takes IEEE divisions
// in a function out of line (windows_ieee). chip_smoke.py holds the kernel
// to the plain version at every float32 input value in the windows' span.
// An IEEE division is some ten instructions, two of them on the slow
// multi-function pipe (the reciprocal and the range check); this is five
// fused ones. On an H100 the six IEEE divisions of a pixel were what bound
// the kernel (csrc/tools/variants_scan_k4.py times it with them, with
// products in their place, and with no arithmetic at all).
//
// What bounds it on an H100: memory, 4 bytes read and 12 written per output
// pixel, then the instructions spent per pixel. One block per (sample,
// T x T output tile), T = kTile. The map is affine in (i, j), so a tile's
// sources form one T x T square of the crop for every (k, flip), whose
// origin (r0, c0) the block computes from the draws (tile_origin;
// ops/preprocess.py models it). The block loads the square with coalesced
// row reads into shared memory padded by one column, so the column walk of
// k in {1, 3} reads it without bank conflicts; each thread maps 4
// consecutive output pixels of a row to their (r, c), computes the three
// windows and stages the 12 floats in shared memory; then consecutive
// threads write each tile row's 3T floats as 16-byte stores. Ragged tiles
// (S no multiple of T) are masked; S no multiple of 4 stores float by float.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // the output tile's side (64 measured no faster)
constexpr int kWindows = 3;
constexpr int kParams = 7;  // lo, hi, den, mean, std, 1 / den, 1 / std

// a / b rounded to nearest even, from y = RN(1 / b), for a numerator of 0,
// NaN or a magnitude in [2^-64, 2^64] (see above).
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q0 = __fmul_rn(a, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, b, a), y, q0);
  return __fmaf_rn(__fmaf_rn(-q1, b, a), y, q1);
}

// torch.clamp(v, lo, hi): NaN passes through.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(r), "f"(hi));
  return r;
}

// The three windows of v by IEEE divisions, for a value nonzero and below
// 2^-64 in magnitude. Out of line, so that the common path carries none of
// it.
__device__ __noinline__ float3 windows_ieee(float v,
                                            const float* __restrict__ params) {
  float r[kWindows];
#pragma unroll
  for (int ch = 0; ch < kWindows; ++ch) {
    const float* p = params + ch * kParams;
    const float shifted = __fdiv_rn(clamp_nan(v, p[0], p[1]) - p[0], p[2]);
    r[ch] = __fdiv_rn(shifted - p[3], p[4]);
  }
  return make_float3(r[0], r[1], r[2]);
}

// The square of the crop that output tile (i0, j0) of size t reads: its
// top-left (r0, c0) under rot90 by k and the flip.
__device__ __forceinline__ void tile_origin(int k, bool flip, int i0, int j0,
                                            int s, int t, int& r0, int& c0) {
  const int jlo = flip ? s - j0 - t : j0;  // the smallest j1 of the tile
  switch (k) {
    case 0: r0 = i0; c0 = jlo; break;
    case 1: r0 = jlo; c0 = s - i0 - t; break;
    case 2: r0 = s - i0 - t; c0 = s - jlo - t; break;
    default: r0 = s - jlo - t; c0 = i0; break;
  }
}

// Grid: (tiles * tiles, n) blocks of kThreads, tiles = ceil(s / T). Shared
// memory: the T x (T + 1) square, then T rows of 3T staged floats.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    window_normalize_kernel(const float* __restrict__ images,
                            const int* __restrict__ top,
                            const int* __restrict__ left,
                            const int* __restrict__ rot,
                            const int* __restrict__ flip,
                            const float* __restrict__ params,
                            float* __restrict__ out, int h, int w, int s,
                            int tiles) {
  constexpr int T = kTile;
  __shared__ float4 smem4[(T * (T + 1) + 3 * T * T) / 4];
  float(*square)[T + 1] = reinterpret_cast<float(*)[T + 1]>(smem4);
  float* stage = reinterpret_cast<float*>(smem4) + T * (T + 1);
  const int n = blockIdx.y;
  const int i0 = blockIdx.x / tiles * T;
  const int j0 = (blockIdx.x % tiles) * T;
  const int k = rot[n] & 3;
  const bool fl = flip[n] != 0;
  const int ty = top[n], tx = left[n];
  int r0, c0;
  tile_origin(k, fl, i0, j0, s, T, r0, c0);

  const float* img = images + static_cast<size_t>(n) * h * w;
  for (int e = threadIdx.x; e < T * T; e += kThreads) {
    const int a = e / T, b = e % T;
    const int r = r0 + a, c = c0 + b, y = ty + r, x = tx + c;
    float v = 0.f;  // outside the crop or the slice: never used
    if (r >= 0 && r < s && c >= 0 && c < s && y >= 0 && y < h && x >= 0 &&
        x < w) {
      v = img[static_cast<size_t>(y) * w + x];
    }
    square[a][b] = v;
  }
  float lo[kWindows], hi[kWindows], den[kWindows], mean[kWindows],
      sd[kWindows], rden[kWindows], rsd[kWindows];
#pragma unroll
  for (int ch = 0; ch < kWindows; ++ch) {
    lo[ch] = params[ch * kParams];
    hi[ch] = params[ch * kParams + 1];
    den[ch] = params[ch * kParams + 2];
    mean[ch] = params[ch * kParams + 3];
    sd[ch] = params[ch * kParams + 4];
    rden[ch] = params[ch * kParams + 5];
    rsd[ch] = params[ch * kParams + 6];
  }
  __syncthreads();

  constexpr int kQuads = T / 4;  // groups of 4 pixels in a tile row
  for (int q = threadIdx.x; q < T * kQuads; q += kThreads) {
    const int a = q / kQuads, b0 = q % kQuads * 4;
    const int i = i0 + a;
    float vals[4 * kWindows];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + b0 + u;
      const int j1 = fl ? s - 1 - j : j;
      int r, c;
      switch (k) {
        case 0: r = i; c = j1; break;
        case 1: r = j1; c = s - 1 - i; break;
        case 2: r = s - 1 - i; c = s - 1 - j1; break;
        default: r = s - 1 - j1; c = i; break;
      }
      // In [0, T) for every pixel of the tile, ragged ones too.
      const float v = square[r - r0][c - c0];
      const int y = ty + r, x = tx + c;
      const bool outside = y < 0 || y >= h || x < 0 || x >= w;
      float win[kWindows];
      if (fabsf(v) < 0x1p-64f && v != 0.f) {
        const float3 ieee = windows_ieee(v, params);
        win[0] = ieee.x, win[1] = ieee.y, win[2] = ieee.z;
      } else {
#pragma unroll
        for (int ch = 0; ch < kWindows; ++ch) {
          const float shifted = div_rn(clamp_nan(v, lo[ch], hi[ch]) - lo[ch],
                                       den[ch], rden[ch]);
          win[ch] = div_rn(shifted - mean[ch], sd[ch], rsd[ch]);
        }
      }
      // A draw outside the slice: no read out of bounds, and a NaN that the
      // loss cannot hide.
#pragma unroll
      for (int ch = 0; ch < kWindows; ++ch) {
        vals[u * kWindows + ch] = outside ? __int_as_float(0x7fc00000) : win[ch];
      }
    }
    float4* st = reinterpret_cast<float4*>(stage + a * 3 * T + 3 * b0);
    st[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    st[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
    st[2] = make_float4(vals[8], vals[9], vals[10], vals[11]);
  }
  __syncthreads();

  const int rows = min(T, s - i0), cols = min(T, s - j0);
  float* dst = out + (static_cast<size_t>(n) * s + i0) * s * kWindows +
               static_cast<size_t>(j0) * kWindows;
  const size_t row_stride = static_cast<size_t>(s) * kWindows;
  if (kVec) {  // s % 4 == 0: a row's 3 * cols floats are whole float4s
    constexpr int kRow = 3 * T / 4;
    const int used = 3 * cols / 4;
    for (int e = threadIdx.x; e < rows * kRow; e += kThreads) {
      const int a = e / kRow, q = e % kRow;
      if (q < used) {
        reinterpret_cast<float4*>(dst + a * row_stride)[q] =
            reinterpret_cast<const float4*>(stage + a * 3 * T)[q];
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * 3 * T; e += kThreads) {
      const int a = e / (3 * T), f = e % (3 * T);
      if (f < 3 * cols) dst[a * row_stride + f] = stage[a * 3 * T + f];
    }
  }
}

}  // namespace

// images: (n, h, w) float32; top, left, rot, flip: (n,) int32; params:
// (3, 7) float32 (lo, hi, den, mean, std, RN(1 / den), RN(1 / std) per
// window); out: (n, s, s, 3)
// float32. All on the device, contiguous. A draw that reaches outside the
// slice gives NaN pixels. Launches on `stream`, allocates nothing.
extern "C" int ctseg_window_normalize(const void* images, const void* top,
                                      const void* left, const void* rot,
                                      const void* flip, const void* params,
                                      void* out, int n, int h, int w, int s,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || n > 65535 || s <= 0) return cudaErrorInvalidValue;
  const bool vec = s % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int tiles = (s + kTile - 1) / kTile;
  const dim3 grid(tiles * tiles, n);
  auto* kernel = vec ? window_normalize_kernel<true>
                     : window_normalize_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), static_cast<const int*>(top),
      static_cast<const int*>(left), static_cast<const int*>(rot),
      static_cast<const int*>(flip), static_cast<const float*>(params),
      static_cast<float*>(out), h, w, s, tiles);
  return cudaGetLastError();
}
