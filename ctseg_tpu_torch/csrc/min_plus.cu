// K5: one separable pass of the exact squared Euclidean distance transform,
//   out[b, i, l] = min(BIG, min_k ((scale[b] * (i - k))^2 + x[b, k, l]))
// over a batch of (K, L) float32 slabs, one float32 scale per slab.
//
// Replaces: ctseg_tpu/ops/pallas/min_plus.py::min_plus_2d (_min_plus_kernel),
// which keeps a (K, 1024) slab in VMEM and walks 32x8 tiles on the VPU; the
// batch replaces the callers' vmap. Bit-equal to it and to the plain all-pairs
// form by construction: per pair the same three roundings (the product
// scale * (i - k), its square, the sum with x; i - k is exact), then `min`,
// which rounds nothing and does not care about order.
//   - The cost (scale * (i - k))^2 depends on |i - k| only (negating a
//     float is exact), so a block computes it once per distance into a shared
//     table with __fmul_rn; the inner loop is one __fadd_rn and one fminf per
//     pair, and nothing is left for nvcc to contract into a multiply-add.
//   - The accumulator starts at BIG = float32(1e12), so no output exceeds it.
//     Rows padded up to a multiple of kRows hold BIG and never win a min.
// Inputs hold no NaN (distances and BIG).
//
// What bounds it on an H100: operations. K*K*B*L pairs against 2*K*B*L
// floats moved: at K = 256 that is 64 (add, min) pairs per byte. One block
// per (slab, 32-column tile): the (K, 32) tile goes to shared memory once,
// lanes run along l (coalesced, conflict-free), each warp owns groups of
// kRows output rows held in registers and walks k in steps of kRows: 2*kRows-1
// broadcast loads of the cost table and kRows loads of x feed kRows*kRows
// pairs. No padding in device memory: edges are guarded.
#include "common.cuh"

namespace {

constexpr int kTile = 32;   // columns per block, threadIdx.x
constexpr int kWarps = 8;   // threadIdx.y
constexpr int kRows = 8;    // output rows per thread, and k rows per step
constexpr float kBig = 1e12f;
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90

__host__ __device__ constexpr int padded(int k) {
  return (k + kRows - 1) / kRows * kRows;
}

__global__ void __launch_bounds__(kTile * kWarps)
    min_plus_kernel(const float* __restrict__ x,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int k_dim, int l_dim, int tiles) {
  extern __shared__ float smem[];
  const int kp = padded(k_dim);
  float* xs = smem;                 // (kp, kTile)
  float* cost = smem + kp * kTile;  // (kp,): (scale * d)^2 for d = |i - k|

  const int b = blockIdx.x / tiles;
  const int col = (blockIdx.x - b * tiles) * kTile + threadIdx.x;
  const bool in_l = col < l_dim;
  const size_t base = static_cast<size_t>(b) * k_dim * l_dim + col;
  const float s = scale[b];

  for (int k = threadIdx.y; k < kp; k += kWarps) {
    xs[k * kTile + threadIdx.x] =
        (k < k_dim && in_l) ? x[base + static_cast<size_t>(k) * l_dim] : kBig;
  }
  for (int d = threadIdx.y * kTile + threadIdx.x; d < kp;
       d += kTile * kWarps) {
    const float sd = __fmul_rn(s, static_cast<float>(d));
    cost[d] = __fmul_rn(sd, sd);
  }
  __syncthreads();

  for (int i0 = threadIdx.y * kRows; i0 < kp; i0 += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = kBig;
    for (int kb = 0; kb < kp; kb += kRows) {
      // Row i0 + r against row kb + j is at distance |d0 + (kRows - 1) + r - j|.
      const int d0 = i0 - kb - (kRows - 1);
      float c[2 * kRows - 1];
#pragma unroll
      for (int t = 0; t < 2 * kRows - 1; ++t) c[t] = cost[abs(d0 + t)];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float xk = xs[(kb + j) * kTile + threadIdx.x];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r] = fminf(acc[r], __fadd_rn(c[kRows - 1 + r - j], xk));
        }
      }
    }
    if (in_l) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < k_dim) {
          out[base + static_cast<size_t>(i0 + r) * l_dim] = acc[r];
        }
      }
    }
  }
}

}  // namespace

// x, out: (b, k, l) float32; scale: (b,) float32. All on the device,
// contiguous; out may not alias x. Launches on `stream`, allocates nothing.
// k is limited by the shared memory of one block (1760 rows).
extern "C" int ctseg_min_plus(const void* x, const void* scale, void* out,
                              int b, int k, int l, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int tiles = (l + kTile - 1) / kTile;
  const size_t shared = static_cast<size_t>(padded(k)) * (kTile + 1) * sizeof(float);
  if (b <= 0 || k <= 0 || l <= 0 || shared > kMaxShared ||
      static_cast<long long>(b) * tiles > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(min_plus_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxShared);
  if (err != cudaSuccess) return err;
  min_plus_kernel<<<b * tiles, dim3(kTile, kWarps), shared,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<float*>(out), k, l, tiles);
  return cudaGetLastError();
}
