// K5: one separable pass of the exact squared Euclidean distance transform,
//   out[b, i, l] = min(BIG, min_k ((scale[b] * (i - k))^2 + x[b, k, l]))
// over a batch of (K, L) float32 slabs, one float32 scale per slab.
//
// Replaces: ctseg_tpu/ops/pallas/min_plus.py::min_plus_2d (_min_plus_kernel),
// which keeps a (K, 1024) slab in VMEM and walks 32x8 tiles on the VPU; the
// batch replaces the callers' vmap. Bit-equal to it and to the plain all-pairs
// form: every pair that is evaluated gets the same three roundings (the
// product scale * (i - k), its square, the sum with x; i - k is exact), then
// `min`, which rounds nothing and does not care about order; and every pair
// that is skipped provably cannot lower the minimum.
//   - The cost (scale * (i - k))^2 depends on |i - k| only (negating a
//     float is exact), so a block computes it once per distance into a shared
//     table with __fmul_rn; the inner loop is one __fadd_rn and one fminf per
//     pair, and nothing is left for nvcc to contract into a multiply-add.
//   - The accumulator starts at BIG = float32(1e12), so no output exceeds it.
//     Rows padded up to a multiple of kRows hold BIG and never win a min.
// Inputs hold no NaN (distances and BIG).
//
// What bounds it on an H100: the all-pairs form is bound by operations
// (K*K*B*L pairs against 2*K*B*L floats moved, 64 (add, min) pairs a byte at
// K = 256) and already issued near the FP32 pipes' rate, so this kernel does
// fewer pairs. Three prunings, each exact under float32 rounding because
// rounding is monotone (a <= b implies fl(a) <= fl(b)):
//   1. A row of the tile that is >= BIG in all 32 columns cannot win:
//      fl(cost + x) >= BIG, the accumulator's start and clamp. k runs over
//      [first, last] only, the tile's first and last row holding a value
//      below BIG (found while the tile is copied in). A tile with none
//      writes BIG.
//   2. k walks outward from the output rows, kRows rows a step to both
//      sides. The cost table is non-decreasing in the distance d, so with
//      xmin the tile's smallest value every pair at distance >= d gives at
//      least fl(cost[d] + xmin): once that is >= the largest accumulator of
//      the warp's kRows x 32 outputs, no farther row can lower any of them.
//      The largest accumulator is one __reduce_max_sync a step (on an
//      order-preserving integer key), so the warp stays converged.
//   3. Where kRows output rows are 0 in all columns and xmin >= 0, the
//      output is 0: cost[0] + 0 = 0 and nothing is below it.
// On distance maps (0 on the sites, BIG on rows without a site) a walk ends
// after the few rows that the largest distance in its 8 x 32 outputs spans.
// On an input where nothing can be pruned it does the all-pairs work plus one
// reduction a step. Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// phase 12; 2,304 maps of 256x256, one Model M step's): 0.531 ms on the
// step's own maps (4.841 ms as all pairs; its bytes' bound 0.361 ms, the
// all-pairs operations' 1.154 ms), 1.058 ms on random maps with a third of
// the entries at BIG, 3.763 ms where nothing can be pruned.
//
// One block per (slab, 32-column tile): the (K, 32) tile goes to shared memory
// once, lanes run along l (coalesced, conflict-free), each warp owns groups of
// kRows output rows held in registers; a step's 2*kRows-1 costs (one window
// serves the rows below and above) and 2*kRows loads of x feed 2*kRows*kRows
// pairs. No padding in device memory: edges are guarded.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTile = 32;   // columns per block, threadIdx.x
constexpr int kWarps = 8;   // threadIdx.y
constexpr int kRows = 8;    // output rows per thread, and k rows per step
constexpr float kBig = 1e12f;
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int padded(int k) {
  return (k + kRows - 1) / kRows * kRows;
}

// An integer that orders as the float does (no NaN): the bits of a
// non-negative float, the complemented magnitude of a negative one.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// kRows output rows against the kRows rows of x from `rows` on; c[t] is the
// cost at distance dmin + t, and row r meets row j at index kRows-1 + r - j
// (the rows below the outputs) or kRows-1 + j - r (`kUp`: the rows above).
template <bool kUp>
__device__ __forceinline__ void meet(float (&acc)[kRows],
                                     const float (&c)[2 * kRows - 1],
                                     const float* __restrict__ rows) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float xk = rows[j * kTile];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = kUp ? kRows - 1 + j - r : kRows - 1 + r - j;
      acc[r] = fminf(acc[r], __fadd_rn(c[t], xk));
    }
  }
}

// What a block knows of its tile after copying it in.
struct TileInfo {
  int fb, lb;    // first and last group of kRows rows holding a value < BIG
  float xmin;    // the smallest value
  bool none;     // every value >= BIG: the output is BIG
  bool nonneg;   // xmin >= 0
};

// Copies the (k_dim, kTile) tile at `base` into xs (kp rows, the padding at
// BIG) and finds its TileInfo. Called by the whole block; synchronises.
__device__ __forceinline__ TileInfo load_tile(const float* __restrict__ x,
                                              size_t base, bool in_l,
                                              int k_dim, int l_dim, int kp,
                                              float* xs, int (*found)[kWarps]) {
  const int lane = threadIdx.x;
  int first = INT_MAX, last = -1;
  float low = kBig;
  for (int k = threadIdx.y; k < kp; k += kWarps) {
    const float v =
        (k < k_dim && in_l) ? x[base + static_cast<size_t>(k) * l_dim] : kBig;
    xs[k * kTile + lane] = v;
    if (v < kBig) {
      first = min(first, k);
      last = k;
      low = fminf(low, v);
    }
  }
  first = __reduce_min_sync(kFull, first);
  last = __reduce_max_sync(kFull, last);
  const int low_key = __reduce_min_sync(kFull, order_key(low));
  if (lane == 0) {
    found[0][threadIdx.y] = first;
    found[1][threadIdx.y] = last;
    found[2][threadIdx.y] = low_key;
  }
  __syncthreads();
  int xmin_key = INT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first = min(first, found[0][w]);
    last = max(last, found[1][w]);
    xmin_key = min(xmin_key, found[2][w]);
  }
  __syncthreads();  // `found` may be written again
  TileInfo info;
  info.none = last < 0;
  info.fb = first / kRows;
  info.lb = last / kRows;
  // order_key is its own inverse.
  info.xmin = __int_as_float(order_key(__int_as_float(xmin_key)));
  info.nonneg = xmin_key >= 0;
  return info;
}

// The kRows outputs from row i0 on of the lane's column: the pruned search
// described at the top. Called by the whole warp.
__device__ __forceinline__ void search(const float* xs, const float* cost,
                                       const TileInfo& info, int i0,
                                       bool in_l, float (&acc)[kRows]) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = kBig;
  if (info.none) return;
  if (info.nonneg) {
    bool zero = true;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      zero = zero && xs[(i0 + r) * kTile + lane] == 0.f;
    }
    if (__all_sync(kFull, zero || !in_l)) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      return;
    }
  }
  const int ib = i0 / kRows;
  int t = max(0, max(info.fb - ib, ib - info.lb));  // to the nearest value
  if (t == 0) {
    float c[2 * kRows - 1];
#pragma unroll
    for (int u = 0; u < 2 * kRows - 1; ++u) {
      c[u] = cost[abs(u - (kRows - 1))];
    }
    meet<false>(acc, c, xs + i0 * kTile + lane);
    t = 1;
  }
  for (;; ++t) {
    const int down = ib - t, up = ib + t;
    if (down < info.fb && up > info.lb) break;
    // The nearest pair of this step is kRows * t - (kRows - 1) apart.
    const int dmin = kRows * t - (kRows - 1);
    float top = acc[0];
#pragma unroll
    for (int r = 1; r < kRows; ++r) top = fmaxf(top, acc[r]);
    const int top_key =
        __reduce_max_sync(kFull, in_l ? order_key(top) : INT_MIN);
    if (order_key(__fadd_rn(cost[dmin], info.xmin)) >= top_key) break;
    float c[2 * kRows - 1];
#pragma unroll
    for (int u = 0; u < 2 * kRows - 1; ++u) c[u] = cost[dmin + u];
    if (down >= info.fb && down <= info.lb) {
      meet<false>(acc, c, xs + down * kRows * kTile + lane);
    }
    if (up >= info.fb && up <= info.lb) {
      meet<true>(acc, c, xs + up * kRows * kTile + lane);
    }
  }
}

__device__ __forceinline__ void cost_table(float s, int kp, float* cost) {
  for (int d = threadIdx.y * kTile + threadIdx.x; d < kp + kRows;
       d += kTile * kWarps) {
    const float sd = __fmul_rn(s, static_cast<float>(d));
    cost[d] = __fmul_rn(sd, sd);
  }
}

__global__ void __launch_bounds__(kTile * kWarps)
    min_plus_kernel(const float* __restrict__ x,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int k_dim, int l_dim, int tiles) {
  extern __shared__ float smem[];
  __shared__ int found[3][kWarps];
  const int kp = padded(k_dim);
  float* xs = smem;                 // (kp, kTile)
  float* cost = smem + kp * kTile;  // (kp + kRows,): (scale * d)^2

  const int b = blockIdx.x / tiles;
  const int col = (blockIdx.x - b * tiles) * kTile + threadIdx.x;
  const bool in_l = col < l_dim;
  const size_t base = static_cast<size_t>(b) * k_dim * l_dim + col;
  cost_table(scale[b], kp, cost);
  const TileInfo info = load_tile(x, base, in_l, k_dim, l_dim, kp, xs, found);

  for (int i0 = threadIdx.y * kRows; i0 < kp; i0 += kWarps * kRows) {
    float acc[kRows];
    search(xs, cost, info, i0, in_l, acc);
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

size_t shared_bytes(int k) {
  return (static_cast<size_t>(padded(k)) * (kTile + 1) + kRows) * sizeof(float);
}

}  // namespace

// x, out: (b, k, l) float32; scale: (b,) float32. All on the device,
// contiguous; out may not alias x. Launches on `stream`, allocates nothing.
// k is limited by the shared memory of one block (1752 rows).
extern "C" int ctseg_min_plus(const void* x, const void* scale, void* out,
                              int b, int k, int l, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int tiles = (l + kTile - 1) / kTile;
  // 3 * kWarps ints of static shared memory count against the same limit.
  const size_t shared = shared_bytes(k);
  if (b <= 0 || k <= 0 || l <= 0 ||
      shared + sizeof(int[3][kWarps]) > kMaxShared ||
      static_cast<long long>(b) * tiles > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(min_plus_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxShared - sizeof(int[3][kWarps]));
  if (err != cudaSuccess) return err;
  min_plus_kernel<<<b * tiles, dim3(kTile, kWarps), shared,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<float*>(out), k, l, tiles);
  return cudaGetLastError();
}
