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
//   dalpha = sum(g * min(xhat, 0)), as deterministic partials that the
//   wrapper sums (the Pallas kernel's SMEM partials; no atomics).
//
// What bounds it on an H100: memory. The bound counts x read once and y
// written once (the backward: x and g read once, dx written once). The TPU
// kernel kept a whole (H, W, C-tile) slab in VMEM to read x once; a Hopper SM
// has 227 KB of shared memory, less than one 128x128x64 slab, so here a
// thread block cluster holds the slab, or the second read comes from L2 or
// HBM.
//
// Forward and backward share one geometry, chosen by the wrapper from the
// shape (ops/instance_norm.py::fwd_cluster_plan, fwd_plan, bwd_cluster_plan,
// bwd_plan): full lanes at any C (16 bytes a lane over the flattened
// sample) and the spatial axis split over blocks. Described under the
// backward, which had it first; the forward (K1f) differs as follows:
//   - Read-once form (in_prelu_fwd_cluster_kernel): only x is resident, and
//     the kernel works on super-rows, so it also takes a C that is no whole
//     number of vectors when the tile spans the whole super-row (256x256x10:
//     a cluster of 16 blocks holds the 2.6 MB sample, 80-byte super-rows).
//     A cluster is 1, 2, 8 or 16 blocks, the fewest that hold the tile in
//     96 KB a block: a cluster-wide barrier costs more the more blocks wait
//     at it, and Model L's 16x16x512 site fits one block a tile.
//     Each block sums x and x^2 over its resident rows; after a cluster-wide
//     barrier every block adds the cluster's sums in rank order through
//     distributed shared memory, folds the element columns that carry one
//     channel in index order, forms mean and rsqrt(var + eps), and writes y
//     from its resident rows: 8 bytes an element, the bound's own count.
//   - Two-phase form, everything else: per-chunk partial sums of x and x^2
//     to a float32 workspace, a kernel of one thread a (sample, channel) that
//     adds them in index order into mean and var, a normalize pass: x is
//     read twice, 12 bytes an element.
//   - The statistics are the one-pass form either way; no atomics, so two
//     runs on one input are equal bit for bit. The training variant writes
//     mean and var (N, C) for K1b.
//
// Backward design (K1b). Two forms, chosen by the wrapper from the shape
// (ops/instance_norm.py::bwd_cluster_plan, bwd_plan), both with full lanes
// at any C and the spatial axis split over blocks:
//   - Full lanes. A sample is one flat row of S*C elements, and a lane takes
//     16 bytes of it (4 float32, 8 bfloat16), neighbouring lanes
//     neighbouring vectors. The row repeats its channel pattern every
//     lcm(C, V) elements (V elements a vector): q = C / gcd(C, V) vectors, a
//     "super-row". A block's threads form (rows, columns) over super-rows,
//     so a thread's V channels never change while it strides over its rows,
//     and its three running sums stay in registers. At C = 10 a super-row is
//     5 vectors (2 pixels) and 255 of 256 lanes work. Samples whose byte
//     length is no multiple of 16 take the same kernels with one element a
//     lane.
//   - Read-once form (in_prelu_bwd_cluster_kernel), where C is whole vectors
//     and a sample's tile of channels fits a thread block cluster's shared
//     memory: each of the cluster's 8 (or 16) blocks copies its share of the
//     pixels of x and g into shared memory (cp.async), sums gh, gh*xhat and
//     g*min(xhat, 0) over them, the blocks exchange the sums through
//     distributed shared memory after a cluster-wide barrier (added in rank
//     order: deterministic), and each writes dx from its resident rows: 12
//     bytes an element, the bound's own count. Model L's 64x64x128,
//     32x32x256 and 16x16x512 sites go this way with clusters of 8 and tiles
//     of 32 to 512 channels, 128x128x64 with clusters of 16 and 16-channel
//     tiles (64-byte rows; 8 blocks would hold 8 channels, 32-byte rows).
//   - Two-phase form, everything else (256x256x10: a sample is 2.6 MB and
//     its rows 40 bytes): grid (column tiles, spatial chunks, N). Phase 1
//     sums over the block's chunk of super-rows (registers, then a
//     fixed-order sum over the block's rows in shared memory) and writes one
//     partial per (sample, chunk, sum, element column) to a float32
//     workspace. A kernel of one thread a (sample, channel) adds the
//     channel's partials over the chunks and the columns that carry it, in
//     index order, into the two means. (Done by every block of phase 2
//     instead, these dependent loads took longer than the block's own work
//     at the 16x16 sites.) Phase 2 reads the means and writes dx: x and g
//     are read twice, 20 bytes an element.
//   - dalpha is torch.sum over the third plane of either form's workspace.
//
// K2b (the backward of K2's IN + PReLU, csrc/conv_block.cu) is these same
// backward kernels with kSaved set: they read the xhat and rsinv that K2's
// training forward saved instead of recomputing them from x, mean and var.
// Replaces: ctseg_tpu/ops/pallas/conv_block.py::in_prelu_bwd (_bwd_kernel).
// Same bound (g and xhat read once, dy written once: 12 bytes an element in
// float32), same two forms and plans (ops/conv_block.py::bwd_plan). Each
// kernel keeps its own reference's statistics: K1b its one-pass variance,
// K2b the two-pass rsinv it is given. K2b's plan also takes clusters of 1,
// 2 and 4 blocks and blocks of 256 threads, two an SM, which small samples
// need (csrc/tools/sweep_k2b.py). The first K2b took one block per (sample,
// 32 channels), one element a lane (64 bytes a warp in bfloat16), and read
// g and xhat twice. The 9 launches of one Model L backward at batch 128:
// float32 2.99 ms (3.77 the first K2b; bound 1.98), bfloat16 1.74 (2.40;
// bound 0.99) (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, section 6).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phases 2 and 6).
// K1f, the 8 launches of one Model L forward at batch 32: float32 0.522 ms
// (1.844 ms as one block per (sample, 32 channels) reading x twice; its
// bytes' bound 0.341 ms), bfloat16 0.292 ms (bound 0.170 ms); the
// 256x256x10 site alone 0.092 ms (0.930 before; its two-phase form 0.149). K1b, the 8
// launches of one Model L backward at batch 128: float32 3.545 ms (6.095 ms
// before its redesign; bound 2.043 ms), bfloat16 2.173 ms (bound 1.022 ms);
// the 256x256x10 site alone 0.652 ms (2.368 before). Per site and per path:
// PERF.md, section 6; every geometry of the forward per site:
// csrc/tools/sweep_instance_norm_fwd.py.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBwdThreads = 256;

// How the backward's blocks cut one sample of s pixels x c channels into
// vectors of V elements; mirrors ops/instance_norm.py::bwd_plan.
struct BwdGeometry {
  int s, c;
  int q;               // vectors per super-row: c / gcd(c, V)
  int lcm;             // elements per super-row: q * V
  int wc;              // columns (vectors) a block takes: min(q, threads)
  int rr;              // super-rows a block takes per iteration
  int coltiles;        // ceil(q / wc)
  int rows_total;      // super-rows per sample
  int rows_per_chunk;  // super-rows per spatial chunk
  int chunks;
};

inline int gcd_int(int a, int b) {
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

inline bool make_geometry(int s, int c, int v, int chunks, int rows_per_chunk,
                          BwdGeometry* geo) {
  const int g = gcd_int(c, v);
  geo->s = s;
  geo->c = c;
  geo->q = c / g;
  geo->lcm = geo->q * v;
  geo->wc = geo->q < kBwdThreads ? geo->q : kBwdThreads;
  geo->rr = kBwdThreads / geo->wc;
  geo->coltiles = (geo->q + geo->wc - 1) / geo->wc;
  const int pixels_per_row = v / g;
  if (s % pixels_per_row != 0) return false;
  geo->rows_total = s / pixels_per_row;
  geo->rows_per_chunk = rows_per_chunk;
  geo->chunks = chunks;
  return chunks >= 1 && rows_per_chunk >= 1 && chunks <= 65535 &&
         static_cast<long long>(chunks) * rows_per_chunk >= geo->rows_total &&
         static_cast<long long>(chunks - 1) * rows_per_chunk < geo->rows_total;
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = ctseg::to_float(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "a 16-byte vector of float32");
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    static_assert(V == 8, "a 16-byte vector of bfloat16");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const unsigned int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bfloat16 is the high half of a float32: low element first.
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = ctseg::from_float<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(ctseg::pack_bf16(v[0], v[1]), ctseg::pack_bf16(v[2], v[3]),
                   ctseg::pack_bf16(v[4], v[5]), ctseg::pack_bf16(v[6], v[7]));
  }
}

// xhat of a stored element: K1b recomputes it from x and the forward's
// statistics, K2b (kSaved) reads it, saved by K2's training forward.
template <bool kSaved>
__device__ __forceinline__ float xhat_of(float stored, float mean, float inv) {
  return kSaved ? stored : (stored - mean) * inv;
}

// A thread's place in the two-phase kernels (backward and forward): column
// `col` of the block's tile (global column gcol of the super-row), row `row`
// of the block's rr rows; its V channels' mean and rsqrt(var + eps) (left 0
// where the statistics are still to be made: var_in null); the super-rows
// [r0, r1) of the block's chunk. kSaved (K2b): var_in holds rsinv itself
// and mean_in is unused (mean stays 0).
template <int V, bool kSaved = false>
struct BwdThread {
  int col, row, gcol, r0, r1;
  bool active;
  float mean[V], inv[V];
  size_t base;  // first element of the sample

  __device__ __forceinline__ BwdThread(const BwdGeometry& geo,
                                       const float* __restrict__ mean_in,
                                       const float* __restrict__ var_in) {
    const int tid = threadIdx.x;
    const int img = blockIdx.z;
    col = tid % geo.wc;
    row = tid / geo.wc;
    gcol = blockIdx.x * geo.wc + col;
    active = row < geo.rr && gcol < geo.q;
    r0 = blockIdx.y * geo.rows_per_chunk;
    r1 = min(r0 + geo.rows_per_chunk, geo.rows_total);
    base = static_cast<size_t>(img) * geo.s * geo.c;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mean[v] = 0.f;
      inv[v] = 0.f;
      if (active && var_in != nullptr) {
        const size_t stat = static_cast<size_t>(img) * geo.c +
                            (static_cast<size_t>(gcol) * V + v) % geo.c;
        if constexpr (kSaved) {
          inv[v] = var_in[stat];
        } else {
          mean[v] = mean_in[stat];
          inv[v] = rsqrtf(var_in[stat] + ctseg::kEps);
        }
      }
    }
  }
};

// Phase 1: parts[img, chunk, k, i] = sum over the chunk's super-rows of sum k
// (0: gh, 1: gh * xhat, 2: g * min(xhat, 0)) at element column i of the
// super-row. Grid (column tiles, chunks, N). kSaved (K2b): x is xhat, var
// is rsinv, mean unused.
template <typename T, int V, bool kSaved>
__device__ __forceinline__ void bwd_partials(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ alpha, float* __restrict__ parts,
    BwdGeometry geo) {
  __shared__ __align__(16) float red[3 * kBwdThreads * V];  // [k][row][i]
  const BwdThread<V, kSaved> th(geo, mean, var);
  const float a = alpha[0];
  float sums[3][V];
#pragma unroll
  for (int v = 0; v < V; ++v) sums[0][v] = sums[1][v] = sums[2][v] = 0.f;
  if (th.active) {
#pragma unroll 2
    for (int r = th.r0 + th.row; r < th.r1; r += geo.rr) {
      const size_t off =
          th.base + (static_cast<size_t>(r) * geo.q + th.gcol) * V;
      float xv[V], gv[V];
      load_vec<T, V>(x + off, xv);
      load_vec<T, V>(g + off, gv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = xhat_of<kSaved>(xv[v], th.mean[v], th.inv[v]);
        const float gh = xh >= 0.f ? gv[v] : a * gv[v];
        sums[0][v] += gh;
        sums[1][v] += gh * xh;
        sums[2][v] += gv[v] * fminf(xh, 0.f);
      }
    }
  }
  const int width = geo.wc * V;  // element columns of the block's tile
  if (th.row < geo.rr) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v)
        red[(k * geo.rr + th.row) * width + th.col * V + v] = sums[k][v];
  }
  __syncthreads();
  float* dst = parts + (static_cast<size_t>(blockIdx.z) * geo.chunks +
                        blockIdx.y) * 3 * geo.lcm;
  for (int idx = threadIdx.x; idx < 3 * width; idx += kBwdThreads) {
    const int k = idx / width;
    const int i = idx - k * width;
    const int gi = blockIdx.x * width + i;
    if (gi >= geo.lcm) continue;
    float total = 0.f;
    for (int row = 0; row < geo.rr; ++row) {
      total += red[(k * geo.rr + row) * width + i];
    }
    dst[k * geo.lcm + gi] = total;
  }
}

// The backward's kernels have one body and two names, K1b's and K2b's
// (in_prelu_bwd_saved_*), so that a profile tells them apart.
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads) in_prelu_bwd_partials_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ alpha, float* __restrict__ parts,
    BwdGeometry geo) {
  bwd_partials<T, V, false>(x, g, mean, var, alpha, parts, geo);
}
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads)
    in_prelu_bwd_saved_partials_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ alpha, float* __restrict__ parts,
    BwdGeometry geo) {
  bwd_partials<T, V, true>(x, g, mean, var, alpha, parts, geo);
}

constexpr int kMeansThreads = 128;

// Between the phases: means[img, k, ch] = sum k of channel ch over the whole
// sample / s, for k = 0 (gh) and 1 (gh * xhat): the partials of the chunks
// in order, within a chunk the element columns that carry the channel in
// order. Grid (ceil(c / 128), N): one thread a channel.
__global__ void __launch_bounds__(kMeansThreads)
    in_prelu_bwd_means_kernel(const float* __restrict__ parts,
                              float* __restrict__ means, BwdGeometry geo) {
  const int ch = blockIdx.x * kMeansThreads + threadIdx.x;
  if (ch >= geo.c) return;
  const float* src =
      parts + static_cast<size_t>(blockIdx.y) * geo.chunks * 3 * geo.lcm;
  float total[2] = {0.f, 0.f};
#pragma unroll 4
  for (int chunk = 0; chunk < geo.chunks; ++chunk) {
    const float* p = src + static_cast<size_t>(chunk) * 3 * geo.lcm;
    for (int e = ch; e < geo.lcm; e += geo.c) {
      total[0] += p[e];
      total[1] += p[geo.lcm + e];
    }
  }
  float* dst = means + static_cast<size_t>(blockIdx.y) * 2 * geo.c + ch;
  dst[0] = total[0] / static_cast<float>(geo.s);
  dst[geo.c] = total[1] / static_cast<float>(geo.s);
}

// Phase 2: dx over the block's chunk, from the sample's two means per
// channel. Same grid as phase 1.
template <typename T, int V, bool kSaved>
__device__ __forceinline__ void bwd_dx(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ alpha, const float* __restrict__ means,
    T* __restrict__ dx, BwdGeometry geo) {
  const BwdThread<V, kSaved> th(geo, mean, var);
  if (!th.active) return;
  const float a = alpha[0];
  float m1[V], m2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const size_t at = static_cast<size_t>(blockIdx.z) * 2 * geo.c +
                      (static_cast<size_t>(th.gcol) * V + v) % geo.c;
    m1[v] = means[at];
    m2[v] = means[at + geo.c];
  }
#pragma unroll 2
  for (int r = th.r0 + th.row; r < th.r1; r += geo.rr) {
    const size_t off =
        th.base + (static_cast<size_t>(r) * geo.q + th.gcol) * V;
    float xv[V], gv[V], out[V];
    load_vec<T, V>(x + off, xv);
    load_vec<T, V>(g + off, gv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xh = xhat_of<kSaved>(xv[v], th.mean[v], th.inv[v]);
      const float gh = xh >= 0.f ? gv[v] : a * gv[v];
      out[v] = th.inv[v] * (gh - m1[v] - xh * m2[v]);
    }
    store_vec<T, V>(dx + off, out);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads) in_prelu_bwd_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ alpha, const float* __restrict__ means,
    T* __restrict__ dx, BwdGeometry geo) {
  bwd_dx<T, V, false>(x, g, mean, var, alpha, means, dx, geo);
}
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads) in_prelu_bwd_saved_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ alpha, const float* __restrict__ means,
    T* __restrict__ dx, BwdGeometry geo) {
  bwd_dx<T, V, true>(x, g, mean, var, alpha, means, dx, geo);
}

// ---- K1f, two-phase form ----

// Phase 1: parts[img, chunk, k, i] = sum over the chunk's super-rows of x
// (k = 0) and x^2 (k = 1) at element column i of the super-row. Grid (column
// tiles, chunks, N).
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads)
    in_prelu_fwd_partials_kernel(const T* __restrict__ x,
                                 float* __restrict__ parts, BwdGeometry geo) {
  __shared__ __align__(16) float red[2 * kBwdThreads * V];  // [k][row][i]
  const BwdThread<V> th(geo, nullptr, nullptr);
  float sums[2][V];
#pragma unroll
  for (int v = 0; v < V; ++v) sums[0][v] = sums[1][v] = 0.f;
  if (th.active) {
#pragma unroll 4
    for (int r = th.r0 + th.row; r < th.r1; r += geo.rr) {
      float xv[V];
      load_vec<T, V>(
          x + th.base + (static_cast<size_t>(r) * geo.q + th.gcol) * V, xv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sums[0][v] += xv[v];
        sums[1][v] += xv[v] * xv[v];
      }
    }
  }
  const int width = geo.wc * V;  // element columns of the block's tile
  if (th.row < geo.rr) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v)
        red[(k * geo.rr + th.row) * width + th.col * V + v] = sums[k][v];
  }
  __syncthreads();
  float* dst = parts + (static_cast<size_t>(blockIdx.z) * geo.chunks +
                        blockIdx.y) * 2 * geo.lcm;
  for (int idx = threadIdx.x; idx < 2 * width; idx += kBwdThreads) {
    const int k = idx / width;
    const int i = idx - k * width;
    const int gi = blockIdx.x * width + i;
    if (gi >= geo.lcm) continue;
    float total = 0.f;
    for (int row = 0; row < geo.rr; ++row) {
      total += red[(k * geo.rr + row) * width + i];
    }
    dst[k * geo.lcm + gi] = total;
  }
}

// The one-pass statistics from the two sums over a sample of s pixels.
__device__ __forceinline__ void mean_var(float sum, float sum_sq, int s,
                                         float* mean, float* var) {
  *mean = sum / static_cast<float>(s);
  const float d = sum_sq / static_cast<float>(s) - *mean * *mean;
  *var = d < 0.f ? 0.f : d;  // clamp; NaN passes like jnp.maximum
}

// Between the phases: mean and var of channel ch over the whole sample, from
// the partials of the chunks in order, within a chunk the element columns
// that carry the channel in order. Grid (ceil(c / 128), N): one thread a
// channel.
__global__ void __launch_bounds__(kMeansThreads)
    in_prelu_fwd_stats_kernel(const float* __restrict__ parts,
                              float* __restrict__ mean,
                              float* __restrict__ var, BwdGeometry geo) {
  const int ch = blockIdx.x * kMeansThreads + threadIdx.x;
  if (ch >= geo.c) return;
  const float* src =
      parts + static_cast<size_t>(blockIdx.y) * geo.chunks * 2 * geo.lcm;
  float total[2] = {0.f, 0.f};
#pragma unroll 4
  for (int chunk = 0; chunk < geo.chunks; ++chunk) {
    const float* p = src + static_cast<size_t>(chunk) * 2 * geo.lcm;
    for (int e = ch; e < geo.lcm; e += geo.c) {
      total[0] += p[e];
      total[1] += p[geo.lcm + e];
    }
  }
  const size_t at = static_cast<size_t>(blockIdx.y) * geo.c + ch;
  mean_var(total[0], total[1], geo.s, mean + at, var + at);
}

// Phase 2: y over the block's chunk. Same grid as phase 1.
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads)
    in_prelu_fwd_normalize_kernel(const T* __restrict__ x,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ var,
                                  const float* __restrict__ alpha,
                                  T* __restrict__ y, BwdGeometry geo) {
  const BwdThread<V> th(geo, mean, var);
  if (!th.active) return;
  const float a = alpha[0];
#pragma unroll 4
  for (int r = th.r0 + th.row; r < th.r1; r += geo.rr) {
    const size_t off =
        th.base + (static_cast<size_t>(r) * geo.q + th.gcol) * V;
    float xv[V], out[V];
    load_vec<T, V>(x + off, xv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      out[v] = ctseg::prelu((xv[v] - th.mean[v]) * th.inv[v], a);
    }
    store_vec<T, V>(y + off, out);
  }
}

// ---- K1b, read-once form: a thread block cluster holds the tile ----

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 512;

// A cluster takes a column tile of `wcc` vectors (wcc * V channels; c is a
// multiple of V here, so a column is a channel group and q = c / V) over all
// s pixels of one sample; its CTA of rank r takes pixels [r * rows_per_cta,
// (r + 1) * rows_per_cta). K1b's cluster is 8 blocks, or 16 (the most an
// H100 allows, a size CUDA calls non-portable) where only that brings the
// rows of the tile to 64 bytes (ops/instance_norm.py::bwd_cluster_plan);
// K2b's plan may also take 1, 2 or 4 (ops/conv_block.py::bwd_plan).
struct ClusterGeometry {
  int s, c, q, wcc, rr, rows_per_cta;
};

// Dynamic shared memory of a CTA of `threads` threads: its rows of x and of
// g, the block's reduction buffer [3][rr][wcc * V], its own three sums per
// channel [3][wcc * V] (read by the whole cluster), the two means
// [2][wcc * V].
template <typename T, int V>
size_t cluster_smem_bytes(const ClusterGeometry& geo, int threads) {
  const size_t width = static_cast<size_t>(geo.wcc) * V;
  return 2 * geo.rows_per_cta * width * sizeof(T) +
         (3 * static_cast<size_t>(threads) * V + 5 * width) * sizeof(float);
}

// x and g are read from device memory once: each CTA copies its rows of
// the tile into shared memory (cp.async), sums gh, gh * xhat and g *
// min(xhat, 0) over them, and leaves the sums in its shared memory; after a
// cluster-wide barrier every CTA adds the cluster's sums in rank order
// through distributed shared memory, then writes dx from its resident
// rows. dalpha's partials go to parts[img, rank, 2, channel]. Grid
// (kClusterSize * column tiles, 1, N), clusters of kClusterSize along x
// (set at launch), blocks of kThreads. kSaved (K2b): x is xhat, var is
// rsinv, mean unused.
template <typename T, int V, int kClusterSize, bool kSaved, int kThreads>
__device__ __forceinline__ void bwd_cluster_body(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ alpha, T* __restrict__ dx,
    float* __restrict__ parts, ClusterGeometry geo) {
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ctile = blockIdx.x / kClusterSize;
  const int img = blockIdx.z;
  const int tid = threadIdx.x;
  const int width = geo.wcc * V;  // channels of the tile
  T* xs = reinterpret_cast<T*>(cluster_smem);  // [rows_per_cta][width]
  T* gs = xs + static_cast<size_t>(geo.rows_per_cta) * width;
  float* red = reinterpret_cast<float*>(
      gs + static_cast<size_t>(geo.rows_per_cta) * width);
  float* own = red + 3 * kThreads * V;  // [3][width]
  float* means = own + 3 * width;              // [2][width]

  const int r0 = rank * geo.rows_per_cta;
  const int nrows = max(0, min(geo.rows_per_cta, geo.s - r0));
  const size_t base = static_cast<size_t>(img) * geo.s * geo.c;
  for (int idx = tid; idx < nrows * geo.wcc; idx += kThreads) {
    const int row = idx / geo.wcc;
    const int col = idx - row * geo.wcc;
    const size_t off = base + (static_cast<size_t>(r0 + row) * geo.q +
                               ctile * geo.wcc + col) * V;
    ctseg::cp_async16(xs + static_cast<size_t>(idx) * V, x + off, true);
    ctseg::cp_async16(gs + static_cast<size_t>(idx) * V, g + off, true);
  }
  ctseg::cp_async_commit();

  const int col = tid % geo.wcc;
  const int row = tid / geo.wcc;  // < rr: wcc divides the block
  const float a = alpha[0];
  float m[V], inv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const size_t stat = static_cast<size_t>(img) * geo.c +
                        (ctile * geo.wcc + col) * V + v;
    if constexpr (kSaved) {
      m[v] = 0.f;
      inv[v] = var[stat];
    } else {
      m[v] = mean[stat];
      inv[v] = rsqrtf(var[stat] + ctseg::kEps);
    }
  }
  ctseg::cp_async_wait<0>();
  __syncthreads();

  float sums[3][V];
#pragma unroll
  for (int v = 0; v < V; ++v) sums[0][v] = sums[1][v] = sums[2][v] = 0.f;
  for (int r = row; r < nrows; r += geo.rr) {
    const size_t at = (static_cast<size_t>(r) * geo.wcc + col) * V;
    float xv[V], gv[V];
    load_vec<T, V>(xs + at, xv);
    load_vec<T, V>(gs + at, gv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xh = xhat_of<kSaved>(xv[v], m[v], inv[v]);
      const float gh = xh >= 0.f ? gv[v] : a * gv[v];
      sums[0][v] += gh;
      sums[1][v] += gh * xh;
      sums[2][v] += gv[v] * fminf(xh, 0.f);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v)
      red[(k * geo.rr + row) * width + col * V + v] = sums[k][v];
  __syncthreads();
  for (int idx = tid; idx < 3 * width; idx += kThreads) {
    const int k = idx / width;
    const int i = idx - k * width;
    float total = 0.f;
    for (int r = 0; r < geo.rr; ++r) total += red[(k * geo.rr + r) * width + i];
    own[idx] = total;
    if (k == 2) {
      parts[((static_cast<size_t>(img) * kClusterSize + rank) * 3 + 2) * geo.c +
            ctile * width + i] = total;
    }
  }
  cluster.sync();  // every CTA's sums are in its shared memory
  for (int idx = tid; idx < 2 * width; idx += kThreads) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kClusterSize; ++r) {
      total += cluster.map_shared_rank(own, r)[idx];
    }
    means[idx] = total / static_cast<float>(geo.s);
  }
  cluster.sync();  // no CTA is read any more; the means are complete

  float m1[V], m2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m1[v] = means[col * V + v];
    m2[v] = means[width + col * V + v];
  }
  for (int r = row; r < nrows; r += geo.rr) {
    const size_t at = (static_cast<size_t>(r) * geo.wcc + col) * V;
    float xv[V], gv[V], out[V];
    load_vec<T, V>(xs + at, xv);
    load_vec<T, V>(gs + at, gv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xh = xhat_of<kSaved>(xv[v], m[v], inv[v]);
      const float gh = xh >= 0.f ? gv[v] : a * gv[v];
      out[v] = inv[v] * (gh - m1[v] - xh * m2[v]);
    }
    store_vec<T, V>(dx + base + (static_cast<size_t>(r0 + r) * geo.q +
                                 ctile * geo.wcc + col) * V,
                    out);
  }
}

template <typename T, int V, int kClusterSize>
__global__ void __launch_bounds__(kClusterThreads, 1)
    in_prelu_bwd_cluster_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ alpha, T* __restrict__ dx,
    float* __restrict__ parts, ClusterGeometry geo) {
  bwd_cluster_body<T, V, kClusterSize, false, kClusterThreads>(
      x, g, mean, var, alpha, dx, parts, geo);
}
// K2b's also comes in blocks of 256 threads, two an SM where the tile
// leaves room (ops/conv_block.py::bwd_plan).
template <typename T, int V, int kClusterSize, int kThreads>
__global__ void __launch_bounds__(kThreads, kClusterThreads / kThreads)
    in_prelu_bwd_saved_cluster_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ alpha, T* __restrict__ dx,
    float* __restrict__ parts, ClusterGeometry geo) {
  bwd_cluster_body<T, V, kClusterSize, true, kThreads>(x, g, mean, var, alpha,
                                                       dx, parts, geo);
}

template <typename T, int kClusterSize, bool kSaved, int kThreads>
cudaError_t launch_bwd_cluster(const void* x, const void* g, const void* mean,
                               const void* var, const void* alpha, void* dx,
                               void* parts, int n, int s, int c, int wcc,
                               cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dx);
  if (bits % 16 != 0 || c % kVec != 0 || wcc < 1 || kThreads % wcc != 0 ||
      (c / kVec) % wcc != 0) {
    return cudaErrorInvalidValue;
  }
  ClusterGeometry geo;
  geo.s = s;
  geo.c = c;
  geo.q = c / kVec;
  geo.wcc = wcc;
  geo.rr = kThreads / wcc;
  geo.rows_per_cta = (s + kClusterSize - 1) / kClusterSize;
  const size_t bytes = cluster_smem_bytes<T, kVec>(geo, kThreads);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  void (*kernel)(const T*, const T*, const float*, const float*, const float*,
                 T*, float*, ClusterGeometry);
  if constexpr (kSaved) {
    kernel = in_prelu_bwd_saved_cluster_kernel<T, kVec, kClusterSize, kThreads>;
  } else {
    static_assert(kThreads == kClusterThreads, "K1b's blocks are 512");
    kernel = in_prelu_bwd_cluster_kernel<T, kVec, kClusterSize>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (kClusterSize > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterSize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kClusterSize * (geo.q / wcc), 1, n);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(alpha), static_cast<T*>(dx),
      static_cast<float*>(parts), geo);
}

template <typename T, bool kSaved, int kThreads>
cudaError_t launch_bwd_cluster_sized(const void* x, const void* g,
                                     const void* mean, const void* var,
                                     const void* alpha, void* dx, void* parts,
                                     int n, int s, int c, int wcc,
                                     int cluster_size, cudaStream_t stream) {
  switch (cluster_size) {
    case 1:
      return launch_bwd_cluster<T, 1, kSaved, kThreads>(
          x, g, mean, var, alpha, dx, parts, n, s, c, wcc, stream);
    case 2:
      return launch_bwd_cluster<T, 2, kSaved, kThreads>(
          x, g, mean, var, alpha, dx, parts, n, s, c, wcc, stream);
    case 4:
      return launch_bwd_cluster<T, 4, kSaved, kThreads>(
          x, g, mean, var, alpha, dx, parts, n, s, c, wcc, stream);
    case 8:
      return launch_bwd_cluster<T, 8, kSaved, kThreads>(
          x, g, mean, var, alpha, dx, parts, n, s, c, wcc, stream);
    case 16:
      return launch_bwd_cluster<T, 16, kSaved, kThreads>(
          x, g, mean, var, alpha, dx, parts, n, s, c, wcc, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Blocks of 512 threads, or (K2b only) of 256.
template <typename T, bool kSaved>
cudaError_t launch_bwd_cluster_threads(const void* x, const void* g,
                                       const void* mean, const void* var,
                                       const void* alpha, void* dx,
                                       void* parts, int n, int s, int c,
                                       int wcc, int cluster_size, int threads,
                                       cudaStream_t stream) {
  if (threads == kClusterThreads) {
    return launch_bwd_cluster_sized<T, kSaved, kClusterThreads>(
        x, g, mean, var, alpha, dx, parts, n, s, c, wcc, cluster_size,
        stream);
  }
  if constexpr (kSaved) {
    if (threads == kClusterThreads / 2) {
      return launch_bwd_cluster_sized<T, kSaved, kClusterThreads / 2>(
          x, g, mean, var, alpha, dx, parts, n, s, c, wcc, cluster_size,
          stream);
    }
  }
  return cudaErrorInvalidValue;
}

// ---- K1f, read-once form ----

constexpr int kFwdClusterThreads = 256;

// A cluster takes a column tile of `wcc` vectors of the super-row (all q of
// them unless c is whole vectors) over all super-rows of one sample; its CTA
// of rank r takes super-rows [r * rows_per_cta, (r + 1) * rows_per_cta).
// Mirrors ops/instance_norm.py::fwd_cluster_plan.
struct FwdClusterGeometry {
  int s, c, q, wcc, rr, rows_per_cta, rows_total;
};

// Dynamic shared memory of a CTA: its rows of x, the block's reduction
// buffer [2][rr][wcc * V], its own two sums per element column [2][wcc * V]
// (read by the whole cluster), mean and rsqrt(var + eps) [2][wcc * V].
template <typename T, int V>
size_t fwd_cluster_smem_bytes(const FwdClusterGeometry& geo) {
  const size_t width = static_cast<size_t>(geo.wcc) * V;
  return geo.rows_per_cta * width * sizeof(T) +
         (2 * static_cast<size_t>(kFwdClusterThreads) * V + 4 * width) *
             sizeof(float);
}

// Grid (kClusterSize * column tiles, 1, N), clusters of kClusterSize along x
// (set at launch).
template <typename T, int V, int kClusterSize>
__global__ void __launch_bounds__(kFwdClusterThreads)
    in_prelu_fwd_cluster_kernel(const T* __restrict__ x, T* __restrict__ y,
                                const float* __restrict__ alpha,
                                float* __restrict__ mean_out,
                                float* __restrict__ var_out,
                                FwdClusterGeometry geo) {
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ctile = blockIdx.x / kClusterSize;
  const int img = blockIdx.z;
  const int tid = threadIdx.x;
  const int width = geo.wcc * V;  // element columns of the tile
  T* xs = reinterpret_cast<T*>(cluster_smem);  // [rows_per_cta][width]
  float* red = reinterpret_cast<float*>(
      xs + static_cast<size_t>(geo.rows_per_cta) * width);
  float* own = red + 2 * kFwdClusterThreads * V;  // [2][width]
  float* stat = own + 2 * width;                  // [2][width]

  const int r0 = rank * geo.rows_per_cta;
  const int nrows = max(0, min(geo.rows_per_cta, geo.rows_total - r0));
  const size_t base = static_cast<size_t>(img) * geo.s * geo.c;
  for (int idx = tid; idx < nrows * geo.wcc; idx += kFwdClusterThreads) {
    const int row = idx / geo.wcc;
    const int col = idx - row * geo.wcc;
    ctseg::cp_async16(xs + static_cast<size_t>(idx) * V,
                      x + base + (static_cast<size_t>(r0 + row) * geo.q +
                                  ctile * geo.wcc + col) * V,
                      true);
  }
  ctseg::cp_async_commit();
  ctseg::cp_async_wait<0>();
  __syncthreads();

  const int col = tid % geo.wcc;
  const int row = tid / geo.wcc;
  const bool active = row < geo.rr;  // rr * wcc <= the block's threads
  float sums[2][V];
#pragma unroll
  for (int v = 0; v < V; ++v) sums[0][v] = sums[1][v] = 0.f;
  if (active) {
    for (int r = row; r < nrows; r += geo.rr) {
      float xv[V];
      load_vec<T, V>(xs + (static_cast<size_t>(r) * geo.wcc + col) * V, xv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sums[0][v] += xv[v];
        sums[1][v] += xv[v] * xv[v];
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v)
        red[(k * geo.rr + row) * width + col * V + v] = sums[k][v];
  }
  __syncthreads();
  for (int idx = tid; idx < 2 * width; idx += kFwdClusterThreads) {
    const int k = idx / width;
    const int i = idx - k * width;
    float total = 0.f;
    for (int r = 0; r < geo.rr; ++r) total += red[(k * geo.rr + r) * width + i];
    own[idx] = total;
  }
  cluster.sync();  // every CTA's sums are in its shared memory
  for (int i = tid; i < width; i += kFwdClusterThreads) {
    // The element columns of the tile that carry column i's channel, in
    // order (one where c is whole vectors), each over the ranks in order.
    float total[2] = {0.f, 0.f};
    for (int e = i % geo.c; e < width; e += geo.c) {
#pragma unroll
      for (int r = 0; r < kClusterSize; ++r) {
        const float* theirs = cluster.map_shared_rank(own, r);
        total[0] += theirs[e];
        total[1] += theirs[width + e];
      }
    }
    float mean, var;
    mean_var(total[0], total[1], geo.s, &mean, &var);
    stat[i] = mean;
    stat[width + i] = rsqrtf(var + ctseg::kEps);
    if (mean_out != nullptr && rank == 0 && i < geo.c) {
      const size_t at = static_cast<size_t>(img) * geo.c +
                        (static_cast<size_t>(ctile) * width + i) % geo.c;
      mean_out[at] = mean;
      var_out[at] = var;
    }
  }
  cluster.sync();  // no CTA is read any more; the statistics are complete

  if (!active) return;
  const float a = alpha[0];
  float m[V], inv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = stat[col * V + v];
    inv[v] = stat[width + col * V + v];
  }
  for (int r = row; r < nrows; r += geo.rr) {
    float xv[V], out[V];
    load_vec<T, V>(xs + (static_cast<size_t>(r) * geo.wcc + col) * V, xv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      out[v] = ctseg::prelu((xv[v] - m[v]) * inv[v], a);
    }
    store_vec<T, V>(y + base + (static_cast<size_t>(r0 + r) * geo.q +
                                ctile * geo.wcc + col) * V,
                    out);
  }
}

template <typename T, int kClusterSize>
cudaError_t launch_fwd_cluster(const void* x, void* y, const void* alpha,
                               void* mean_out, void* var_out, int n, int s,
                               int c, int wcc, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  const int g = gcd_int(c, kVec);
  FwdClusterGeometry geo;
  geo.s = s;
  geo.c = c;
  geo.q = c / g;
  geo.wcc = wcc;
  if (bits % 16 != 0 || (static_cast<long long>(s) * c) % kVec != 0 ||
      wcc < 1 || wcc > kFwdClusterThreads || geo.q % wcc != 0 ||
      (c % kVec != 0 && wcc != geo.q)) {
    return cudaErrorInvalidValue;
  }
  geo.rr = kFwdClusterThreads / wcc;
  geo.rows_total = s / (kVec / g);
  geo.rows_per_cta = (geo.rows_total + kClusterSize - 1) / kClusterSize;
  const size_t bytes = fwd_cluster_smem_bytes<T, kVec>(geo);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  auto* kernel = in_prelu_fwd_cluster_kernel<T, kVec, kClusterSize>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (kClusterSize > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterSize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kClusterSize * (geo.q / wcc), 1, n);
  config.blockDim = dim3(kFwdClusterThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const float*>(alpha), static_cast<float*>(mean_out),
      static_cast<float*>(var_out), geo);
}

template <typename T>
cudaError_t launch_fwd_cluster_sized(const void* x, void* y, const void* alpha,
                                     void* mean_out, void* var_out, int n,
                                     int s, int c, int wcc, int cluster_size,
                                     cudaStream_t stream) {
  switch (cluster_size) {
    case 1:
      return launch_fwd_cluster<T, 1>(x, y, alpha, mean_out, var_out, n, s, c,
                                      wcc, stream);
    case 2:
      return launch_fwd_cluster<T, 2>(x, y, alpha, mean_out, var_out, n, s, c,
                                      wcc, stream);
    case 8:
      return launch_fwd_cluster<T, 8>(x, y, alpha, mean_out, var_out, n, s, c,
                                      wcc, stream);
    case 16:
      return launch_fwd_cluster<T, 16>(x, y, alpha, mean_out, var_out, n, s,
                                       c, wcc, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int V>
cudaError_t launch_fwd_v(const void* x, void* y, const void* alpha,
                         void* parts, void* mean, void* var, int n, int s,
                         int c, int chunks, int rows_per_chunk,
                         cudaStream_t stream) {
  BwdGeometry geo;
  if (!make_geometry(s, c, V, chunks, rows_per_chunk, &geo)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(geo.coltiles, geo.chunks, n);
  in_prelu_fwd_partials_kernel<T, V><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(parts), geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 stats_grid((c + kMeansThreads - 1) / kMeansThreads, n);
  in_prelu_fwd_stats_kernel<<<stats_grid, kMeansThreads, 0, stream>>>(
      static_cast<const float*>(parts), static_cast<float*>(mean),
      static_cast<float*>(var), geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_prelu_fwd_normalize_kernel<T, V><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(alpha),
      static_cast<T*>(y), geo);
  return cudaGetLastError();
}

// `vec` is the elements a lane takes: 16 / sizeof(T), or 1.
template <typename T>
cudaError_t launch_fwd(const void* x, void* y, const void* alpha, void* parts,
                       void* mean, void* var, int n, int s, int c, int vec,
                       int chunks, int rows_per_chunk, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (vec == 1) {
    return launch_fwd_v<T, 1>(x, y, alpha, parts, mean, var, n, s, c, chunks,
                              rows_per_chunk, stream);
  }
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (vec != kVec || bits % 16 != 0 ||
      (static_cast<long long>(s) * c) % kVec != 0) {
    return cudaErrorInvalidValue;
  }
  return launch_fwd_v<T, kVec>(x, y, alpha, parts, mean, var, n, s, c, chunks,
                               rows_per_chunk, stream);
}

template <typename T, int V, bool kSaved>
cudaError_t launch_bwd_v(const void* x, const void* g, const void* mean,
                         const void* var, const void* alpha, void* dx,
                         void* parts, void* means, int n, int s, int c,
                         int chunks, int rows_per_chunk, cudaStream_t stream) {
  BwdGeometry geo;
  if (!make_geometry(s, c, V, chunks, rows_per_chunk, &geo)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(geo.coltiles, geo.chunks, n);
  auto* partials = kSaved ? in_prelu_bwd_saved_partials_kernel<T, V>
                          : in_prelu_bwd_partials_kernel<T, V>;
  partials<<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(alpha), static_cast<float*>(parts), geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 means_grid((c + kMeansThreads - 1) / kMeansThreads, n);
  in_prelu_bwd_means_kernel<<<means_grid, kMeansThreads, 0, stream>>>(
      static_cast<const float*>(parts), static_cast<float*>(means), geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* dx_kernel = kSaved ? in_prelu_bwd_saved_dx_kernel<T, V>
                           : in_prelu_bwd_dx_kernel<T, V>;
  dx_kernel<<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(alpha), static_cast<const float*>(means),
      static_cast<T*>(dx), geo);
  return cudaGetLastError();
}

// `vec` is the elements a lane takes: 16 / sizeof(T), or 1.
template <typename T, bool kSaved>
cudaError_t launch_bwd(const void* x, const void* g, const void* mean,
                       const void* var, const void* alpha, void* dx,
                       void* parts, void* means, int n, int s, int c, int vec,
                       int chunks, int rows_per_chunk, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (vec == 1) {
    return launch_bwd_v<T, 1, kSaved>(x, g, mean, var, alpha, dx, parts,
                                      means, n, s, c, chunks, rows_per_chunk,
                                      stream);
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dx);
  if (vec != kVec || bits % 16 != 0 ||
      (static_cast<long long>(s) * c) % kVec != 0) {
    return cudaErrorInvalidValue;
  }
  return launch_bwd_v<T, kVec, kSaved>(x, g, mean, var, alpha, dx, parts,
                                       means, n, s, c, chunks, rows_per_chunk,
                                       stream);
}


// ---- K1f/K1b split across depth slabs ----
//
// A depth-sharded 3D activation lives as one slab a rank; its statistics are
// sums over every slab. The split form is the two-phase form with the sums
// taken out between the phases: a statistics launch writes the slab's
// per-(sample, channel) sums, the caller all-reduces them over the ranks of
// the slabs and finishes the statistics, and a second launch normalises (or
// writes dx) from the global ones. It reuses the two-phase kernels'
// partials and phase-2 kernels and their geometry (fwd_plan / bwd_plan);
// only the kernel between the phases differs: it adds the chunks' partials
// of planes 0 and 1 (x and x^2 forward; gh and gh * xhat backward) in
// index order into totals (n, 2, c), undivided. Bound on an H100: memory,
// as the unsplit form; a slab is read twice (once a launch), 12 bytes an
// element forward and 20 backward, against the bound's 8 and 12.

// totals[img, k, ch] = sum over the chunks (in order) and the element
// columns that carry ch (in order) of plane k of the partials, k = 0, 1.
// `planes`: the partials' planes (2 forward, 3 backward). Grid (ceil(c /
// 128), N): one thread a channel.
__global__ void __launch_bounds__(kMeansThreads)
    in_prelu_split_sums_kernel(const float* __restrict__ parts,
                               float* __restrict__ totals, int planes,
                               BwdGeometry geo) {
  const int ch = blockIdx.x * kMeansThreads + threadIdx.x;
  if (ch >= geo.c) return;
  const float* src = parts + static_cast<size_t>(blockIdx.y) * geo.chunks *
                                 planes * geo.lcm;
  float total[2] = {0.f, 0.f};
  for (int chunk = 0; chunk < geo.chunks; ++chunk) {
    const float* p = src + static_cast<size_t>(chunk) * planes * geo.lcm;
    for (int e = ch; e < geo.lcm; e += geo.c) {
      total[0] += p[e];
      total[1] += p[geo.lcm + e];
    }
  }
  float* dst = totals + static_cast<size_t>(blockIdx.y) * 2 * geo.c + ch;
  dst[0] = total[0];
  dst[geo.c] = total[1];
}

// The four launches of the split form, one struct each, dispatched on the
// storage type and the vector width by `dispatch_split`.
struct SplitArgs {
  const void* x;
  const void* g;  // backward only
  const float* mean;
  const float* var;
  const float* alpha;
  const float* means;  // dx only: (n, 2, c), the global sums over the count
  float* parts;
  float* totals;
  void* out;  // y or dx
  int n;
  BwdGeometry geo;
  cudaStream_t stream;
};

struct SplitFwdSums {
  template <typename T, int V>
  static cudaError_t run(const SplitArgs& a) {
    const dim3 grid(a.geo.coltiles, a.geo.chunks, a.n);
    in_prelu_fwd_partials_kernel<T, V><<<grid, kBwdThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.parts, a.geo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 sums_grid((a.geo.c + kMeansThreads - 1) / kMeansThreads, a.n);
    in_prelu_split_sums_kernel<<<sums_grid, kMeansThreads, 0, a.stream>>>(
        a.parts, a.totals, 2, a.geo);
    return cudaGetLastError();
  }
};

struct SplitFwdApply {
  template <typename T, int V>
  static cudaError_t run(const SplitArgs& a) {
    const dim3 grid(a.geo.coltiles, a.geo.chunks, a.n);
    in_prelu_fwd_normalize_kernel<T, V><<<grid, kBwdThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.mean, a.var, a.alpha,
        static_cast<T*>(a.out), a.geo);
    return cudaGetLastError();
  }
};

struct SplitBwdSums {
  template <typename T, int V>
  static cudaError_t run(const SplitArgs& a) {
    const dim3 grid(a.geo.coltiles, a.geo.chunks, a.n);
    in_prelu_bwd_partials_kernel<T, V><<<grid, kBwdThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.mean, a.var,
        a.alpha, a.parts, a.geo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 sums_grid((a.geo.c + kMeansThreads - 1) / kMeansThreads, a.n);
    in_prelu_split_sums_kernel<<<sums_grid, kMeansThreads, 0, a.stream>>>(
        a.parts, a.totals, 3, a.geo);
    return cudaGetLastError();
  }
};

struct SplitBwdApply {
  template <typename T, int V>
  static cudaError_t run(const SplitArgs& a) {
    const dim3 grid(a.geo.coltiles, a.geo.chunks, a.n);
    in_prelu_bwd_dx_kernel<T, V><<<grid, kBwdThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.mean, a.var,
        a.alpha, a.means, static_cast<T*>(a.out), a.geo);
    return cudaGetLastError();
  }
};

// F::run<T, V>(args) for the storage type `dtype` and `vec` elements a lane
// (1, or 16 bytes' worth with every tensor 16-byte aligned), after the
// geometry check.
template <typename F>
cudaError_t dispatch_split(int dtype, int vec, int s, int c, int chunks,
                           int rows_per_chunk, uintptr_t pointer_bits,
                           SplitArgs a) {
  if (dtype != ctseg::kFloat32 && dtype != ctseg::kBFloat16) {
    return cudaErrorInvalidValue;
  }
  const int full = dtype == ctseg::kFloat32 ? 4 : 8;
  if (vec != 1 && (vec != full || pointer_bits % 16 != 0 ||
                   (static_cast<long long>(s) * c) % vec != 0)) {
    return cudaErrorInvalidValue;
  }
  if (!make_geometry(s, c, vec, chunks, rows_per_chunk, &a.geo)) {
    return cudaErrorInvalidValue;
  }
  if (dtype == ctseg::kFloat32) {
    return vec == 1 ? F::template run<float, 1>(a)
                    : F::template run<float, 4>(a);
  }
  return vec == 1 ? F::template run<__nv_bfloat16, 1>(a)
                  : F::template run<__nv_bfloat16, 8>(a);
}

// The backward's two forms for the storage type `dtype`: K1b (kSaved
// false) or K2b (kSaved true: x is xhat, var is rsinv, mean unused).
template <bool kSaved>
int bwd_two_phase(const void* x, const void* g, const void* mean,
                  const void* var, const void* alpha, void* dx, void* parts,
                  void* means, int n, int s, int c, int vec, int chunks,
                  int rows_per_chunk, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch_bwd<float, kSaved>(x, g, mean, var, alpha, dx, parts,
                                       means, n, s, c, vec, chunks,
                                       rows_per_chunk, st);
    case ctseg::kBFloat16:
      return launch_bwd<__nv_bfloat16, kSaved>(x, g, mean, var, alpha, dx,
                                               parts, means, n, s, c, vec,
                                               chunks, rows_per_chunk, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kSaved>
int bwd_cluster(const void* x, const void* g, const void* mean,
                const void* var, const void* alpha, void* dx, void* parts,
                int n, int s, int c, int wcc, int cluster_size, int threads,
                int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch_bwd_cluster_threads<float, kSaved>(
          x, g, mean, var, alpha, dx, parts, n, s, c, wcc, cluster_size,
          threads, st);
    case ctseg::kBFloat16:
      return launch_bwd_cluster_threads<__nv_bfloat16, kSaved>(
          x, g, mean, var, alpha, dx, parts, n, s, c, wcc, cluster_size,
          threads, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward (K1f), two-phase form. x, y: (n, s, c) contiguous, of the type
// `dtype` names; alpha: one float32 on the device. `vec`, `chunks`,
// `rows_per_chunk`: the plan of ops/instance_norm.py::fwd_plan (vec 4 or 8
// needs 16-byte aligned x and y and s * c a multiple of vec). parts: (n,
// chunks, 2, lcm(c, vec)) float32 workspace; mean, var: (n, c) float32,
// written (the training forward's outputs, a workspace otherwise). Three
// launches on `stream`; allocates nothing, returns the last cudaError_t.
extern "C" int ctseg_in_prelu_fwd(const void* x, void* y, const void* alpha,
                                  void* parts, void* mean, void* var, int n,
                                  int s, int c, int vec, int chunks,
                                  int rows_per_chunk, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch_fwd<float>(x, y, alpha, parts, mean, var, n, s, c, vec,
                               chunks, rows_per_chunk, st);
    case ctseg::kBFloat16:
      return launch_fwd<__nv_bfloat16>(x, y, alpha, parts, mean, var, n, s, c,
                                       vec, chunks, rows_per_chunk, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Forward (K1f), read-once form, where ops/instance_norm.py::
// fwd_cluster_plan gives a cluster size (8 or 16) and a tile width `wcc` (in
// 16-byte vectors of the super-row). mean_out, var_out: (n, c) float32 for
// the training forward, or both null (serving: no extra writes). One launch
// on `stream`.
extern "C" int ctseg_in_prelu_fwd_cluster(const void* x, void* y,
                                          const void* alpha, void* mean_out,
                                          void* var_out, int n, int s, int c,
                                          int wcc, int cluster_size, int dtype,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((mean_out == nullptr) != (var_out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch_fwd_cluster_sized<float>(x, y, alpha, mean_out, var_out, n,
                                             s, c, wcc, cluster_size, st);
    case ctseg::kBFloat16:
      return launch_fwd_cluster_sized<__nv_bfloat16>(
          x, y, alpha, mean_out, var_out, n, s, c, wcc, cluster_size, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward (K1b). x, g, dx: (n, s, c) contiguous, of the type `dtype`
// names; mean, var: (n, c) float32 from the training forward; alpha: one
// float32. `vec`, `chunks`, `rows_per_chunk`: the plan of
// ops/instance_norm.py::bwd_plan (vec 4 or 8 needs 16-byte aligned x, g, dx
// and s * c a multiple of vec). Workspaces: parts, (n, chunks, 3, lcm(c,
// vec)) float32, whose plane 2 holds dalpha's partials, and means, (n, 2, c)
// float32. Three launches on `stream`.
extern "C" int ctseg_in_prelu_bwd(const void* x, const void* g,
                                  const void* mean, const void* var,
                                  const void* alpha, void* dx, void* parts,
                                  void* means, int n, int s, int c, int vec,
                                  int chunks, int rows_per_chunk, int dtype,
                                  int device, void* stream) {
  return bwd_two_phase<false>(x, g, mean, var, alpha, dx, parts, means, n, s,
                              c, vec, chunks, rows_per_chunk, dtype, device,
                              stream);
}

// Backward (K1b), read-once form, where ops/instance_norm.py::
// bwd_cluster_plan gives a cluster size (8 or 16) and a tile width `wcc` (in
// 16-byte vectors): tensors as above; c a multiple of the vector's elements;
// parts: (n, cluster_size, 3, c) float32, of which only plane 2 (dalpha's
// partials) is written. One launch on `stream`.
extern "C" int ctseg_in_prelu_bwd_cluster(const void* x, const void* g,
                                          const void* mean, const void* var,
                                          const void* alpha, void* dx,
                                          void* parts, int n, int s, int c,
                                          int wcc, int cluster_size, int dtype,
                                          int device, void* stream) {
  return bwd_cluster<false>(x, g, mean, var, alpha, dx, parts, n, s, c, wcc,
                            cluster_size, kClusterThreads, dtype, device,
                            stream);
}

// K2b: the PReLU + InstanceNorm backward of K2 from its saved xhat and rsinv
// (see the note at the top of this file), in K1b's two forms and kernels:
//   gh = g * (xhat >= 0 ? 1 : alpha)
//   dy = rsinv * (gh - mean(gh) - xhat * mean(gh * xhat))
//   dalpha = sum(g * min(xhat, 0)), plane 2 of `parts`.
// g, xhat, dy: (n, s, c) contiguous, of the type `dtype` names; rsinv: (n,
// c) float32; alpha: one float32. Two-phase form: the plan, workspaces and
// launches of ctseg_in_prelu_bwd.
extern "C" int ctseg_in_prelu_bwd_saved(const void* g, const void* xhat,
                                        const void* rsinv, const void* alpha,
                                        void* dy, void* parts, void* means,
                                        int n, int s, int c, int vec,
                                        int chunks, int rows_per_chunk,
                                        int dtype, int device, void* stream) {
  return bwd_two_phase<true>(xhat, g, nullptr, rsinv, alpha, dy, parts, means,
                             n, s, c, vec, chunks, rows_per_chunk, dtype,
                             device, stream);
}

// K2b, read-once form: the workspace and launch of
// ctseg_in_prelu_bwd_cluster, by the plan of ops/conv_block.py::bwd_plan (a
// cluster of 1, 2, 4, 8 or 16 blocks of 512 or 256 threads).
extern "C" int ctseg_in_prelu_bwd_saved_cluster(
    const void* g, const void* xhat, const void* rsinv, const void* alpha,
    void* dy, void* parts, int n, int s, int c, int wcc, int cluster_size,
    int threads, int dtype, int device, void* stream) {
  return bwd_cluster<true>(xhat, g, nullptr, rsinv, alpha, dy, parts, n, s, c,
                           wcc, cluster_size, threads, dtype, device, stream);
}

// The split form of K1f/K1b across depth slabs (see the kernels above). x,
// g, y, dx: one slab, (n, s, c) contiguous, of the type `dtype` names; mean,
// var: (n, c) float32, the global statistics; alpha: one float32. `vec`,
// `chunks`, `rows_per_chunk`: the plan of ops/instance_norm.py::fwd_plan
// (forward) or bwd_plan (backward) at the slab's shape. parts: the
// two-phase form's workspace, (n, chunks, 2 or 3, lcm(c, vec)) float32;
// totals: (n, 2, c) float32. Each returns the last cudaError_t.

// Forward statistics: totals = the slab's sums of x and x^2. Two launches.
extern "C" int ctseg_in_prelu_split_fwd_sums(const void* x, void* parts,
                                             void* totals, int n, int s, int c,
                                             int vec, int chunks,
                                             int rows_per_chunk, int dtype,
                                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  SplitArgs a{x, nullptr, nullptr, nullptr, nullptr, nullptr,
              static_cast<float*>(parts), static_cast<float*>(totals),
              nullptr, n, {}, static_cast<cudaStream_t>(stream)};
  return dispatch_split<SplitFwdSums>(dtype, vec, s, c, chunks, rows_per_chunk,
                                      reinterpret_cast<uintptr_t>(x), a);
}

// Forward normalisation: y = PReLU((x - mean) * rsqrt(var + eps)). One
// launch.
extern "C" int ctseg_in_prelu_split_fwd_apply(const void* x, const void* mean,
                                              const void* var,
                                              const void* alpha, void* y,
                                              int n, int s, int c, int vec,
                                              int chunks, int rows_per_chunk,
                                              int dtype, int device,
                                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  SplitArgs a{x, nullptr, static_cast<const float*>(mean),
              static_cast<const float*>(var), static_cast<const float*>(alpha),
              nullptr, nullptr, nullptr, y, n, {},
              static_cast<cudaStream_t>(stream)};
  return dispatch_split<SplitFwdApply>(
      dtype, vec, s, c, chunks, rows_per_chunk,
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y), a);
}

// Backward statistics: totals = the slab's sums of gh and gh * xhat; plane 2
// of parts holds the slab's dalpha partials. Two launches.
extern "C" int ctseg_in_prelu_split_bwd_sums(const void* x, const void* g,
                                             const void* mean, const void* var,
                                             const void* alpha, void* parts,
                                             void* totals, int n, int s, int c,
                                             int vec, int chunks,
                                             int rows_per_chunk, int dtype,
                                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  SplitArgs a{x, g, static_cast<const float*>(mean),
              static_cast<const float*>(var), static_cast<const float*>(alpha),
              nullptr, static_cast<float*>(parts), static_cast<float*>(totals),
              nullptr, n, {}, static_cast<cudaStream_t>(stream)};
  return dispatch_split<SplitBwdSums>(
      dtype, vec, s, c, chunks, rows_per_chunk,
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g), a);
}

// Backward dx from the global means (n, 2, c) of gh and gh * xhat. One
// launch.
extern "C" int ctseg_in_prelu_split_bwd_apply(
    const void* x, const void* g, const void* mean, const void* var,
    const void* alpha, const void* means, void* dx, int n, int s, int c,
    int vec, int chunks, int rows_per_chunk, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  SplitArgs a{x, g, static_cast<const float*>(mean),
              static_cast<const float*>(var), static_cast<const float*>(alpha),
              static_cast<const float*>(means), nullptr, nullptr, dx, n, {},
              static_cast<cudaStream_t>(stream)};
  return dispatch_split<SplitBwdApply>(
      dtype, vec, s, c, chunks, rows_per_chunk,
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
          reinterpret_cast<uintptr_t>(dx),
      a);
}

extern "C" const char* ctseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
