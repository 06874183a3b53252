// The distance transform's passes around K5 (min_plus.cu): the row scan
// that makes its input and the signed-map arithmetic that consumes its
// output. They replace no Pallas kernel: the JAX package leaves both to XLA
// (ctseg_tpu/ops/edt.py::_scan_distance_1d, edt_squared, signed_distance_map).
// Here the plain torch forms (two cummax, two flips, where, multiply, square,
// clamp; then sqrt, two products, a difference, any, where, a division) were
// some 25 passes over the maps and cost five times K5 itself.
//
// Row scan: for every row along the last axis, the squared, scaled, clamped
// distance to the nearest site,
//   g = min(j - last site at or before j, next site at or after j - j)
//       (exact integers), BIG where the row has no site;
//   d2 = min(fl(fl(g * scale)^2), BIG)       (__fmul_rn twice; nothing to
//                                             contract),
// bit-equal to the plain form. One warp a source row: the row's sites become
// one ballot word per 32 elements (kept in shared memory), a lane finds its
// nearest site to either side with clz / ffs inside its word and from the
// per-word carries outside it. Two sources:
//   - a mask (rows, W) of bytes: the sites are its zeros (edt_squared);
//   - a label map (N, R, W) and C classes: source row (n, c, r) gives two
//     output rows, of the class mask's complement (sites: label == c + 1) at
//     map (0, n, c) and of the mask itself (sites: label != c + 1) at map
//     (1, n, c): the (2, N, C, R, W) stack of booleans is never made. A row
//     of the first kind that holds a site stores 1 into has_site[n * C + c]
//     (a plain store of one value, no counted atomic): the mask is not empty.
//
// Signed map: out = (sqrt(d2_out) * neg - (sqrt(d2_in) - 1) * pos) / 255, zero
// where the mask is empty, with IEEE sqrt and division and each product and
// difference rounded on its own (__fsqrt_rn, __fmul_rn, __fsub_rn,
// __fdiv_rn), as the plain form's separate tensor operations are. One
// elementwise pass: 8 bytes read and 4 written an element, plus the labels.
//
// What bounds both on an H100: bytes (the scan writes 4 bytes an element and
// reads 1 / (2 C) of a label; the signed map moves 12).
#include <climits>

#include "common.cuh"

namespace {

constexpr float kBig = 1e12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanWarps = 8;
constexpr int kNone = INT_MAX;

// Sites of chunk `c` of a row of `w` elements: the stored word, or (`invert`)
// its complement within the row.
__device__ __forceinline__ unsigned sites_of(const unsigned* words, int c,
                                             int w, bool invert) {
  const unsigned wd = words[c];
  if (!invert) return wd;
  const int left = w - c * 32;
  return ~wd & (left >= 32 ? kFull : (1u << left) - 1u);
}

// One output row from the row's ballot words. `nxt` is scratch of `chunks`
// ints. Returns whether the row holds a site. Called by the whole warp.
__device__ __forceinline__ bool emit_row(const unsigned* words, int* nxt,
                                         int w, int chunks, bool invert,
                                         float s, float* __restrict__ out) {
  const int lane = threadIdx.x;
  __syncwarp();
  if (lane == 0) {  // the first site after each chunk
    int carry = kNone;
    for (int c = chunks - 1; c >= 0; --c) {
      nxt[c] = carry;
      const unsigned wd = sites_of(words, c, w, invert);
      if (wd != 0u) carry = c * 32 + __ffs(wd) - 1;
    }
  }
  __syncwarp();
  int prev = -1;  // the last site before the chunk
  for (int c = 0; c < chunks; ++c) {
    const unsigned wd = sites_of(words, c, w, invert);
    const int j = c * 32 + lane;
    const unsigned at_or_before = wd & (kFull >> (31 - lane));
    const unsigned at_or_after = wd & (kFull << lane);
    const int last =
        at_or_before != 0u ? c * 32 + 31 - __clz(at_or_before) : prev;
    const int next =
        at_or_after != 0u ? c * 32 + __ffs(at_or_after) - 1 : nxt[c];
    int d = kNone;
    if (last >= 0) d = j - last;
    if (next != kNone) d = min(d, next - j);
    const float g = d == kNone ? kBig : static_cast<float>(d);
    const float gs = __fmul_rn(g, s);
    if (j < w) out[j] = fminf(__fmul_rn(gs, gs), kBig);
    if (wd != 0u) prev = c * 32 + 31 - __clz(wd);
  }
  return prev >= 0;
}

// Grid: ceil(rows / kScanWarps) blocks of (32, kScanWarps) threads; dynamic
// shared memory 2 * chunks ints a warp.
template <typename L, bool kLabels>
__global__ void __launch_bounds__(32 * kScanWarps)
    row_scan_kernel(const L* __restrict__ src, const float* __restrict__ scale,
                    float* __restrict__ out, int* __restrict__ has_site,
                    long long rows, int w, int chunks, int rows_per_map,
                    int classes, long long samples) {
  extern __shared__ int scan_smem[];
  const long long row =
      static_cast<long long>(blockIdx.x) * kScanWarps + threadIdx.y;
  if (row >= rows) return;  // warps are independent: no block barrier below
  unsigned* words =
      reinterpret_cast<unsigned*>(scan_smem) + threadIdx.y * 2 * chunks;
  int* nxt = scan_smem + (threadIdx.y * 2 + 1) * chunks;
  const int lane = threadIdx.x;

  long long src_row = row, map = row / rows_per_map;
  int want = 0;
  if (kLabels) {  // row = (n * classes + c) * rows_per_map + r
    const long long n = map / classes;
    want = static_cast<int>(map - n * classes) + 1;
    src_row = n * rows_per_map + (row - map * rows_per_map);
  }
  const L* in = src + src_row * w;
#pragma unroll 8  // the chunks' loads go out together, then the ballots
  for (int c = 0; c < chunks; ++c) {
    const int j = c * 32 + lane;
    bool site = false;
    if (j < w) {
      site = kLabels ? static_cast<long long>(in[j]) == want : in[j] == 0;
    }
    const unsigned wd = __ballot_sync(kFull, site);
    if (lane == 0) words[c] = wd;
  }
  const float s = scale == nullptr ? 1.f : scale[map];
  const bool any = emit_row(words, nxt, w, chunks, false, s, out + row * w);
  if (has_site != nullptr && any && lane == 0) has_site[map] = 1;
  if (kLabels) {
    const long long other = samples * classes * rows_per_map + row;
    const float s1 =
        scale == nullptr ? 1.f : scale[samples * classes + map];
    emit_row(words, nxt, w, chunks, true, s1, out + other * w);
  }
}

constexpr int kSignedThreads = 256;

// Grid: maps * ceil(elems / (256 * V)) blocks; block b takes map
// b / blocks_per_map. d2: (2, maps, elems); labels: (maps / classes, elems);
// out: (maps, elems).
template <typename L, int V>
__global__ void __launch_bounds__(kSignedThreads)
    signed_map_kernel(const float* __restrict__ d2,
                      const L* __restrict__ labels,
                      const int* __restrict__ has_site,
                      float* __restrict__ out, long long maps, int elems,
                      int classes, int blocks_per_map) {
  const long long map = blockIdx.x / blocks_per_map;
  const int chunk = blockIdx.x - map * blocks_per_map;
  const int e = (chunk * kSignedThreads + threadIdx.x) * V;
  if (e >= elems) return;
  const long long n = map / classes;
  const int want = static_cast<int>(map - n * classes) + 1;
  const bool nonempty = has_site[map] != 0;
  const size_t at = static_cast<size_t>(map) * elems + e;
  const L* lab = labels + static_cast<size_t>(n) * elems + e;
  float d_out[V], d_in[V], res[V];
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(d2 + at);
    const float4 b = *reinterpret_cast<const float4*>(
        d2 + static_cast<size_t>(maps) * elems + at);
    d_out[0] = a.x, d_out[1] = a.y, d_out[2] = a.z, d_out[3] = a.w;
    d_in[0] = b.x, d_in[1] = b.y, d_in[2] = b.z, d_in[3] = b.w;
  } else {
    d_out[0] = d2[at];
    d_in[0] = d2[static_cast<size_t>(maps) * elems + at];
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool pos = static_cast<long long>(lab[v]) == want;
    const float outside = __fmul_rn(__fsqrt_rn(d_out[v]), pos ? 0.f : 1.f);
    const float inside =
        __fmul_rn(__fsub_rn(__fsqrt_rn(d_in[v]), 1.f), pos ? 1.f : 0.f);
    const float r = nonempty ? __fsub_rn(outside, inside) : 0.f;
    res[v] = __fdiv_rn(r, 255.f);
  }
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(out + at) =
        make_float4(res[0], res[1], res[2], res[3]);
  } else {
    out[at] = res[0];
  }
}

// Codes the Python wrappers pass for the type of a mask or label map.
constexpr int kUInt8 = 0;
constexpr int kInt32 = 1;
constexpr int kInt64 = 2;

template <typename L>
cudaError_t launch_scan(const void* src, const void* scale, void* out,
                        void* has_site, long long rows, int w,
                        int rows_per_map, int classes, long long samples,
                        bool labels, cudaStream_t stream) {
  const int chunks = (w + 31) / 32;
  const size_t shared = static_cast<size_t>(kScanWarps) * 2 * chunks * sizeof(int);
  const long long blocks = (rows + kScanWarps - 1) / kScanWarps;
  if (shared > 48 * 1024 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 block(32, kScanWarps);
  if (labels) {
    row_scan_kernel<L, true><<<static_cast<unsigned>(blocks), block, shared,
                               stream>>>(
        static_cast<const L*>(src), static_cast<const float*>(scale),
        static_cast<float*>(out), static_cast<int*>(has_site), rows, w, chunks,
        rows_per_map, classes, samples);
  } else {
    row_scan_kernel<L, false><<<static_cast<unsigned>(blocks), block, shared,
                                stream>>>(
        static_cast<const L*>(src), static_cast<const float*>(scale),
        static_cast<float*>(out), static_cast<int*>(has_site), rows, w, chunks,
        rows_per_map, classes, samples);
  }
  return cudaGetLastError();
}

template <typename L>
cudaError_t launch_signed(const void* d2, const void* labels,
                          const void* has_site, void* out, long long maps,
                          int elems, int classes, cudaStream_t stream) {
  const bool vec = elems % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(d2) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int per_block = kSignedThreads * (vec ? 4 : 1);
  const int blocks_per_map = (elems + per_block - 1) / per_block;
  const long long blocks = maps * blocks_per_map;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (vec) {
    signed_map_kernel<L, 4><<<static_cast<unsigned>(blocks), kSignedThreads, 0,
                              stream>>>(
        static_cast<const float*>(d2), static_cast<const L*>(labels),
        static_cast<const int*>(has_site), static_cast<float*>(out), maps,
        elems, classes, blocks_per_map);
  } else {
    signed_map_kernel<L, 1><<<static_cast<unsigned>(blocks), kSignedThreads, 0,
                              stream>>>(
        static_cast<const float*>(d2), static_cast<const L*>(labels),
        static_cast<const int*>(has_site), static_cast<float*>(out), maps,
        elems, classes, blocks_per_map);
  }
  return cudaGetLastError();
}

}  // namespace

// Row scan. `labels` == 0: src is a mask (rows, w) of bytes whose zeros are
// the sites, out is (rows, w) float32, one scale per map of rows_per_map
// rows (or null: 1), has_site (rows / rows_per_map,) int32 or null. `labels`
// != 0: src is a label map (samples, rows_per_map, w) of the type `ltype`
// names, out is (2, samples, classes, rows_per_map, w), scale (2 * samples *
// classes,) or null, has_site (samples * classes,) int32, zeroed by the
// caller. w <= 24576 (48 KB of shared memory for 8 warps' words).
extern "C" int ctseg_edt_row_scan(const void* src, const void* scale,
                                  void* out, void* has_site, long long samples,
                                  int rows_per_map, int w, int classes,
                                  int labels, int ltype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (samples <= 0 || rows_per_map <= 0 || w <= 0 || classes <= 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Source rows: one per (sample, class, row) of a label map, one per row of
  // a mask (`samples` counts its maps, `classes` is 1).
  const long long rows = samples * classes * rows_per_map;
  const bool lab = labels != 0;
  switch (ltype) {
    case kUInt8:
      return launch_scan<unsigned char>(src, scale, out, has_site, rows, w,
                                        rows_per_map, classes, samples, lab, st);
    case kInt32:
      return launch_scan<int>(src, scale, out, has_site, rows, w, rows_per_map,
                              classes, samples, lab, st);
    case kInt64:
      return launch_scan<long long>(src, scale, out, has_site, rows, w,
                                    rows_per_map, classes, samples, lab, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Signed maps. d2: (2, maps, elems) float32 squared distances (outside,
// inside); labels: (maps / classes, elems) of the type `ltype` names, the
// mask of map m is labels == m % classes + 1; has_site: (maps,) int32;
// out: (maps, elems) float32.
extern "C" int ctseg_edt_signed_map(const void* d2, const void* labels,
                                    const void* has_site, void* out,
                                    long long maps, int elems, int classes,
                                    int ltype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (maps <= 0 || elems <= 0 || classes <= 0 || maps % classes != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ltype) {
    case kUInt8:
      return launch_signed<unsigned char>(d2, labels, has_site, out, maps,
                                          elems, classes, st);
    case kInt32:
      return launch_signed<int>(d2, labels, has_site, out, maps, elems,
                                classes, st);
    case kInt64:
      return launch_signed<long long>(d2, labels, has_site, out, maps, elems,
                                      classes, st);
    default:
      return cudaErrorInvalidValue;
  }
}
