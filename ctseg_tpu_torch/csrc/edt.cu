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
// bit-equal to the plain form. One warp a source row, taken a segment of
// kSeg = 256 elements at a time: each lane holds kV = 8 consecutive elements
// in registers (one 8-byte load of a uint8 row, 16-byte loads of int32 and
// int64), and an output row's sites are a kV-bit word a lane, made by
// compares: no ballot and no shared memory. Within a lane the last site at or
// before an element and the next at or after it are running selects over the
// word's bits; across lanes they come from two 5-step warp scans
// (__shfl_up_sync of the running max of the lanes' last sites,
// __shfl_down_sync of the running min of their first ones). Each lane writes
// its 8 outputs as two 16-byte stores: a warp writes 1 KB of a row at once.
// Two sources:
//   - a mask (rows, W) of bytes: the sites are its zeros (edt_squared);
//   - a label map (N, R, W) and C classes: the warp reads source row (n, r)
//     once and emits all 2C output rows from its registers: for class c, the
//     class mask's complement (sites: label == c + 1) at map (0, n, c) and
//     the mask itself (sites: label != c + 1) at map (1, n, c). The (2, N, C,
//     R, W) stack of booleans is never made. A row of the first kind that
//     holds a site stores 1 into has_site[n * C + c] (a plain store of one
//     value, no counted atomic): the mask is not empty.
// A row longer than one segment (up to kMaxW) is taken one output row at a
// time: a right-to-left pass leaves each segment's next-site carry in shared
// memory (one __reduce_min_sync a segment), then the left-to-right pass
// emits with the last-site carry in a register. A width that is no multiple
// of kV, or an unaligned tensor, loads and stores element by element (kVec
// false); the arithmetic is the same.
//
// Signed map: out = (sqrt(d2_out) * neg - (sqrt(d2_in) - 1) * pos) / 255, zero
// where the mask is empty, with IEEE sqrt and division and each product and
// difference rounded on its own (__fsqrt_rn, __fmul_rn, __fsub_rn,
// __fdiv_rn), as the plain form's separate tensor operations are. One
// elementwise pass: 8 bytes read and 4 written an element, plus the labels.
//
// What bounds both on an H100: bytes (the scan writes 4 bytes an element and
// reads 1 / (2 C) of a label; the signed map moves 12). A fill of the scan's
// output alone runs at 0.185 ms for the Model M step's 604 MB.
#include "common.cuh"

namespace {

constexpr float kBig = 1e12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanWarps = 8;
constexpr int kV = 8;             // elements a lane holds
constexpr int kSeg = 32 * kV;     // elements a warp takes at once
constexpr int kMaxW = 24576;      // ops/edt.py's MAX_W
constexpr int kMaxSegs = kMaxW / kSeg;
constexpr int kFar = 1 << 30;     // a site index beyond every row: none there
constexpr int kNoSite = 1 << 29;  // a distance this long: the row has none

// A lane's elements: int, or long long for int64 labels.
template <typename L>
struct Lane {
  using T = int;
};
template <>
struct Lane<long long> {
  using T = long long;
};

// The kV elements of `row` from j0 (lanes past the row's end load nothing).
template <typename L, bool kVec>
__device__ __forceinline__ void load_lane(const L* __restrict__ row, int j0,
                                          int w,
                                          typename Lane<L>::T (&v)[kV]) {
#pragma unroll
  for (int i = 0; i < kV; ++i) v[i] = 0;
  if (!kVec) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (j0 + i < w) v[i] = row[j0 + i];
    }
    return;
  }
  if (j0 >= w) return;
  if constexpr (sizeof(L) == 1) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + j0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = (u.x >> (8 * i)) & 0xff;
      v[4 + i] = (u.y >> (8 * i)) & 0xff;
    }
  } else if constexpr (sizeof(L) == 4) {
    const int4* p = reinterpret_cast<const int4*>(row + j0);
    const int4 a = p[0], b = p[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    const longlong2* p = reinterpret_cast<const longlong2*>(row + j0);
#pragma unroll
    for (int q = 0; q < kV / 2; ++q) {
      const longlong2 t = p[q];
      v[2 * q] = t.x, v[2 * q + 1] = t.y;
    }
  }
}

// Bit i: element j0 + i lies in a row of w elements.
__device__ __forceinline__ unsigned valid_bits(int j0, int w) {
  const int left = w - j0;
  return left <= 0 ? 0u : left >= kV ? (1u << kV) - 1u : (1u << left) - 1u;
}

// Bit i: v[i] == want.
template <typename T>
__device__ __forceinline__ unsigned match_bits(const T (&v)[kV], T want) {
  unsigned bits = 0u;
#pragma unroll
  for (int i = 0; i < kV; ++i) bits |= static_cast<unsigned>(v[i] == want) << i;
  return bits;
}

// d2 of an element d steps from its nearest site (kNoSite or more: the row
// has none). g is d as a float without a conversion instruction (the
// mantissa of 2^23 + d, less 2^23: exact, one full-rate add).
__device__ __forceinline__ float distance2(int d, float s) {
  const float g = d >= kNoSite ? kBig
                               : __fsub_rn(__int_as_float(0x4b000000 | d),
                                           8388608.f);
  const float gs = __fmul_rn(g, s);
  return fminf(__fmul_rn(gs, gs), kBig);
}

// One segment of one output row. Bit i of `s` says whether element j0 + i is
// a site; last_in is the last site before the segment (-kFar: none), next_in
// the first after it (kFar: none). Writes the lane's d2 into out (the output
// row) and returns the last site up to the segment's end (-kFar: none).
// Called by the whole warp.
template <bool kVec>
__device__ __forceinline__ int emit_segment(unsigned s, int j0, int w,
                                            int last_in, int next_in,
                                            float scale,
                                            float* __restrict__ out) {
  const int lane = threadIdx.x;
  int last = s != 0u ? j0 + 31 - __clz(s) : -kFar;  // the lane's own
  int first = s != 0u ? j0 + __ffs(s) - 1 : kFar;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // inclusive scans across the lanes
    const int up = __shfl_up_sync(kFull, last, o);
    const int down = __shfl_down_sync(kFull, first, o);
    if (lane >= o) last = max(last, up);
    if (lane < 32 - o) first = min(first, down);
  }
  const int seg_last = max(__shfl_sync(kFull, last, 31), last_in);
  // The nearest sites in the lanes before and after this one.
  int before = __shfl_up_sync(kFull, last, 1);
  int after = __shfl_down_sync(kFull, first, 1);
  before = lane == 0 ? last_in : max(before, last_in);
  after = lane == 31 ? next_in : min(after, next_in);
  int next[kV];
#pragma unroll
  for (int i = kV - 1; i >= 0; --i) {
    if (s >> i & 1u) after = j0 + i;
    next[i] = after;
  }
  float d2[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int j = j0 + i;
    if (s >> i & 1u) before = j;
    d2[i] = distance2(min(j - before, next[i] - j), scale);
  }
  if (kVec) {
    if (j0 < w) {
      float4* o = reinterpret_cast<float4*>(out + j0);
      o[0] = make_float4(d2[0], d2[1], d2[2], d2[3]);
      o[1] = make_float4(d2[4], d2[5], d2[6], d2[7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (j0 + i < w) out[j0 + i] = d2[i];
    }
  }
  return seg_last;
}

// One output row longer than a segment. sites(g) gives the lane's site bits
// in segment g; carry is one int a segment of shared memory. Returns whether
// the row holds a site. Called by the whole warp.
template <bool kVec, typename Sites>
__device__ __forceinline__ bool emit_long_row(Sites sites, int segs, int w,
                                              float scale, float* out,
                                              int* carry) {
  const int lane = threadIdx.x;
  int next = kFar;  // the first site after segment g
  for (int g = segs - 1; g >= 0; --g) {
    const unsigned s = sites(g);
    if (lane == 0) carry[g] = next;
    next = min(next, __reduce_min_sync(
                         kFull, s != 0u ? g * kSeg + lane * kV + __ffs(s) - 1
                                        : kFar));
  }
  __syncwarp();
  int last = -kFar;
  for (int g = 0; g < segs; ++g) {
    last = emit_segment<kVec>(sites(g), g * kSeg + lane * kV, w, last,
                              carry[g], scale, out);
  }
  __syncwarp();  // every lane has read the carries before they are rewritten
  return last >= 0;
}

// Grid: ceil(rows / kScanWarps) blocks of (32, kScanWarps) threads, one warp
// a source row: a mask row, or a label row (n, r) with all its classes.
template <typename L, bool kLabels, bool kVec>
__global__ void __launch_bounds__(32 * kScanWarps)
    row_scan_kernel(const L* __restrict__ src, const float* __restrict__ scale,
                    float* __restrict__ out, int* __restrict__ has_site,
                    long long rows, int w, int rows_per_map, int classes,
                    long long samples) {
  using T = typename Lane<L>::T;
  __shared__ int carries[kScanWarps][kMaxSegs];
  const long long row =
      static_cast<long long>(blockIdx.x) * kScanWarps + threadIdx.y;
  if (row >= rows) return;  // warps are independent: no block barrier below
  const int lane = threadIdx.x;
  const int j0 = lane * kV;
  const int segs = (w + kSeg - 1) / kSeg;
  int* carry = carries[threadIdx.y];
  const long long map = row / rows_per_map;  // the mask, or the sample n
  const L* in = src + row * w;
  // The lane's site bits in segment g where the elements equal `want`, or
  // (`other`) where they do not.
  auto sites = [&](int g, T want, bool other) {
    T v[kV];
    load_lane<L, kVec>(in, g * kSeg + j0, w, v);
    const unsigned bits = match_bits(v, want);
    return (other ? ~bits : bits) & valid_bits(g * kSeg + j0, w);
  };
  if (!kLabels) {  // sites at the zeros
    const float s = scale == nullptr ? 1.f : scale[map];
    float* o = out + row * w;
    const bool any =
        segs == 1
            ? emit_segment<kVec>(sites(0, T(0), false), j0, w, -kFar, kFar, s,
                                 o) >= 0
            : emit_long_row<kVec>(
                  [&](int g) { return sites(g, T(0), false); }, segs, w, s, o,
                  carry);
    if (has_site != nullptr && any && lane == 0) has_site[map] = 1;
    return;
  }
  const long long r = row - map * rows_per_map;
  const size_t plane =
      static_cast<size_t>(samples) * classes * rows_per_map * w;
  T v[kV];  // a row of one segment stays in registers for every class
  if (segs == 1) load_lane<L, kVec>(in, j0, w, v);
  const unsigned valid = valid_bits(j0, w);
  for (int c = 0; c < classes; ++c) {
    const long long m = map * classes + c;  // map (n, c)
    float* o0 = out + (m * rows_per_map + r) * w;
    float* o1 = o0 + plane;
    const float s0 = scale == nullptr ? 1.f : scale[m];
    const float s1 = scale == nullptr ? 1.f : scale[samples * classes + m];
    const T want = static_cast<T>(c + 1);
    bool any;
    if (segs == 1) {
      const unsigned pos = match_bits(v, want) & valid;
      any = emit_segment<kVec>(pos, j0, w, -kFar, kFar, s0, o0) >= 0;
      emit_segment<kVec>(~pos & valid, j0, w, -kFar, kFar, s1, o1);
    } else {
      any = emit_long_row<kVec>([&](int g) { return sites(g, want, false); },
                                segs, w, s0, o0, carry);
      emit_long_row<kVec>([&](int g) { return sites(g, want, true); }, segs,
                          w, s1, o1, carry);
    }
    if (any && lane == 0) has_site[m] = 1;
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

template <typename L, bool kLabels>
cudaError_t launch_scan(const void* src, const void* scale, void* out,
                        void* has_site, long long rows, int w,
                        int rows_per_map, int classes, long long samples,
                        cudaStream_t stream) {
  const long long blocks = (rows + kScanWarps - 1) / kScanWarps;
  if (w > kMaxW || blocks > 2147483647LL) return cudaErrorInvalidValue;
  const bool vec = w % kV == 0 && (reinterpret_cast<uintptr_t>(src) |
                                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const dim3 block(32, kScanWarps);
  auto* kernel = vec ? row_scan_kernel<L, kLabels, true>
                     : row_scan_kernel<L, kLabels, false>;
  kernel<<<static_cast<unsigned>(blocks), block, 0, stream>>>(
      static_cast<const L*>(src), static_cast<const float*>(scale),
      static_cast<float*>(out), static_cast<int*>(has_site), rows, w,
      rows_per_map, classes, samples);
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
// the sites (ltype must name uint8; `classes` is 1), out is (rows, w)
// float32, one scale per map of rows_per_map rows (or null: 1), has_site
// (rows / rows_per_map,) int32 or null. `labels` != 0: src is a label map
// (samples, rows_per_map, w) of the type `ltype` names, out is (2, samples,
// classes, rows_per_map, w), scale (2 * samples * classes,) or null,
// has_site (samples * classes,) int32, zeroed by the caller. w <= 24576.
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
  // Source rows, one warp each: every class of a label map comes from one
  // read of its row.
  const long long rows = samples * rows_per_map;
  if (labels == 0) {
    if (ltype != kUInt8 || classes != 1) return cudaErrorInvalidValue;
    return launch_scan<unsigned char, false>(src, scale, out, has_site, rows,
                                             w, rows_per_map, 1, samples, st);
  }
  switch (ltype) {
    case kUInt8:
      return launch_scan<unsigned char, true>(src, scale, out, has_site, rows,
                                              w, rows_per_map, classes,
                                              samples, st);
    case kInt32:
      return launch_scan<int, true>(src, scale, out, has_site, rows, w,
                                    rows_per_map, classes, samples, st);
    case kInt64:
      return launch_scan<long long, true>(src, scale, out, has_site, rows, w,
                                          rows_per_map, classes, samples, st);
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
