// Shallow-channel weight gradient of the stride-1 3D conv: dW and db of
// the conv that runs with few channels at the top of the decoder, from x
// and dy in their (N, *spatial, C) channels_last views.
//
// Replaces: the weight-gradient half of `_conv_smallc_bwd` in
// ctseg_tpu/ops/shallow_grad.py (a jnp custom VJP, not a Pallas kernel: dW
// through the merged (D, C) fold `_dw_merged_3d`). With t a tap (kh, kw,
// kd) of an odd k, pad p = (k - 1) / 2 (torch's conventions, out-of-range
// taps read zero),
//   dW[t, ci, co] = sum over (n, o) of x[n, o + t - p, ci] * dy[n, o, co]
//   db[co]        = sum over (n, o) of dy[n, o, co]
// over dy's voxels o, written as torch's (Cout, Cin, *k) weight. The k = 3,
// s = 2 transposed conv that the same rule (`smallc_supported`) routes has
// its own kernel, csrc/shallow_dwt.cu.
//
// dy is the "base" operand, read at the voxel; x the "gathered" one, read
// at voxel - pad + tap on each axis.
//
// What bounds it on an H100: in float32, operations. At the bench_3d site
// (batch 128) the 10 -> 10 conv does 172 GFLOP against 2.7 GB of x and dy:
// 64 FLOP a byte, above the FP32 pipes' 20 (67 TFLOP/s over 3.35 TB/s), a
// bound of 2.57 ms. cuDNN's FP32 weight gradient takes 511-541 ms there:
// with 10 channels its GEMM's N dimension is 10 wide. In bfloat16 the bound
// is the bytes (0.40 ms at 989 TFLOP/s).
//
// Design (a first version that is right, not yet near its bound):
//   - float32: an implicit GEMM on the FP32 pipes, M = taps x Cin,
//     N = Cout, K = the voxels. Each warp owns one tap and a tile of T input
//     by S output channels (S = Cout rounded up to 4, 8, 10 or 16; T = 16,
//     12, 10 or 8 with it); its 32 lanes take 32 voxels at a time, each lane
//     a T x S outer product a voxel: T + S loads from shared memory feed
//     T * S FMAs (100 at the sites), reduced across the warp by a fixed
//     butterfly at the end.
//   - bfloat16: the tensor cores, mma.sync m16n8k16 (bf16 x bf16 -> f32;
//     the products are exact), the warp's tap by a 16 x 16 (Cin, Cout) tile,
//     16 voxels a step; both fragments come from voxel-major shared rows by
//     ldmatrix.trans (rows of 16 values at a 48-byte stride: no bank
//     conflicts), and the tensor cores' sums are added into float32
//     registers once a strip, so their own accumulation chain is short.
//   - A block is 9 warps on consecutive taps: the (kw, kd) taps of one kh
//     (k * k of them, 9 at k = 3, in ceil(k * k / 9) blocks), for one (Cin
//     tile, Cout tile). It walks a strip of voxels at a time: one (n, h)
//     row of the base operand, t1 columns of w and all t2 = d depths,
//     staged in shared memory with the gathered operand's window around it
//     (zero where it leaves the tensor, so the inner loop has no bounds
//     checks), double-buffered
//     by 4-byte cp.async so a strip copies while the last one computes (the
//     contiguous base rows word by word across the lanes, the window a
//     thread a row). The strip is 1024 voxels or the most that fits a block
//     in float32, 128 in bfloat16 (ops/shallow_grad.py::STRIPS, from
//     csrc/tools/sweep_shallow_dw.py). The plan is computed once, by
//     ops/shallow_grad.py::dw_plan; the C entry checks it.
//   - Deterministic, no atomics, in two launches: the grid's second
//     dimension is G groups of strips, each block's lanes keep their sums in
//     registers over its strips (at most 512 voxels a lane in float32, so a
//     float32 chain stays short) and write one partial per (group, tap, Cin,
//     Cout); db's lane sums are float32 over 4 voxels (bfloat16: a strip)
//     and float64 from there on; the finalize launch sums the G partials in group order in
//     float64 and writes dW (and db, from the dy rows that cover each voxel
//     once) in w's type. The grid is sized by the outputs (27 x 10 x 10
//     taps, Cin and Cout into 3 blocks a group in float32) and by G, not by
//     the SMs alone.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 16b and
// csrc/tools/sweep_shallow_dw.py): float32 11.0 ms at the 10 -> 10 conv,
// 0.23 of the bound (db's float64 flushes every kDbChain voxels take 6-9%
// of it); bfloat16 7.7. What bounds it is not settled. Not the number of
// copy instructions: copying only a row's channel words, at 8 or 16 bytes
// where aligned, moved the sites by -8% to +5% (PERF.md, ROADMAP.md).
#include "common.cuh"

namespace {

using ctseg::cp_async_commit;
using ctseg::cp_async_wait;
using ctseg::from_float;

constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90
constexpr int kWarps = 9;           // taps a block
// Voxels a lane sums db over in float32 before its float64 sum: a float32
// chain of a strip's 32 was 2.9x torch's float32 sum's error (phase 16b).
constexpr int kDbChain = 4;
constexpr unsigned kFull = 0xffffffffu;

// n / d for 0 <= n < 2^31 by one multiply-high (CUTLASS's FastDivmod).
struct FastDiv {
  unsigned int div, mul, shr;
};

FastDiv make_fastdiv(int d) {
  FastDiv f{static_cast<unsigned>(d), 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1u << l) < static_cast<unsigned>(d)) ++l;  // ceil(log2 d)
    const unsigned p = 31 + l;
    f.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return f.div == 1 ? n
                    : static_cast<int>(__umulhi(static_cast<unsigned>(n),
                                                f.mul) >> f.shr);
}

// 4 bytes global -> shared, or 4 zero bytes when !pred.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

struct Geom {
  const uint32_t* x;   // (n, e0, e1, e2, cin) as 4-byte words
  const uint32_t* dy;  // (n, e0, e1, e2, cout)
  float* part;         // (groups, taps, cip, cop)
  double* dbpart;      // (groups, taps, cop)
  int n, e0, e1, e2;   // x's and dy's extents
  int k, p, taps;      // taps an axis, the pad (k - 1) / 2, k^3
  int chunks;                          // blocks for one h tap's (w, d) taps
  int cin, cout, cw_x, cw_dy;          // channels, and words a row
  int n_t, n_s, cip, cop;              // tiles and padded extents
  int t1, t2, nw1, qtot, groups;       // a strip: t1 columns of t2 depths
  int w2, r1max;                       // the gathered window's extents
  int sb, sg;                          // shared row strides, words
  int base_words, gath_words;          // one buffer's words of each
  FastDiv div_nw1, div_e0, div_t2, div_w2;
};

// Strip qb: one (n, h) row of the base operand, columns w0 .. w0 + t1c and
// all depths.
struct Strip {
  int nn, b0, w0, t1c;
};

__device__ __forceinline__ Strip strip_at(const Geom& g, int qb) {
  Strip s;
  const int t = fdiv(qb, g.div_nw1);
  const int wc = qb - t * g.nw1;
  s.nn = fdiv(t, g.div_e0);
  s.b0 = t - s.nn * g.e0;
  s.w0 = wc * g.t1;
  s.t1c = min(g.t1, g.e1 - s.w0);
  return s;
}

// Stage one strip (qb) into the buffers: t1c x t2 base rows, one
// contiguous run of device memory, which the block's lanes walk word by
// word; the gathered window of h tap kh (r1max x w2 rows, zero outside the
// tensor) goes a thread a row.
template <int kTWb, int kTWg>
__device__ __forceinline__ void stage(const Geom& g, int qb, int kh, int c0x,
                                      int c0dy, uint32_t* sb_buf,
                                      uint32_t* sg_buf) {
  const Strip st = strip_at(g, qb);
  const uint32_t* bsrc = g.dy;
  const uint32_t* gsrc = g.x;
  const int cwb = g.cw_dy, cwg = g.cw_x;
  const int c0b = c0dy, c0g = c0x;
  const int tid = threadIdx.x;

  const int nb = st.t1c * g.t2;
  const size_t row0 =
      ((static_cast<size_t>(st.nn) * g.e0 + st.b0) * g.e1 + st.w0) *
      static_cast<size_t>(g.e2);
  for (int e = tid; e < nb * kTWb; e += blockDim.x) {
    const int r = e / kTWb, k = e - r * kTWb;
    const bool ok = c0b + k < cwb;
    cp_async4(sb_buf + r * g.sb + k,
              ok ? bsrc + (row0 + r) * cwb + c0b + k : bsrc, ok);
  }
  const int rows = g.r1max * g.w2;
  for (int r = tid; r < rows; r += blockDim.x) {
    const int gl1 = fdiv(r, g.div_w2);
    const int gl2 = r - gl1 * g.w2;
    const int g0 = st.b0 - g.p + kh;
    const int g1 = st.w0 - g.p + gl1;
    const int g2 = gl2 - g.p;
    const bool in = static_cast<unsigned>(g0) < static_cast<unsigned>(g.e0) &&
                    static_cast<unsigned>(g1) < static_cast<unsigned>(g.e1) &&
                    static_cast<unsigned>(g2) < static_cast<unsigned>(g.e2) &&
                    gl1 < st.t1c - 1 + g.k;
    const uint32_t* src =
        gsrc +
        (((static_cast<size_t>(st.nn) * g.e0 + (in ? g0 : 0)) * g.e1 +
          (in ? g1 : 0)) * g.e2 + (in ? g2 : 0)) * cwg + c0g;
    uint32_t* dst = sg_buf + r * g.sg;
#pragma unroll
    for (int k = 0; k < kTWg; ++k) {
      const bool ok = in && c0g + k < cwg;
      cp_async4(dst + k, ok ? src + k : gsrc, ok);
    }
  }
}

// The block's walk over its strips: strip qb + G is staged while strip qb
// is handed to `fn(base rows, gathered window, voxels)`; the voxels are
// t1c x t2.
template <int kTWb, int kTWg, typename Fn>
__device__ __forceinline__ void walk(const Geom& g, int kh, int c0x,
                                     int c0dy, bool live, Fn&& fn) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int buf_words = g.base_words + g.gath_words;
  int it = 0;
  if (blockIdx.y < g.qtot) {
    stage<kTWb, kTWg>(g, blockIdx.y, kh, c0x, c0dy, smem,
                      smem + g.base_words);
  }
  cp_async_commit();
  for (int qb = blockIdx.y; qb < g.qtot; qb += g.groups, ++it) {
    const int qn = qb + g.groups;
    if (qn < g.qtot) {
      uint32_t* next = smem + ((it + 1) & 1) * buf_words;
      stage<kTWb, kTWg>(g, qn, kh, c0x, c0dy, next, next + g.base_words);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const uint32_t* sb_buf = smem + (it & 1) * buf_words;
      const int t = fdiv(qb, g.div_nw1);
      const int w0 = (qb - t * g.nw1) * g.t1;
      fn(sb_buf, sb_buf + g.base_words, min(g.t1, g.e1 - w0) * g.t2);
    }
    __syncthreads();  // the buffer is staged again two strips on
  }
  cp_async_wait<0>();
}

// Where a block's warp sits: its tap, tiles and whether it makes db. A
// block's warps take consecutive taps of one h tap kh's (w, d) plane,
// `chunks` blocks covering a plane of more than 9; the centre tap's dy rows
// (dy at every voxel) make db.
struct WarpTap {
  int cs, ct, kh, warp, lane, t1, t2, tap;
  bool live, db;
};

__device__ __forceinline__ WarpTap warp_tap(const Geom& g) {
  WarpTap w;
  w.cs = blockIdx.x % g.n_s;
  w.ct = (blockIdx.x / g.n_s) % g.n_t;
  const int rest = blockIdx.x / (g.n_s * g.n_t);
  w.kh = rest / g.chunks;
  w.warp = threadIdx.x >> 5;
  w.lane = threadIdx.x & 31;
  const int l = (rest % g.chunks) * kWarps + w.warp;
  w.t1 = l / g.k;
  w.t2 = l % g.k;
  w.tap = (w.kh * g.k + w.t1) * g.k + w.t2;
  w.live = l < g.k * g.k;
  w.db = w.live && w.ct == 0 && w.tap == g.taps / 2;
  return w;
}

// The gathered row of voxel q of the strip for the warp's tap.
__device__ __forceinline__ const uint32_t* gathered_row(
    const Geom& g, const uint32_t* sg_buf, int q, int t1, int t2) {
  const int r1 = fdiv(q, g.div_t2);
  const int r2 = q - r1 * g.t2;
  return sg_buf + ((r1 + t1) * g.w2 + r2 + t2) * g.sg;
}

// float32 on the FP32 pipes: a lane's T x S outer product a voxel.
template <int S, int T>
__global__ void __launch_bounds__(kWarps * 32)
    shallow_dw_kernel(const Geom g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const WarpTap w = warp_tap(g);
  float acc[T][S];
#pragma unroll
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) acc[i][j] = 0.f;
  }
  // db's lane sums: float32 over kDbChain of a lane's voxels in registers,
  // float64 from there on in shared memory, after the two buffers.
  double* dba = reinterpret_cast<double*>(
                    smem + 2 * (g.base_words + g.gath_words)) +
                (w.warp * 32 + w.lane) * S;
  if (w.db) {
#pragma unroll
    for (int j = 0; j < S; ++j) dba[j] = 0.0;
  }
  walk<S, T>(
      g, w.kh, w.ct * T, w.cs * S, w.live,
      [&](const uint32_t* sb_buf, const uint32_t* sg_buf, int nq) {
        float dbs[S];
#pragma unroll
        for (int j = 0; j < S; ++j) dbs[j] = 0.f;
        int chain = 0;
        for (int q = w.lane; q < nq; q += 32) {
          const uint32_t* brow = sb_buf + q * g.sb;
          const uint32_t* grow = gathered_row(g, sg_buf, q, w.t1, w.t2);
          const float2* xr = reinterpret_cast<const float2*>(grow);
          const float2* dr = reinterpret_cast<const float2*>(brow);
          float xv[T], dv[S];
#pragma unroll
          for (int i = 0; i < T / 2; ++i) {
            const float2 f = xr[i];
            xv[2 * i] = f.x;
            xv[2 * i + 1] = f.y;
          }
#pragma unroll
          for (int j = 0; j < S / 2; ++j) {
            const float2 f = dr[j];
            dv[2 * j] = f.x;
            dv[2 * j + 1] = f.y;
          }
#pragma unroll
          for (int i = 0; i < T; ++i) {
#pragma unroll
            for (int j = 0; j < S; ++j) {
              acc[i][j] = fmaf(xv[i], dv[j], acc[i][j]);
            }
          }
          if (w.db) {
#pragma unroll
            for (int j = 0; j < S; ++j) dbs[j] += dv[j];
            if (++chain == kDbChain) {
#pragma unroll
              for (int j = 0; j < S; ++j) {
                dba[j] += dbs[j];
                dbs[j] = 0.f;
              }
              chain = 0;
            }
          }
        }
        if (w.db) {
#pragma unroll
          for (int j = 0; j < S; ++j) dba[j] += dbs[j];
        }
      });
  if (!w.live) return;

  // Every lane ends with the warp's sum (a + b == b + a: the butterfly's
  // lanes agree), the same bits on every run.
#pragma unroll
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], o);
      }
    }
  }
  const size_t slot = static_cast<size_t>(blockIdx.y) * g.taps + w.tap;
  float* out = g.part + (slot * g.cip + w.ct * T) * g.cop + w.cs * S;
#pragma unroll
  for (int k = 0; k < T * S; ++k) {
    if ((k & 31) == w.lane) out[(k / S) * g.cop + k % S] = acc[k / S][k % S];
  }
  if (w.db) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      double v = dba[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      if (j == w.lane) g.dbpart[slot * g.cop + w.cs * S + j] = v;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(const uint32_t* p,
                                                  uint32_t (&r)[4]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bfloat16 on the tensor cores: the warp's 16 x 16 tile of (Cin, Cout)
// for its tap as mma.sync m16n8k16 products (bf16 x bf16 -> float32) over
// 16 voxels at a time. Shared rows are voxel-major, 16 channels (8 words)
// at a stride of 12 words, so `ldmatrix.trans` gives both fragments
// (A = x as Cin x voxels, B = dy as voxels x Cout) with every lane naming
// its own row, and a quarter-warp's rows fall on distinct banks. Voxels
// past the strip read a zero row. The tensor cores' sums are added into
// float32 registers once a strip.
__global__ void __launch_bounds__(kWarps * 32)
    shallow_dw_mma_kernel(const Geom g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const WarpTap w = warp_tap(g);
  uint32_t* zero = smem + 2 * (g.base_words + g.gath_words);
  double* dba = reinterpret_cast<double*>(zero + 12) +
                (w.warp * 32 + w.lane) * 8;
  if (threadIdx.x < 12) zero[threadIdx.x] = 0u;
  __syncthreads();
  // A's matrices: voxels 0-7 | 8-15 (lane bit 4) x Cin 0-7 | 8-15 (bit 3);
  // B's: voxels 0-7 | 8-15 (bit 3) x Cout 0-7 | 8-15 (bit 4).
  const int ra = (w.lane & 7) + ((w.lane >> 4) << 3);
  const int ha = ((w.lane >> 3) & 1) * 4;
  const int rb = (w.lane & 7) + (((w.lane >> 3) & 1) << 3);
  const int hb = (w.lane >> 4) * 4;
  float tot[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (w.db) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dba[j] = 0.0;
  }
  walk<8, 8>(
      g, w.kh, w.ct * 8, w.cs * 8, w.live,
      [&](const uint32_t* sb_buf, const uint32_t* sg_buf, int nq) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float dbs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int q0 = 0; q0 < nq; q0 += 16) {
          const int qa = q0 + ra, qb = q0 + rb;
          const uint32_t* xa =
              qa >= nq ? zero : gathered_row(g, sg_buf, qa, w.t1, w.t2) + ha;
          const uint32_t* dyb = qb >= nq ? zero : sb_buf + qb * g.sb + hb;
          uint32_t a[4], b[4];
          ldmatrix_x4_trans(xa, a);
          ldmatrix_x4_trans(dyb, b);
          mma_bf16(acc, a, b[0], b[1]);
          mma_bf16(acc + 4, a, b[2], b[3]);
          if (w.db) {  // this lane's 8 values of Cout for voxel qb
            const uint4 v = *reinterpret_cast<const uint4*>(dyb);
            const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&u[k]));
              dbs[2 * k] += f.x;
              dbs[2 * k + 1] += f.y;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) tot[k] += acc[k];
        if (w.db) {
#pragma unroll
          for (int k = 0; k < 8; ++k) dba[k] += dbs[k];
        }
      });
  if (!w.live) return;
  // The accumulators' layout: rows (Cin) lane / 4 and + 8, columns (Cout)
  // 2 (lane % 4) + {0, 1}, and + 8 for the second product.
  const size_t slot = static_cast<size_t>(blockIdx.y) * g.taps + w.tap;
  float* out = g.part + (slot * g.cip + w.ct * 16) * g.cop + w.cs * 16;
  const int r = w.lane >> 2, c = 2 * (w.lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    out[r * g.cop + c + 8 * h] = tot[4 * h];
    out[r * g.cop + c + 8 * h + 1] = tot[4 * h + 1];
    out[(r + 8) * g.cop + c + 8 * h] = tot[4 * h + 2];
    out[(r + 8) * g.cop + c + 8 * h + 1] = tot[4 * h + 3];
  }
  if (w.db) {  // lanes 0-15 hold Cout 0-7, lanes 16-31 Cout 8-15
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      double v = dba[k];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      if ((w.lane & 15) == 0) {
        g.dbpart[slot * g.cop + w.cs * 16 + (w.lane >> 4) * 8 + k] = v;
      }
    }
  }
}

// One thread an output, enumerated in the partials' (tap, ci, co) order so
// that a warp's reads are contiguous; the last cout threads make db from
// the centre tap's partials. Sums in float64, in group order.
template <typename Sto>
__global__ void shallow_dw_finalize(const Geom g, Sto* dw, Sto* db) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int outs = g.taps * g.cin * g.cout;
  if (idx < outs) {
    const int co = idx % g.cout;
    const int rest = idx / g.cout;
    const int ci = rest % g.cin;
    const int tap = rest / g.cin;
    double s = 0.0;
    const size_t step = static_cast<size_t>(g.taps) * g.cip * g.cop;
    const float* p = g.part + (static_cast<size_t>(tap) * g.cip + ci) * g.cop + co;
    for (int y = 0; y < g.groups; ++y) s += p[y * step];
    dw[(co * g.cin + ci) * g.taps + tap] =
        from_float<Sto>(static_cast<float>(s));
  } else if (idx < outs + g.cout) {
    const int co = idx - outs;
    double s = 0.0;
    const double* p = g.dbpart + static_cast<size_t>(g.taps / 2) * g.cop + co;
    const size_t step = static_cast<size_t>(g.taps) * g.cop;
    for (int y = 0; y < g.groups; ++y) s += p[y * step];
    db[co] = from_float<Sto>(static_cast<float>(s));
  }
}

template <typename K>
cudaError_t launch(K kernel, const Geom& g, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.k * g.chunks * g.n_t * g.n_s, g.groups);
  kernel<<<grid, kWarps * 32, smem, st>>>(g);
  return cudaGetLastError();
}

// The kernel for the type and the Cout tile.
cudaError_t launch_main(const Geom& g, bool bf16, int s_tile, size_t smem,
                        cudaStream_t st) {
  if (bf16) return launch(shallow_dw_mma_kernel, g, smem, st);
  switch (s_tile) {
    case 4: return launch(shallow_dw_kernel<4, 16>, g, smem, st);
    case 8: return launch(shallow_dw_kernel<8, 12>, g, smem, st);
    case 10: return launch(shallow_dw_kernel<10, 10>, g, smem, st);
    case 16: return launch(shallow_dw_kernel<16, 8>, g, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// dW and db of the stride-1 3D conv with an odd kernel k and pad (k - 1) /
// 2 from x and dy, both (n, e0, e1, e2, C) contiguous of one type (float32,
// or bfloat16 with even cin and cout), on the device. The geometry is the
// wrapper's plan (ops/shallow_grad.py::dw_plan, its one copy): strips of t1
// columns by all t2 = e2 depths, `groups` of them, the Cout and Cin tiles
// (s_tile, t_tile; float32 (4, 16), (8, 12), (10, 10) or (16, 8), bfloat16
// (16, 16)), the shared row strides sb and sg in words, one buffer's base
// and gathered words, the shared memory, and the workspaces part (float32,
// groups x taps x cip x cop) and dbpart (float64, groups x taps x cop);
// this entry only checks that they hold what the kernels index. dw is
// torch's (cout, cin, k, k, k) in x's type, db (cout,). Launches on
// `stream`, allocates nothing.
extern "C" int ctseg_shallow_dw(const void* x, const void* dy, void* part,
                                void* dbpart, void* dw, void* db, int n,
                                int e0, int e1, int e2, int cin, int cout,
                                int k, int t1, int t2, int groups, int s_tile,
                                int t_tile, int sb, int sg, int base_words,
                                int gath_words, int smem, long long part_elems,
                                long long dbpart_elems, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool bf16 = dtype == ctseg::kBFloat16;
  const bool tiles_ok =
      bf16 ? s_tile == 16 && t_tile == 16
           : (s_tile == 4 && t_tile == 16) || (s_tile == 8 && t_tile == 12) ||
                 (s_tile == 10 && t_tile == 10) || (s_tile == 16 && t_tile == 8);
  if ((dtype != ctseg::kFloat32 && !bf16) || k < 1 || k % 2 == 0 || n <= 0 ||
      e0 <= 0 || e1 <= 0 || e2 <= 0 || cin <= 0 || cout <= 0 || t1 <= 0 ||
      t1 > e1 || t2 != e2 || groups <= 0 || groups > 65535 ||
      (bf16 && (cin % 2 || cout % 2)) || !tiles_ok) {
    return cudaErrorInvalidValue;
  }
  Geom g{};
  g.x = static_cast<const uint32_t*>(x);
  g.dy = static_cast<const uint32_t*>(dy);
  g.part = static_cast<float*>(part);
  g.dbpart = static_cast<double*>(dbpart);
  g.n = n;
  g.e0 = e0;
  g.e1 = e1;
  g.e2 = e2;
  g.k = k;
  g.p = (k - 1) / 2;
  g.taps = k * k * k;
  g.chunks = static_cast<int>(ceil_div(k * k, kWarps));
  g.cin = cin;
  g.cout = cout;
  g.cw_x = bf16 ? cin / 2 : cin;
  g.cw_dy = bf16 ? cout / 2 : cout;
  g.n_t = static_cast<int>(ceil_div(cin, t_tile));
  g.n_s = static_cast<int>(ceil_div(cout, s_tile));
  g.cip = g.n_t * t_tile;
  g.cop = g.n_s * s_tile;
  g.t1 = t1;
  g.t2 = t2;
  g.nw1 = static_cast<int>(ceil_div(e1, t1));
  const long long qtot = static_cast<long long>(n) * e0 * g.nw1;
  if (qtot > 2147483647LL || static_cast<long long>(t1) * t2 > 65536) {
    return cudaErrorInvalidValue;
  }
  g.qtot = static_cast<int>(qtot);
  g.groups = groups;
  g.w2 = t2 - 1 + k;
  g.r1max = t1 - 1 + k;
  g.sb = sb;
  g.sg = sg;
  g.base_words = base_words;
  g.gath_words = gath_words;
  g.div_nw1 = make_fastdiv(g.nw1);
  g.div_e0 = make_fastdiv(e0);
  g.div_t2 = make_fastdiv(t2);
  g.div_w2 = make_fastdiv(g.w2);
  // Rows hold their tile (float32 rows read as float2: an even stride;
  // bfloat16 rows of 16 values read by ldmatrix: 16-byte aligned), the
  // buffers start 16-byte aligned and hold their rows, and the shared
  // memory holds the two buffers, then (bfloat16) a zero row of 12 words,
  // then db's float64 lane sums.
  const bool rows_ok =
      bf16 ? sb >= 8 && sb % 4 == 0 && sg >= 8 && sg % 4 == 0
           : sb >= s_tile && sb % 2 == 0 && sg >= t_tile && sg % 2 == 0;
  const long long need_smem =
      2 * (static_cast<long long>(base_words) + gath_words) * 4 +
      (bf16 ? 12 * 4 : 0) + static_cast<long long>(kWarps) * 32 *
                                (bf16 ? 8 : s_tile) * 8;
  const long long need = static_cast<long long>(groups) * g.taps * g.cip * g.cop;
  const long long need_db = static_cast<long long>(groups) * g.taps * g.cop;
  if (!rows_ok || base_words % 4 || gath_words % 4 ||
      base_words < static_cast<long long>(t1) * t2 * sb ||
      gath_words < static_cast<long long>(g.r1max) * g.w2 * sg ||
      smem < need_smem || smem > kMaxShared || part_elems < need ||
      dbpart_elems < need_db) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_main(g, bf16, s_tile, smem, st);
  if (err != cudaSuccess) return err;
  const int outs = g.taps * g.cin * g.cout + g.cout;
  if (bf16) {
    shallow_dw_finalize<__nv_bfloat16><<<(outs + 255) / 256, 256, 0, st>>>(
        g, static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db));
  } else {
    shallow_dw_finalize<float><<<(outs + 255) / 256, 256, 0, st>>>(
        g, static_cast<float*>(dw), static_cast<float*>(db));
  }
  return cudaGetLastError();
}
