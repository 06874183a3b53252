// Weight and bias gradients of the shallow k = 3, s = 2 transposed conv (pad
// 1, output padding 1) into at most 16 channels a tile, in 2D and 3D, from
// x (n, *S, Cin) and dy (n, *2S, Cout) in their channels_last views:
//   dW[ci, co, t] = sum over (n, i) of x[n, i, ci] * dy[n, 2i - 1 + t, co]
//   db[co]        = sum over dy of dy[..., co]
// per axis, taps reading outside dy reading zero (torch's out[o] += x[i] *
// w[t] for o = 2i - 1 + t), dW in torch's (Cin, Cout, *k) layout. In 3D dy
// may hold fewer than 2 x's rows along D (f2: a depth slab's output rows,
// its x extended by the halo row after it); the rows past f2 read zero.
//
// Replaces: the weight-gradient half of `_convt_smallc_bwd` in
// ctseg_tpu/ops/shallow_grad.py (a jnp custom VJP, not a Pallas kernel: dW
// as a conv over dy with x as a stride-dilated kernel and the batch
// contracted, then flipped). csrc/shallow_dw.cu keeps the stride-1 3D map.
//
// What bounded the kernel it replaces (csrc/shallow_dw.cu's transposed map,
// timed by variants of it before it went; PERF.md): its blocks were one
// Cin tile by 9 taps, so every strip's dy window was staged again by each
// of 8-13 Cin tiles (and by 3 kh blocks in 3D); staging it once a strip
// took 28-35% off, and its copies and its products did not overlap
// (staging alone plus products alone made the whole time).
//
// Design:
//   - A block owns a chunk of Cin (up to 128 channels, 16 a warp), a tile of
//     16 Cout and, in 3D, one kh (27 taps of 16 x 16 accumulators do not fit
//     a warp's registers: 9 do, 72 floats a lane). It stages a strip of x
//     voxels (t1 columns of w by t2 depths: all of d, or d in tiles of one
//     column) with all its Cin once, and the dy rows their taps read once,
//     into a ring of kStages buffers by `cp.async` (x rows 16 bytes at a
//     time where aligned; dy rows 8 bytes (float32) or 4 at a time, a
//     thread a row: a dy voxel of 10 channels is 20 or 40 bytes, no run of
//     16). The 3 kh blocks of a 3D strip are neighbours in the grid, so two
//     of the three read x from L2.
//   - Warp-specialised: a staging warpgroup (`produce`, 4 warps) fills the
//     ring and, in float32, splits each strip's dy window once; 8 warps
//     compute. Each buffer has a full and an empty mbarrier: the stagers
//     arrive at full when their copies of a strip have landed, the
//     computing warps at empty when they are done with it, so copies and
//     products overlap and no computing warp issues a copy. setmaxnreg
//     gives the stagers 40 registers and the computing warps 232 (launch
//     bounds of 384 threads cap the kernel at 168). This replaced 8 warps
//     that both staged and computed (PERF.md, PR 14: 1-16% faster at the
//     sites, csrc/tools/sweep_shallow_dw.py).
//   - dy by parity: the window is stored de-interleaved by the parity of
//     each stride-2 axis (2D: 3 dy rows (kh) x 2 planes of w; 3D: the
//     block's dy row x 4 planes (w, d)). Tap t of an axis reads the odd
//     plane shifted by 0 (t = 0), the even plane (t = 1) or the odd plane
//     shifted by 1 (t = 2): each tap's operand for a run of x voxels is a
//     run of rows of one plane, a plain GEMM over the same x tile, and
//     ldmatrix reads it without bank conflicts.
//   - One x fragment for all taps: warps own Cin tiles of 16 (where Cin is
//     under 128, the warps left over take every other k-step, `slices`);
//     each loads its x fragment once a k-step and runs it against the 9
//     taps' dy fragments, so no two warps load the same x fragment. A
//     k-step's 10 (bfloat16) fragments are loaded before its products.
//   - bfloat16: mma.sync m16n8k16 (bf16 x bf16 -> f32, products exact), both
//     fragments by ldmatrix.trans from voxel-major rows (x rows at an odd
//     number of 16-byte units, dy rows at 48 bytes). float32: the split-TF32
//     scheme of csrc/conv_block.cu (a = big + small, a*b as small*big +
//     big*small + big*big; the dropped small*small is float32's own
//     rounding) on mma.sync m16n8k8: x's fragments by 32-bit shared loads,
//     split in registers; the dy window split once a strip (by the
//     stagers, into one of kStages - 1 split windows) into (big, small)
//     pairs that one 8-byte load fetches (rows of kSplitWords words: a
//     half-warp's loads on distinct banks).
//   - The tensor cores add by truncation, so each strip's products go into
//     a fresh accumulator (a chain of at most 8 k-steps) that is added to
//     the running one on the FP32 pipes (round to nearest), as K2f does a
//     step's.
//   - db from the same pass: the 4 taps (kh, kw, kd in {1, 2}) that together
//     read every dy voxel once; their 8 (tap, Cout half) pairs go one to a
//     Cin tile's warp, which loads the pair's dy values with its other
//     fragments (bfloat16: one ldmatrix.x2) and sums them, float32 over 4
//     values, then float64; no branch in the k-step but that loop.
//   - Deterministic, no atomics: each block sums its strips (a contiguous
//     range, G groups of them) and writes one partial per (slice, tap, Cin,
//     Cout) and one db partial; a finalize launch sums them in a fixed order
//     in float64 and writes dW and db in x's type.
//   - Odd channel counts and unaligned rows: the buffers are zeroed once, so
//     channels past Cin or Cout stay zero; rows copy by 4 bytes (or 2, for
//     bfloat16 with an odd count) where 16 or 8 do not align (kVec false).
// Registers (ptxas -v, sm_90a): 168 a thread at 384 threads, 1 block an SM;
// bfloat16 no spills, float32 4 bytes of spill stores (chip_smoke.py prints
// them). The ring (kStages 3), the strips and one group an SM are the
// sweep's best (sweep_shallow_dw.py --dwt-stages --dwt-groups-per-sm,
// PERF.md). What bounds it now: PERF.md (variants_shallow_dw.py). The
// geometry (strip, chunks, row strides, buffer words, groups, shared
// memory) is ops/shallow_grad.py::dwt_plan's, its one copy; the C entry
// checks it.
#include "common.cuh"

namespace {

using ctseg::cp_async16;
using ctseg::cp_async_commit;
using ctseg::cp_async_wait;
using ctseg::from_float;

constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90
constexpr int kWarps = 8;           // Cin tiles of 16 (or k-step slices)
constexpr int kConsumers = kWarps * 32;
constexpr int kProducers = 128;     // the staging warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kProducerRegs = 40;   // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;  // <= 65536 registers an SM
constexpr int kStages = 3;          // the ring of strips
constexpr int kTaps = 9;            // a block's taps
constexpr int kSplitWords = 40;     // a split float32 window row: 16 pairs
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

// 8 bytes global -> shared, or 8 zero bytes when !pred.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

struct Geom {
  const unsigned char* x;   // (n, e0, e1, e2, cin)
  const unsigned char* dy;  // (n, f0, f1, f2, cout)
  float* part;              // (groups, roles, slices, 9, cin_c, 16)
  double* dbpart;           // (groups, roles, 16)
  int isz;                  // bytes an element
  int nd, n, e0, e1, e2, f0, f1, f2, cin, cout;
  int n_ct, cin_c, n_cic, n_cot, nkh, roles, slices;
  int t1, t2, nw1, nw2, qtot, groups;
  int ew, ed, npd, nr;       // the window: plane extents, d planes, rows
  int sx, sdy;               // row strides, words
  int x_words, stage_words;  // a buffer's x words and all its words
  int split_words;           // a split window's words (float32; else 0)
  int x_mode, dy_mode;       // copy unit in bytes: 16 or 8, 4 or 2
  FastDiv div_nw1, div_nw2, div_e0, div_t2, div_ed, div_ew, div_xu;
};

// Strip qb: one (n, h) row of x, columns w0 .. w0 + t1c, depths d0 ..
// d0 + t2c; its nq voxels are rows 0 .. nq of one contiguous run (t2 = e2,
// or t1 = 1), voxel q at (q / t2, q % t2).
struct Strip {
  int nn, h, w0, d0, t1c, t2c, nq;
};

__device__ __forceinline__ Strip strip_at(const Geom& g, int qb) {
  Strip s;
  const int rest = fdiv(qb, g.div_nw2);
  const int dc = qb - rest * g.nw2;
  const int t = fdiv(rest, g.div_nw1);
  const int wc = rest - t * g.nw1;
  s.nn = fdiv(t, g.div_e0);
  s.h = t - s.nn * g.e0;
  s.w0 = wc * g.t1;
  s.d0 = dc * g.t2;
  s.t1c = min(g.t1, g.e1 - s.w0);
  s.t2c = min(g.t2, g.e2 - s.d0);
  s.nq = s.t2c == g.t2 ? s.t1c * g.t2 : s.t2c;
  return s;
}

// Stage strip qb into `buf`: its x rows (channels ci0 .. ci0 + cin_c; rows
// nq .. the next multiple of 16 zero), then the dy window (the block's
// Cout tile), zero outside dy. Window row ((r * 2 + pw) * npd + pd) * ew *
// ed + iw * ed + id holds dy at h' = 2h - 1 + kh (kh = r in 2D, the block's
// in 3D), w' = 2 (w0 + iw) - pw, d' = 2 (d0 + id) - pd (3D); rows past the
// strip's last column or depth keep what they held and are never read.
// kVec: x by 16-byte and dy by 8- or 4-byte copies (x_mode 16, dy_mode 8
// or 4), in short loops, so the loop that calls it stays small; else any
// mode.
template <bool kVec>
__device__ __forceinline__ void stage(const Geom& g, int qb, int kh, int ci0,
                                      int co0, uint32_t* buf, int tid) {
  const Strip st = strip_at(g, qb);
  const int nq16 = (st.nq + 15) & ~15;
  const size_t row0 =
      ((static_cast<size_t>(st.nn) * g.e0 + st.h) * g.e1 + st.w0) *
          static_cast<size_t>(g.e2) + st.d0;
  // Units of a row: the widest chunk's (div_xu), of which this chunk's
  // channels fill xunits; the rest (past Cin) stay zero.
  const int x_mode = kVec ? 16 : g.x_mode;
  const int cinw = min(g.cin_c, g.cin - ci0);
  const int xunits = (cinw * g.isz + x_mode - 1) / x_mode;
  const int uall = static_cast<int>(g.div_xu.div);
  unsigned char* xs = reinterpret_cast<unsigned char*>(buf);
#pragma unroll 1
  for (int e = tid; e < nq16 * uall; e += kProducers) {
    const int q = fdiv(e, g.div_xu);
    const int u = e - q * uall;
    if (u >= xunits) continue;
    const bool ok = q < st.nq;
    const unsigned char* src =
        g.x + ((row0 + (ok ? q : 0)) * g.cin + ci0) * g.isz + u * x_mode;
    unsigned char* dst = xs + (q * g.sx) * 4 + u * x_mode;
    if (x_mode == 16) {
      cp_async16(dst, ok ? src : g.x, ok);
    } else if (x_mode == 4) {
      cp_async4(dst, ok ? src : g.x, ok);
    } else {
      *reinterpret_cast<uint16_t*>(dst) =
          ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t{0};
    }
  }
  const int dy_mode = g.dy_mode;
  const int cow = min(16, g.cout - co0);
  const int units = (cow * g.isz) / dy_mode;
  unsigned char* ds = reinterpret_cast<unsigned char*>(buf + g.x_words);
#pragma unroll 1
  for (int e = tid; e < g.nr; e += kProducers) {
    const int rest = fdiv(e, g.div_ed);
    const int id = e - rest * g.ed;
    const int plane = fdiv(rest, g.div_ew);
    const int iw = rest - plane * g.ew;
    if (iw > st.t1c || id > st.t2c) continue;
    const int pd = g.npd == 2 ? plane & 1 : 0;
    const int pw = (g.npd == 2 ? plane >> 1 : plane) & 1;
    const int r = (g.npd == 2 ? plane >> 2 : plane >> 1);
    const int h2 = 2 * st.h - 1 + (g.nd == 3 ? kh : r);
    const int w2 = 2 * (st.w0 + iw) - pw;
    const int d2 = g.nd == 3 ? 2 * (st.d0 + id) - pd : 0;
    const bool in = static_cast<unsigned>(h2) < static_cast<unsigned>(g.f0) &&
                    static_cast<unsigned>(w2) < static_cast<unsigned>(g.f1) &&
                    static_cast<unsigned>(d2) < static_cast<unsigned>(g.f2);
    const unsigned char* src =
        g.dy + ((((static_cast<size_t>(st.nn) * g.f0 + (in ? h2 : 0)) * g.f1 +
                  (in ? w2 : 0)) * g.f2 + (in ? d2 : 0)) * g.cout + co0) *
                   g.isz;
    unsigned char* dst = ds + e * g.sdy * 4;
    if (dy_mode == 8) {
#pragma unroll 1
      for (int k = 0; k < units; ++k) {
        cp_async8(dst + 8 * k, in ? src + 8 * k : g.dy, in);
      }
    } else if (kVec || dy_mode == 4) {
#pragma unroll 1
      for (int k = 0; k < units; ++k) {
        cp_async4(dst + 4 * k, in ? src + 4 * k : g.dy, in);
      }
    } else {
#pragma unroll 1
      for (int k = 0; k < units; ++k) {
        reinterpret_cast<uint16_t*>(dst)[k] =
            in ? reinterpret_cast<const uint16_t*>(src)[k] : uint16_t{0};
      }
    }
  }
}

// The window row offset of tap tap9 (2D: kh * 3 + kw; 3D: kw * 3 + kd) for
// a voxel at plane offset 0: the plane's first row, plus one column (ed
// rows) or one depth where the tap reads the odd plane shifted by 1.
__device__ __forceinline__ int tap_offset(const Geom& g, int tap9) {
  const int r = g.nd == 3 ? 0 : tap9 / 3;
  const int kw = g.nd == 3 ? tap9 / 3 : tap9 % 3;
  const int kd = g.nd == 3 ? tap9 % 3 : 1;
  const int pw = kw != 1, pd = g.npd == 2 ? kd != 1 : 0;
  const int plane = (r * 2 + pw) * g.npd + pd;
  return (plane * g.ew + (kw == 2)) * g.ed + (g.npd == 2 && kd == 2);
}

// The window offset in words of db pair j (0-7): tap 4 + j / 2 + j / 4
// (4, 5, 7 or 8), n-tile j % 2 (its Cout 8-15 are 8 values, 4 words of
// bfloat16, on).
__device__ __forceinline__ int pair_offset(const Geom& g, int j) {
  return tap_offset(g, 4 + j / 2 + j / 4) * g.sdy +
         (j & 1) * (g.isz == 2 ? 4 : 8);
}

// The window row of voxel q of a strip at plane offset 0.
__device__ __forceinline__ int voxel_row(const Geom& g, int q) {
  const int qw = fdiv(q, g.div_t2);
  return qw * g.ed + (q - qw * g.t2);
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

__device__ __forceinline__ void ldmatrix_x2_trans(const uint32_t* p,
                                                  uint32_t (&r)[2]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// d += a * b (m16n8k16, bf16 x bf16 -> f32).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b (m16n8k8, tf32 x tf32 -> f32).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = big + small + O(2^-22 |v|), both tf32 (csrc/conv_block.cu's split).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ float2 bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive, releasing this thread's shared-memory accesses before it.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait (acquiring) for the completion of the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Named barrier `id` (0 is __syncthreads') over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The staging warpgroup (thread tid of kProducers): strip q_lo + it goes
// into buffer it % kStages once every consumer has released that buffer's
// last strip (empty); when strip it - 1's copies have landed, float32 splits
// its window into tf32 (big, small) pairs in split buffer (it - 1) %
// (kStages - 1), whose last strip (it - kStages) the same wait released,
// and every producer arrives at full. The consumers never stage.
template <bool kBf16, bool kVec>
__device__ __forceinline__ void produce(const Geom& g, long long q_lo,
                                        int n_it, int kh, int ci0, int co0,
                                        uint32_t* smem, float2* split0,
                                        uint64_t* full, uint64_t* empty,
                                        int tid) {
#pragma unroll 1
  for (int it = 0; it <= n_it; ++it) {
    if (it >= kStages) {
      mbar_wait(empty + it % kStages, (it / kStages - 1) & 1);
    }
    if (it < n_it) {
      stage<kVec>(g, static_cast<int>(q_lo + it), kh, ci0, co0,
                  smem + (it % kStages) * g.stage_words, tid);
    }
    cp_async_commit();
    if (it == 0) continue;
    cp_async_wait<1>();
    const int s = (it - 1) % kStages;
    if (!kBf16) {
      bar_sync(1, kProducers);  // every producer's copies have landed
      const float* df =
          reinterpret_cast<const float*>(smem + s * g.stage_words + g.x_words);
      float2* sp = split0 + ((it - 1) % (kStages - 1)) * (g.split_words / 2);
#pragma unroll 1
      for (int e = tid; e < g.nr * 16; e += kProducers) {
        const int r = e >> 4, c = e & 15;
        uint32_t big, small;
        split_tf32(df[r * g.sdy + c], big, small);
        sp[r * (kSplitWords / 2) + c] =
            make_float2(__uint_as_float(big), __uint_as_float(small));
      }
    }
    mbar_arrive(full + s);
  }
}

// The accumulators of a warp's 16 Cin x 16 Cout tile for its 9 taps: tap t,
// n-tile j: tot[t][4 j + i] at (Cin lane / 4 (+ 8 for i >= 2), Cout 8 j +
// 2 (lane % 4) + i % 2), the mma.sync C layout. Warps 0 .. kWarps - 1
// compute, the last warpgroup stages (`produce`); setmaxnreg moves the
// stagers' registers to the products.
template <bool kBf16, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    shallow_dwt_kernel(const Geom g) {
  static_assert(kStages >= 2, "a ring of at least two strips");
  extern __shared__ __align__(16) uint32_t smem[];
  const int role = blockIdx.x % g.roles;
  const int group = blockIdx.x / g.roles;
  const int kh = role % g.nkh;
  const int cot = (role / g.nkh) % g.n_cot;
  const int cic = role / (g.nkh * g.n_cot);
  const int ci0 = cic * g.cin_c, co0 = cot * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ct = warp % g.n_ct, sl = warp / g.n_ct;
  // db: the blocks of the first Cin chunk (3D: of kh 1 and 2).
  const bool db_block = cic == 0 && (g.nd == 2 || kh >= 1);
  const long long q_lo = static_cast<long long>(group) * g.qtot / g.groups;
  const long long q_hi = static_cast<long long>(group + 1) * g.qtot / g.groups;
  const int n_it = static_cast<int>(q_hi - q_lo);
  // Shared memory: kStages buffers, (float32) kStages - 1 split windows,
  // then the full and empty barriers of the buffers.
  float2* const split0 =
      reinterpret_cast<float2*>(smem + kStages * g.stage_words);
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      smem + kStages * g.stage_words + (kStages - 1) * g.split_words);
  uint64_t* const empty = full + kStages;

  for (int i = threadIdx.x * 4; i < kStages * g.stage_words;
       i += kThreads * 4) {
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kProducers);
      mbar_init(empty + s, kConsumers);
    }
  }
  __syncthreads();
  if (warp >= kWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    produce<kBf16, kVec>(g, q_lo, n_it, kh, ci0, co0, smem, split0, full,
                         empty, threadIdx.x - kConsumers);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Each tap's window offset in words (toff) and, in float32, in pairs of
  // the split window (tsp).
  int toff[kTaps], tsp[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    toff[t] = tap_offset(g, t) * g.sdy;
    tsp[t] = tap_offset(g, t) * (kSplitWords / 2);
  }
  // db: the 4 taps whose dy rows make db (tap 4, 5, 7, 8: (kh, kw) in
  // {1, 2}^2 in 2D, (kw, kd) in {1, 2}^2 of a kh 1 or 2 block in 3D) read
  // every dy voxel once. Their 8 (tap, n-tile) pairs j go round the Cin
  // tiles' warps (j % n_ct == ct: one each where there are 8), which sum
  // them from the dy values they hold for their products, chosen by
  // selects: no branch in the k-step but the loop over the warp's pairs.
  const int npair = db_block ? kWarps / g.n_ct : 0;
  const int db_off = pair_offset(g, ct);  // the warp's first pair's

  // The tensor cores add by truncation: each strip's products go into acc
  // (a chain of at most 8 k-steps in bfloat16, 12 products in float32),
  // which is added to tot on the FP32 pipes (round to nearest).
  float acc[kTaps][8], tot[kTaps][8];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) tot[t][i] = 0.f;
  }
  // This lane's db of Cout 8 j + lane / 4 for n-tile j: db0 the first
  // pair's (n-tile ct % 2), dbs[j] the others'.
  double db0 = 0.0, dbs[2] = {0.0, 0.0};
  // Strip it: wait for its buffer (full), compute, release it (empty).
#pragma unroll 1
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    mbar_wait(full + s, (it / kStages) & 1);
    const uint32_t* xs = smem + s * g.stage_words;
    const uint32_t* ds = xs + g.x_words;
    // float32: the window split into tf32 (big, small) pairs, rows of
    // kSplitWords words.
    const float2* sp = split0 + (it % (kStages - 1)) * (g.split_words / 2);
    const int nq = strip_at(g, static_cast<int>(q_lo + it)).nq;
    const int nk = (nq + 15) >> 4;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[t][i] = 0.f;
    }
    for (int ks = sl; ks < nk; ks += g.slices) {
      const int k0 = ks * 16;
      if (kBf16) {
        // A (Cin x voxels) and B (voxels x Cout) by ldmatrix.trans: lane l
        // names row l % 8 of matrix l / 8; A's matrices are voxels 0-7 |
        // 8-15 (bit 4) by Cin 0-7 | 8-15 (bit 3), B's voxels (bit 3) by
        // Cout (bit 4). All 10 fragments are loaded before the products.
        const int ra = (lane & 7) + ((lane >> 4) << 3);
        const int rb = (lane & 7) + (((lane >> 3) & 1) << 3);
        uint32_t a[4], b[kTaps][4];
        ldmatrix_x4_trans(xs + (k0 + ra) * g.sx + ct * 8 +
                              ((lane >> 3) & 1) * 4, a);
        const uint32_t* brow =
            ds + voxel_row(g, min(k0 + rb, nq - 1)) * g.sdy + (lane >> 4) * 4;
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          ldmatrix_x4_trans(brow + toff[t], b[t]);
        }
        uint32_t dbr[2];  // the warp's first db pair, loaded with the rest
        if (npair > 0) ldmatrix_x2_trans(brow + db_off, dbr);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          mma_bf16(acc[t], a, b[t][0], b[t][1]);
          mma_bf16(acc[t] + 4, a, b[t][2], b[t][3]);
        }
        // db: n-tile j's B values of this lane, voxels k0 + 2 (lane % 4) +
        // {0, 1} and + 8 of Cout 8 j + lane / 4, by one ldmatrix.x2 of the
        // pair's tap (lanes 0-15 name the rows); voxels past the strip
        // weigh 0.
        for (int p = 0; p < npair; ++p) {
          const int j = ct + p * g.n_ct;
          if (p > 0) ldmatrix_x2_trans(brow + pair_offset(g, j), dbr);
          const float2 l = bf16x2(dbr[0]), h = bf16x2(dbr[1]);
          float sum;
          if (k0 + 16 <= nq) {
            sum = (l.x + l.y) + (h.x + h.y);
          } else {
            const int kv = k0 + 2 * (lane & 3);
            sum = ((kv < nq ? l.x : 0.f) + (kv + 1 < nq ? l.y : 0.f)) +
                  ((kv + 8 < nq ? h.x : 0.f) + (kv + 9 < nq ? h.y : 0.f));
          }
          if (p == 0) {
            db0 += static_cast<double>(sum);
          } else if (j & 1) {
            dbs[1] += static_cast<double>(sum);
          } else {
            dbs[0] += static_cast<double>(sum);
          }
        }
      } else {
        // tf32 m16n8k8, two k-halves: A[ci][k] = x row k, B[k][co] = the
        // tap's dy row of voxel k; lane (g, t) = (lane / 4, lane % 4) holds
        // A (g | g + 8, t | t + 4) and B (t | t + 4, g), B's (big, small)
        // pair by one 8-byte load from the split window.
        const int gq = lane >> 2, tq = lane & 3;
        const float* xf = reinterpret_cast<const float*>(xs);
        const float* df = reinterpret_cast<const float*>(ds);
        uint32_t ab[2][4], as[2][4];
        int vr[2][2];
        float w[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = k0 + 8 * h + tq + 4 * j;
            const float* xr = xf + k * g.sx + ct * 16 + gq;
            split_tf32(xr[0], ab[h][2 * j], as[h][2 * j]);
            split_tf32(xr[8], ab[h][2 * j + 1], as[h][2 * j + 1]);
            vr[h][j] = voxel_row(g, min(k, nq - 1));
            w[h][j] = k < nq ? 1.f : 0.f;
          }
        }
        float dv[2][2];  // the warp's first db pair, loaded with the rest
        if (npair > 0) {
          const float* d = df + db_off + gq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            dv[h][0] = d[vr[h][0] * g.sdy];
            dv[h][1] = d[vr[h][1] * g.sdy];
          }
        }
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const int ts = tsp[t];
#pragma unroll
          for (int n8 = 0; n8 < 2; ++n8) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 p0 =
                  sp[vr[h][0] * (kSplitWords / 2) + ts + 8 * n8 + gq];
              const float2 p1 =
                  sp[vr[h][1] * (kSplitWords / 2) + ts + 8 * n8 + gq];
              const uint32_t bb0 = __float_as_uint(p0.x);
              const uint32_t bs0 = __float_as_uint(p0.y);
              const uint32_t bb1 = __float_as_uint(p1.x);
              const uint32_t bs1 = __float_as_uint(p1.y);
              mma_tf32(acc[t] + 4 * n8, as[h], bb0, bb1);
              mma_tf32(acc[t] + 4 * n8, ab[h], bs0, bs1);
              mma_tf32(acc[t] + 4 * n8, ab[h], bb0, bb1);
            }
          }
        }
        // db: the warp's pairs' dy values as they are, from the window;
        // voxels past the strip weigh 0.
        for (int p = 0; p < npair; ++p) {
          const int j = ct + p * g.n_ct;
          if (p > 0) {
            const float* d = df + pair_offset(g, j) + gq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              dv[h][0] = d[vr[h][0] * g.sdy];
              dv[h][1] = d[vr[h][1] * g.sdy];
            }
          }
          const float sum = (dv[0][0] * w[0][0] + dv[0][1] * w[0][1]) +
                            (dv[1][0] * w[1][0] + dv[1][1] * w[1][1]);
          if (p == 0) {
            db0 += static_cast<double>(sum);
          } else if (j & 1) {
            dbs[1] += static_cast<double>(sum);
          } else {
            dbs[0] += static_cast<double>(sum);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
#pragma unroll
      for (int i = 0; i < 8; ++i) tot[t][i] += acc[t][i];
    }
    mbar_arrive(empty + s);
  }

  // db: the 4 lanes of a Cout column in a fixed order, then the warps in
  // order through shared memory (after every consumer is done with the
  // buffers; the stagers' copies have all landed), one partial a block.
  bar_sync(2, kConsumers);
  double* dbw = reinterpret_cast<double*>(smem);  // (kWarps, 16)
  if (ct & 1) {
    dbs[1] += db0;
  } else {
    dbs[0] += db0;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    double v = dbs[j];
    v += __shfl_xor_sync(kFull, v, 1);
    v += __shfl_xor_sync(kFull, v, 2);
    if ((lane & 3) == 0) dbw[warp * 16 + 8 * j + (lane >> 2)] = v;
  }
  bar_sync(2, kConsumers);
  if (threadIdx.x < 16) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += dbw[w * 16 + threadIdx.x];
    g.dbpart[(static_cast<size_t>(group) * g.roles + role) * 16 +
             threadIdx.x] = v;
  }
  const size_t slot =
      (static_cast<size_t>(group) * g.roles + role) * g.slices + sl;
  float* out = g.part + slot * kTaps * g.cin_c * 16;
  const int r = ct * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    float* o = out + t * g.cin_c * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<float2*>(o + r * 16 + 8 * j + c) =
          make_float2(tot[t][4 * j], tot[t][4 * j + 1]);
      *reinterpret_cast<float2*>(o + (r + 8) * 16 + 8 * j + c) =
          make_float2(tot[t][4 * j + 2], tot[t][4 * j + 3]);
    }
  }
}

// One thread an output of dW, enumerated (tap, ci, co), summing its
// partials in float64 in (group, slice) order; the last cout threads make
// db from the db blocks' partials in (group, kh) order.
template <typename Sto>
__global__ void shallow_dwt_finalize(const Geom g, Sto* dw, Sto* db) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int taps = g.nkh * kTaps;
  const int outs = taps * g.cin * g.cout;
  if (idx < outs) {
    const int co = idx % g.cout;
    const int rest = idx / g.cout;
    const int ci = rest % g.cin;
    const int tap = rest / g.cin;
    const int kh = tap / kTaps, t9 = tap % kTaps;
    const int role = ((ci / g.cin_c) * g.n_cot + co / 16) * g.nkh + kh;
    const size_t inner =
        (static_cast<size_t>(t9) * g.cin_c + ci % g.cin_c) * 16 + co % 16;
    const size_t slice_step = static_cast<size_t>(kTaps) * g.cin_c * 16;
    double s = 0.0;
    for (int y = 0; y < g.groups; ++y) {
      const float* p =
          g.part + (static_cast<size_t>(y) * g.roles + role) * g.slices *
                       slice_step + inner;
      for (int k = 0; k < g.slices; ++k) s += p[k * slice_step];
    }
    dw[(static_cast<size_t>(ci) * g.cout + co) * taps + tap] =
        from_float<Sto>(static_cast<float>(s));
  } else if (idx < outs + g.cout) {
    const int co = idx - outs;
    double s = 0.0;
    for (int y = 0; y < g.groups; ++y) {
      for (int kh = g.nd == 3 ? 1 : 0; kh < g.nkh; ++kh) {
        const int role = (co / 16) * g.nkh + kh;
        s += g.dbpart[(static_cast<size_t>(y) * g.roles + role) * 16 +
                      co % 16];
      }
    }
    db[co] = from_float<Sto>(static_cast<float>(s));
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// dW and db of the k = 3, s = 2 transposed conv (pad 1, output padding 1)
// from x (n, e0, e1[, e2], cin) and dy (n, 2 e0, 2 e1[, f2], cout), both
// channels_last of one type (float32 or bfloat16), on the device; 1 <= f2
// <= 2 e2 (the rows past f2 read zero), e2 = f2 = 1 in 2D. The geometry is
// the wrapper's plan (ops/shallow_grad.py::dwt_plan,
// its one copy): the Cin tiles of a block (n_ct, 1, 2, 4 or 8 of 16), the
// strip (t1 columns by t2 depths), the groups, the row strides sx and sdy
// and a buffer's x and total words (words of 4 bytes), the shared memory,
// and the workspaces part (float32) and dbpart (float64); this entry only
// checks that they hold what the kernel indexes. dw is torch's (cin, cout,
// 3, 3[, 3]) in x's type, db (cout,). Launches on `stream`, allocates
// nothing.
extern "C" int ctseg_shallow_dwt(const void* x, const void* dy, void* part,
                                 void* dbpart, void* dw, void* db, int n,
                                 int e0, int e1, int e2, int f2, int cin,
                                 int cout, int ndim, int n_ct, int t1, int t2,
                                 int groups, int sx, int sdy, int x_words,
                                 int stage_words, int smem,
                                 long long part_elems, long long dbpart_elems,
                                 int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool bf16 = dtype == ctseg::kBFloat16;
  if ((dtype != ctseg::kFloat32 && !bf16) || (ndim != 2 && ndim != 3) ||
      (ndim == 2 && (e2 != 1 || f2 != 1)) || n <= 0 || e0 <= 0 || e1 <= 0 ||
      e2 <= 0 || (ndim == 3 && (f2 < 1 || f2 > 2 * e2)) ||
      cin <= 0 || cout <= 0 ||
      (n_ct != 1 && n_ct != 2 && n_ct != 4 && n_ct != 8) || t1 <= 0 ||
      t1 > e1 || t2 <= 0 || t2 > e2 || (t2 < e2 && t1 != 1) || groups <= 0) {
    return cudaErrorInvalidValue;
  }
  Geom g{};
  g.x = static_cast<const unsigned char*>(x);
  g.dy = static_cast<const unsigned char*>(dy);
  g.part = static_cast<float*>(part);
  g.dbpart = static_cast<double*>(dbpart);
  g.isz = bf16 ? 2 : 4;
  g.nd = ndim;
  g.n = n;
  g.e0 = e0;
  g.e1 = e1;
  g.e2 = e2;
  g.f0 = 2 * e0;
  g.f1 = 2 * e1;
  g.f2 = f2;
  g.cin = cin;
  g.cout = cout;
  g.n_ct = n_ct;
  g.cin_c = 16 * n_ct;
  g.n_cic = static_cast<int>(ceil_div(cin, g.cin_c));
  g.n_cot = static_cast<int>(ceil_div(cout, 16));
  g.nkh = ndim == 3 ? 3 : 1;
  g.roles = g.n_cic * g.n_cot * g.nkh;
  g.slices = kWarps / n_ct;
  g.t1 = t1;
  g.t2 = t2;
  g.nw1 = static_cast<int>(ceil_div(e1, t1));
  g.nw2 = static_cast<int>(ceil_div(e2, t2));
  const long long qtot = static_cast<long long>(n) * e0 * g.nw1 * g.nw2;
  const long long blocks = static_cast<long long>(groups) * g.roles;
  if (qtot > 2147483647LL || groups > qtot || blocks > 2147483647LL ||
      static_cast<long long>(t1) * t2 > 4096) {
    return cudaErrorInvalidValue;
  }
  g.qtot = static_cast<int>(qtot);
  g.groups = groups;
  g.ew = t1 + 1;
  g.ed = ndim == 3 ? t2 + 1 : 1;
  g.npd = ndim == 3 ? 2 : 1;
  g.nr = (ndim == 3 ? 1 : 3) * 2 * g.npd * g.ew * g.ed;
  g.sx = sx;
  g.sdy = sdy;
  g.x_words = x_words;
  g.stage_words = stage_words;
  g.split_words = bf16 ? 0 : g.nr * kSplitWords;
  // Copy units: 16 bytes (x) or 8 (dy) where a row's channel chunk and
  // the base align, else 4, else (bfloat16, an odd count) 2.
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t da = reinterpret_cast<uintptr_t>(dy);
  g.x_mode = (cin * g.isz) % 16 == 0 && xa % 16 == 0 ? 16
             : (cin * g.isz) % 4 == 0 && xa % 4 == 0 ? 4 : 2;
  g.dy_mode = (cout * g.isz) % 8 == 0 && da % 8 == 0   ? 8
              : (cout * g.isz) % 4 == 0 && da % 4 == 0 ? 4 : 2;
  g.div_nw1 = make_fastdiv(g.nw1);
  g.div_nw2 = make_fastdiv(g.nw2);
  g.div_e0 = make_fastdiv(e0);
  g.div_t2 = make_fastdiv(t2);
  g.div_ed = make_fastdiv(g.ed);
  g.div_ew = make_fastdiv(g.ew);
  const int cinw0 = min(g.cin_c, cin);  // the widest chunk's channels
  g.div_xu = make_fastdiv(static_cast<int>(
      ceil_div(static_cast<long long>(cinw0) * g.isz, g.x_mode)));
  // Rows hold their 16-channel tiles at strides that ldmatrix (bfloat16:
  // an odd number of 16-byte units) or the tf32 fragments' 32-bit loads
  // (float32: 8 or 24 words past a multiple of 32) read without bank
  // conflicts; the x rows reach the strip's last k-step, the window holds
  // its rows, and the shared memory holds kStages buffers and, in float32,
  // the split window.
  const bool rows_ok =
      bf16 ? sx % 8 == 4 && sx * 2 >= g.cin_c && sdy % 8 == 4 && sdy >= 8
           : (sx % 32 == 8 || sx % 32 == 24) && sx >= g.cin_c &&
                 (sdy % 32 == 8 || sdy % 32 == 24) && sdy >= 16;
  const long long xrows = (static_cast<long long>(t1) * t2 + 15) / 16 * 16;
  const long long need_part = blocks * g.slices * kTaps * g.cin_c * 16;
  if (!rows_ok || x_words % 4 || stage_words % 4 ||
      x_words < xrows * sx ||
      stage_words < x_words + static_cast<long long>(g.nr) * sdy ||
      smem < (static_cast<long long>(kStages) * stage_words +
              static_cast<long long>(kStages - 1) * g.split_words) * 4 +
                 2 * kStages * 8 ||
      smem < kWarps * 16 * 8 || smem > kMaxShared ||
      part_elems < need_part || dbpart_elems < blocks * 16) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = g.x_mode == 16 && g.dy_mode >= 4;
  auto kernel = bf16 ? (vec ? shallow_dwt_kernel<true, true>
                            : shallow_dwt_kernel<true, false>)
                     : (vec ? shallow_dwt_kernel<false, true>
                            : shallow_dwt_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int outs = g.nkh * kTaps * cin * cout + cout;
  if (bf16) {
    shallow_dwt_finalize<__nv_bfloat16><<<(outs + 255) / 256, 256, 0, st>>>(
        g, static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db));
  } else {
    shallow_dwt_finalize<float><<<(outs + 255) / 256, 256, 0, st>>>(
        g, static_cast<float*>(dw), static_cast<float*>(db));
  }
  return cudaGetLastError();
}
