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
// over dy's voxels o, written as torch's (Cout, Cin, *k) weight. On a depth
// slab (parallel/collectives.py::DepthShard) x is the slab with p halo rows
// on each side along D and the conv runs unpadded there: the depth padding
// pd is 0, x has 2 (p - pd) rows more than dy, and tap kd of output row o
// reads x row o + kd - pd. The k = 3,
// s = 2 transposed conv that the same rule (`smallc_supported`) routes has
// its own kernel, csrc/shallow_dwt.cu.
//
// What bounds it on an H100: in float32, operations. At the bench_3d site
// (batch 128) the 10 -> 10 conv does 172 GFLOP against 2.7 GB of x and dy,
// 64 FLOP a byte: on the FP32 pipes (67 TFLOP/s) a bound of 2.57 ms. In
// bfloat16 the bytes (1.34 GB, 0.40 ms at 3.35 TB/s).
//
// What held the first version of this kernel back, from its variants
// (csrc/tools/variants_shallow_dw.py --map step0; PERF.md): each strip was
// staged by the 3 blocks of its kh (9 warps a block, one tap each), a
// thread a row, by the same warps that computed, with a ring of 2, so
// staging and products did not overlap (3.6 + 7.3 of 10.7 ms in float32)
// and two thirds of the staging was repeated (one kh block staging: -20%);
// its bfloat16 products alone took 4.9 ms (12x the bound), db 1.3 of them;
// its float32 warps spilled (140-192 bytes) and divided for every voxel, 9
// warps on 4 schedulers.
//
// Design:
//   - A unit is one run of t1 columns of w by one tile of td depths (all of
//     d where a column fits; tiles with their halo where it does not) of
//     one sample and a segment of h. A block walks h over a unit for its
//     role (below). Each step stages one dy plane (the unit at row h: one
//     contiguous run of device memory where td is all of d) and one x plane
//     (the unit widened by the role's kw and kd extents), so that every x
//     plane serves the role's kh taps of successive steps and every dy plane
//     all its taps: each byte of x and dy is staged once a role and unit.
//     The planes go into a ring of `stages` slots (hspan + 1 or more: the
//     hspan planes a step reads and the one being staged). The stagers
//     write every row of a slot's planes, planes above or below the
//     tensor, the halo outside its w and d and the dy rows past the unit
//     as zeros, since a slot may hold another unit's (a block walks
//     several where the grid is bounded, below); so the products test no
//     bounds. The channels past a tile are zeroed once, when the block
//     starts. (Skipping the halo where a block owns one unit, its zeros
//     written once, is csrc/tools/variants_shallow_dw.py's "outside rows
//     skipped"; PERF.md has its times.)
//   - Roles: a role is a group of taps, a Cin tile and a Cout tile. The taps
//     are a run of up to 32 (float32) or 27 (bfloat16) of one line of taps
//     in (kh, kw, kd) order: lines of k^3 taps (all 27 at k = 3; groups that
//     cover two kh where k^2 > 32) or of k^2 (one kh: a ring of 2), the
//     first whose ring fits. A group's planes cover the kh and kw it reads
//     and every kd (hspan x wspan x k taps at most), so shared memory is
//     bounded for any depth and any k up to 1,183: one column of 16 depths
//     over a line of one kh fits. Taps that read only padding (k above an
//     extent) multiply zeros and come out exactly 0.
//   - A bounded grid: at most kMaxGrid blocks a launch, `groups` blocks a
//     role, block g walking units g, g + groups, ...; past kMaxGrid roles
//     the roles take several launches, each with its finalize. The
//     partials are at most kMaxGrid blocks' (tg x T x S floats each).
//   - Warp-specialised, 384 threads, one block an SM: a staging warpgroup (4
//     warps) copies the planes by cp.async (4 bytes a copy, a thread a row,
//     each row into a padded shared row; bfloat16 rows with an odd channel
//     count by 2-byte loads and stores) and signals each slot's full
//     mbarrier by cp.async.mbarrier.arrive; 8 computing warps (two a
//     scheduler) release a slot's empty mbarrier when its x plane has
//     served its last step. setmaxnreg gives the stagers 40 registers and
//     the computing warps 232. (Two blocks of 4 computing warps an SM held
//     every thread to 128 registers: 7.0 ms in float32 where this takes
//     6.6 with the same loop, unrolled by 2.)
//   - float32, on the FP32 pipes (split TF32's 3 products a product on the
//     padded 16 x 16 tile bound it at 4.1 ms at mma.sync's measured rate,
//     over the FP32 pipes' 2.57): a lane owns one tap and a T x S tile of
//     (Cin, Cout) accumulators (10 x 10 at the sites; S = Cout rounded to 4,
//     8, 10 or 16, T = 16, 12, 10 or 8 with it), so the taps of a role (up
//     to 32: all 27 at k = 3, lanes 27-31 idle) are the lanes of every
//     warp, and the warps take turns over the step's voxels (the loop
//     unrolled by 8, which keeps several voxels' loads in flight: 6.6 ms at
//     2, 5.9 at 8 and at 16): per voxel a lane loads its tap's x row (T
//     values) and the voxel's dy row (S values, one broadcast for the warp)
//     and does T * S FMAs. Where a role has fewer than 16 taps (k = 1) the lanes
//     also split the voxels (`slots`). A voxel's 27 x loads fall on up to 3
//     rows of a bank (6 wavefronts a float2 load, not 2); a lane order and
//     padding that put them on distinct banks (a ring of 8) was built and
//     dropped: a 512-voxel strip without it, which its ring could not hold,
//     was as fast.
//   - bfloat16, on the tensor cores: mma.sync m16n8k16 (bf16 x bf16 -> f32,
//     products exact) over 16 voxels a k-step, A = x (Cin tile of 16 x
//     voxels), B = dy (voxels x Cout tile of 16), both from 48-byte shared
//     rows by ldmatrix.trans without bank conflicts. A warp owns up to 7
//     taps of the role (7, 7, 7, 6 at k = 3; the warps 4-7 take the odd
//     k-steps) and loads dy's fragment once a k-step for all of them.
//     Padding: Cin 10 -> 16 and Cout 10 -> 16 (2.56x the products at the
//     sites). db is one more tap, in the last warp's spare slot, whose A
//     comes from 16 shared rows of ones, so every warp runs its 7 slots
//     without a branch (a branch for it cost 1.65 of 4.7 ms). The tensor
//     cores add by truncation, so each step's products go into fresh
//     accumulators (at most 16 k-steps at the sites) added to running sums
//     on the FP32 pipes.
//   - Deterministic, no atomics: at its end a block sums its warps (and
//     slots or k-step slices) in a fixed order in float64 through shared
//     memory and writes one float32 partial per (tap, Cin, Cout) of its
//     role; the finalize launch sums the blocks' partials in a fixed order
//     in float64 and writes dW (and db) in x's type. float32 db: the
//     computing threads of the first Cin tile's blocks sum the staged dy
//     rows, float32 over kDbChain values loaded together, then float64 (a
//     float32 chain of 32 was 2.9x torch's float32 sum's error). A float32
//     dW's error falls as the square root of the lane chains summed in
//     float64 (8 warps x voxel slots x a role's blocks), hence the plan's
//     MIN_GROUPS where segments of h cost no staging.
// Registers (ptxas -v, sm_90a; csrc/tools/variants_shallow_dw.py prints
// them): every instance 168 a thread (the launch-bounds cap at 384
// threads; setmaxnreg moves the stagers' registers to the computing warps)
// and no spills.
// The geometry (strip, depth tiles, tap lines and groups, segments, ring,
// row strides, slot words, grid, shared memory) is
// ops/shallow_grad.py::dw_plan's, its one copy; the C entry checks it.
#include "common.cuh"

namespace {

using ctseg::from_float;

constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90
constexpr int kMaxGrid = 1056;      // blocks a launch: 8 for each of 132 SMs
constexpr int kWarps = 8;           // computing warps, two a scheduler
constexpr int kConsumers = kWarps * 32;
constexpr int kStagers = 128;       // the staging warpgroup
constexpr int kThreads = kConsumers + kStagers;
constexpr int kStagerRegs = 40;     // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;  // <= 65536 registers an SM
constexpr int kTapsPerWarp = 7;     // bfloat16: taps a computing warp holds
constexpr int kMaxTapsF32 = 32;     // float32: taps a role (its lanes)
constexpr int kMaxTapsBf16 = 27;    // bfloat16: leaves the last warp a slot
constexpr int kRowWordsBf16 = 12;   // 16 values at a 48-byte stride
// Values a thread sums db over in float32 before its float64 sum.
constexpr int kDbChain = 4;
constexpr uint32_t kOnesBf16 = 0x3F803F80u;  // two bfloat16 1.0s

// n / d for 0 <= n < 2^31 by one multiply-high (CUTLASS's FastDivmod).
struct FastDiv {
  unsigned int div, mul, shr;
};

__host__ __device__ FastDiv make_fastdiv(int d) {
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, or 4 zero bytes when !pred.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
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

// Arrive once this thread's cp.async copies issued so far have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
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

// ldmatrix .x4 .trans from the shared address `a` (bytes).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t a,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

struct Geom {
  const unsigned char* x;   // (n, e0, e1, xd, cin)
  const unsigned char* dy;  // (n, e0, e1, e2, cout)
  float* part;              // (blocks, tg, tt, st)
  double* dbpart;           // (blocks, st)
  int isz;                  // bytes an element
  int n, e0, e1, e2, cin, cout;
  int k, p, taps;           // taps an axis, the pad (k - 1) / 2, k^3
  int xd, pd;               // x's depth: e2 + 2 (p - pd), pd its padding
  int tl, gpl, tg;          // taps a line, groups a line, a group's taps
  int tt, st;               // a role's Cin and Cout tile
  int n_ct, n_cot, roles;   // Cin tiles, Cout tiles, roles
  int t1, td, hs;           // a unit's columns, depths, rows of h
  int nw1, ndt, nseg;       // runs of w, depth tiles, h segments
  int units, groups;        // units; blocks a role (units g, g + groups, ..)
  int role0, rpl;           // this launch's first role and its roles
  int wspan;                // the kw a role's planes cover
  int lag;                  // hspan - 1: items a unit stages before a step
  int dpx;                  // rows a column of an x plane: td + k - 1
  int sx, sdy;              // x and dy row strides, words
  int x_words, slot_words;  // a slot's x plane, and all its words
  int dy_rows;              // rows a slot's dy plane holds
  int stages, bar_words;    // the ring's slots, the barriers' offset
  int ones_words;           // bfloat16: the rows of ones, after the ring
  FastDiv div_td, div_dpx;
};

// A block's role: tap group tgi (tgr taps from tap0, its planes' first kh
// and kw at kh0, kw0: ops/shallow_grad.py::group_span), Cin tile ct and
// Cout tile cot.
struct Role {
  int role, tgi, tap0, tgr, kh0, kw0, ct, cot, ci0, co0, cinw, cow;
  bool db;
};

__device__ __forceinline__ Role role_at(const Geom& g, int role) {
  Role r;
  r.role = role;
  r.cot = role % g.n_cot;
  r.ct = (role / g.n_cot) % g.n_ct;
  r.tgi = role / (g.n_cot * g.n_ct);
  const int first = r.tgi % g.gpl * g.tg;
  r.tap0 = r.tgi / g.gpl * g.tl + first;
  r.tgr = min(g.tg, g.tl - first);
  const int k2 = g.k * g.k;
  r.kh0 = r.tap0 / k2;
  r.kw0 = r.kh0 == (r.tap0 + r.tgr - 1) / k2 ? r.tap0 / g.k % g.k : 0;
  r.ci0 = r.ct * g.tt;
  r.co0 = r.cot * g.st;
  r.cinw = min(g.tt, g.cin - r.ci0);
  r.cow = min(g.st, g.cout - r.co0);
  // db: the blocks of the first tap group and Cin tile.
  r.db = r.role < g.n_cot;
  return r;
}

// A unit: a run of t1c columns from w0 by tdc depths from d0 of sample nn,
// rows h_lo .. of h (n_items ring items: the segment's rows and the lag
// planes before them); nq = t1c x td voxels a step (those past tdc have dy
// rows of zeros).
struct Unit {
  int nn, h_lo, n_items, w0, t1c, d0, tdc, nq;
};

__device__ __forceinline__ Unit unit_at(const Geom& g, int q) {
  Unit u;
  const int dt = q % g.ndt;
  q /= g.ndt;
  const int wc = q % g.nw1;
  q /= g.nw1;
  const int seg = q % g.nseg;
  u.nn = q / g.nseg;
  u.w0 = wc * g.t1;
  u.t1c = min(g.t1, g.e1 - u.w0);
  u.d0 = dt * g.td;
  u.tdc = min(g.td, g.e2 - u.d0);
  u.nq = u.t1c * g.td;
  u.h_lo = seg * g.hs;
  u.n_items = min(g.hs, g.e0 - u.h_lo) + g.lag;
  return u;
}

// One row's `bytes` (at most kWords words) of channels from global `src`
// into shared `dst`, or zeros when !in: 4-byte cp.asyncs (kVec), else
// 2-byte loads and stores.
template <bool kVec, int kWords>
__device__ __forceinline__ void copy_row(uint32_t* dst,
                                         const unsigned char* src, int bytes,
                                         bool in, const unsigned char* any) {
  if constexpr (kVec) {
    const int words = bytes >> 2;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      if (j < words) cp_async4(dst + j, in ? src + 4 * j : any, in);
    }
  } else {
    uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    for (int j = 0; j < (bytes >> 1); ++j) d16[j] = in ? s16[j] : uint16_t{0};
  }
}

// Ring item i of the block's unit into `slot`: x plane h_lo - p + kh0 + i,
// columns w0 - p + kw0 .. of the t1c + wspan - 1 the role reads by depths
// d0 - pd .. of dpx, zeros outside the tensor; then, from item lag on, dy
// plane h_lo + i - lag: the unit's rows (t1c columns of tdc depths at a
// stride of td) and zeros to dy_rows. A row holds at most kXW (x) and kDW
// (dy) words.
template <bool kVec, int kXW, int kDW>
__device__ __forceinline__ void stage_item(const Geom& g, const Role& r,
                                           const Unit& u, int i,
                                           uint32_t* slot, int tid) {
  const int m = u.h_lo - g.p + r.kh0 + i;
  const bool in_h = static_cast<unsigned>(m) < static_cast<unsigned>(g.e0);
  const size_t plane0 =
      (static_cast<size_t>(u.nn) * g.e0 + (in_h ? m : 0)) * g.e1;
  const int wb = u.w0 - g.p + r.kw0, dbase = u.d0 - g.pd;
  const int rows = (u.t1c + g.wspan - 1) * g.dpx;
#pragma unroll 1
  for (int q = tid; q < rows; q += kStagers) {
    const int c = fdiv(q, g.div_dpx);
    const int w = wb + c, d = dbase + q - c * g.dpx;
    const bool in = in_h &&
                    static_cast<unsigned>(w) < static_cast<unsigned>(g.e1) &&
                    static_cast<unsigned>(d) < static_cast<unsigned>(g.xd);
    const size_t vox = in ? (plane0 + w) * g.xd + d : 0;
    copy_row<kVec, kXW>(slot + q * g.sx,
                        g.x + (vox * g.cin + r.ci0) * g.isz, r.cinw * g.isz,
                        in, g.x);
  }
  if (i < g.lag) return;
  const size_t v0 =
      ((static_cast<size_t>(u.nn) * g.e0 + u.h_lo + i - g.lag) * g.e1 +
       u.w0) * static_cast<size_t>(g.e2) + u.d0;
  uint32_t* dys = slot + g.x_words;
#pragma unroll 1
  for (int q = tid; q < g.dy_rows; q += kStagers) {
    // Row q: column c, depth j of the unit; one run of memory where td is
    // all of d.
    int off = q;
    bool in = q < u.nq;
    if (g.td != g.e2) {
      const int c = fdiv(q, g.div_td);
      const int j = q - c * g.td;
      in = c < u.t1c && j < u.tdc;
      off = c * g.e2 + j;
    }
    copy_row<kVec, kDW>(dys + q * g.sdy,
                        g.dy + ((v0 + off) * g.cout + r.co0) * g.isz,
                        r.cow * g.isz, in, g.dy);
  }
}

// The word offset of unit voxel v's x row (column v / td, depth v % td) in
// a plane, from the row of the role's first kw and kd 0.
__device__ __forceinline__ int x_row(const Geom& g, int v) {
  const int c = fdiv(v, g.div_td);
  return (c * g.dpx + v - c * g.td) * g.sx;
}

// N floats of a shared row (8-byte aligned) into registers, as float2s.
template <int N>
__device__ __forceinline__ void load_row(const float* row, float (&r)[N]) {
  const float2* p = reinterpret_cast<const float2*>(row);
#pragma unroll
  for (int a = 0; a < N / 2; ++a) {
    const float2 f = p[a];
    r[2 * a] = f.x;
    r[2 * a + 1] = f.y;
  }
}

// A tap's kh from the role's first plane, and its (kw, kd) row offset in a
// plane (words of a row: sx).
__device__ __forceinline__ int tap_kh(const Geom& g, const Role& r, int tap) {
  return tap / (g.k * g.k) - r.kh0;
}

__device__ __forceinline__ int tap_off(const Geom& g, const Role& r, int tap,
                                       int sx) {
  return ((tap / g.k % g.k - r.kw0) * g.dpx + tap % g.k) * sx;
}

// The computing warps' release of a unit's last lag ring items (each item
// is released once: the others after the step that reads them last).
__device__ __forceinline__ void release_tail(const Geom& g, uint64_t* empty,
                                             int it) {
  for (int q = it - g.lag; q < it; ++q) mbar_arrive(empty + q % g.stages);
}

// float32 on the FP32 pipes: lane l takes tap l % tg of the role's group
// (a duplicate, never written, past the group's last) and voxel slot l / tg;
// the warps take turns over each step's voxels, over the block's units.
// Returns each lane's T x S sums through `red` (float, (kWarps, 32 lanes,
// T * S)) and db's through `dbred` (float64, a thread each).
template <int S, int T>
__device__ __forceinline__ void consume_f32(const Geom& g, const Role& ro,
                                            const float* ring,
                                            uint64_t* full, uint64_t* empty,
                                            float* red, double* dbred) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slots = 32 / g.tg;
  const int j = min(lane / g.tg, slots - 1);
  const int tap = ro.tap0 + min(lane % g.tg, ro.tgr - 1);
  const int kh = tap_kh(g, ro, tap);
  const int toff = tap_off(g, ro, tap, g.sx);
  // db: thread (group dg, channel dc) sums rows dg, dg + 128 / S, ...
  const int dgs = kConsumers / S;
  const int dc = threadIdx.x % S, dg = threadIdx.x / S;
  double dbacc = 0.0;
  float acc[T][S];
#pragma unroll
  for (int a = 0; a < T; ++a) {
#pragma unroll
    for (int b = 0; b < S; ++b) acc[a][b] = 0.f;
  }
  int it = 0;  // ring items since the block started
#pragma unroll 1
  for (int un = blockIdx.x / g.rpl; un < g.units; un += g.groups) {
    const Unit u = unit_at(g, un);
#pragma unroll 1
    for (int i = 0; i < u.n_items; ++i, ++it) {
      const int s = it % g.stages;
      mbar_wait(full + s, (it / g.stages) & 1);
      if (i < g.lag) continue;
      const float* xs =
          ring + ((it - g.lag + kh) % g.stages) * g.slot_words + toff;
      const float* ds = ring + s * g.slot_words + g.x_words;
      const int nq = u.nq;
#pragma unroll 8
      for (int v = warp * slots + j; v < nq; v += kWarps * slots) {
        float xv[T], dv[S];
        load_row<T>(xs + x_row(g, v), xv);
        load_row<S>(ds + v * g.sdy, dv);
#pragma unroll
        for (int a = 0; a < T; ++a) {
#pragma unroll
          for (int b = 0; b < S; ++b) acc[a][b] = fmaf(xv[a], dv[b], acc[a][b]);
        }
      }
      if (ro.db && dg < dgs) {
        // kDbChain rows' loads in flight, summed in float32, then float64.
#pragma unroll 1
        for (int v = dg; v < nq; v += kDbChain * dgs) {
          float part = 0.f;
#pragma unroll
          for (int q = 0; q < kDbChain; ++q) {
            const int vq = v + q * dgs;
            part += vq < nq ? ds[vq * g.sdy + dc] : 0.f;
          }
          dbacc += static_cast<double>(part);
        }
      }
      mbar_arrive(empty + (it - g.lag) % g.stages);
    }
    release_tail(g, empty, it);
  }
  bar_sync(1, kConsumers);  // every computing warp is done with the ring
  float* mine = red + threadIdx.x * (T * S);
#pragma unroll
  for (int a = 0; a < T; ++a) {
#pragma unroll
    for (int b = 0; b < S; ++b) mine[a * S + b] = acc[a][b];
  }
  dbred[threadIdx.x] = dbacc;
}

// bfloat16 on the tensor cores: warp w takes taps wt * tpw .. of the role's
// group (wt = w % nwt) and k-steps sl, sl + slices, ... (sl = w / nwt); the
// last tap warp also takes db, as one more tap that reads the rows of ones
// (so does a slot past a warp's taps, never written). Every warp runs its
// kNt slots without a branch. Returns each warp's 16 x 16 (Cin, Cout) sums
// a slot through `red` (float, (kWarps, kTapsPerWarp + 1, 256)).
template <int kNt>
__device__ __forceinline__ void consume_bf16(const Geom& g, const Role& ro,
                                             const uint32_t* ring,
                                             uint64_t* full, uint64_t* empty,
                                             float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwt = g.tg >= 4 ? 4 : g.tg >= 2 ? 2 : 1;
  const int slices = kWarps / nwt;
  const int wt = warp % nwt, sl = warp / nwt;
  const int tpw = (g.tg + nwt - 1) / nwt;
  const int nt = max(0, min(ro.tgr - wt * tpw, tpw));
  // ldmatrix rows: A's matrices are voxels 0-7 | 8-15 (lane bit 4) by Cin
  // 0-7 | 8-15 (bit 3); B's voxels (bit 3) by Cout (bit 4).
  const int ra = (lane & 7) + ((lane >> 4) << 3);
  const int ha = ((lane >> 3) & 1) * 4;
  const int rb = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int hb = (lane >> 4) * 4;
  const int ones_lane = ra * kRowWordsBf16 + ha;
  const uint32_t base = smem_addr(ring);
  // Slot t: a tap's kh and its (kw, kd) offset, or the rows of ones.
  int tkh[kNt], toff[kNt];
  bool istap[kNt];
#pragma unroll
  for (int t = 0; t < kNt; ++t) {
    istap[t] = t < nt;
    const int tap = ro.tap0 + wt * tpw + min(t, max(nt - 1, 0));
    tkh[t] = tap_kh(g, ro, tap);
    toff[t] = tap_off(g, ro, tap, kRowWordsBf16);
  }
  float acc[kNt][8], tot[kNt][8];
#pragma unroll
  for (int t = 0; t < kNt; ++t) {
#pragma unroll
    for (int q = 0; q < 8; ++q) tot[t][q] = 0.f;
  }
  int it = 0;  // ring items since the block started
#pragma unroll 1
  for (int un = blockIdx.x / g.rpl; un < g.units; un += g.groups) {
    const Unit u = unit_at(g, un);
#pragma unroll 1
    for (int i = 0; i < u.n_items; ++i, ++it) {
      const int s = it % g.stages;
      mbar_wait(full + s, (it / g.stages) & 1);
      if (i < g.lag) continue;
      // Shared byte addresses: this lane's dy row of k-step 0, each slot's
      // x plane at its tap's offset (or this lane's row of ones).
      const uint32_t dya =
          base + 4 * (s * g.slot_words + g.x_words + rb * kRowWordsBf16 + hb);
      uint32_t xa[kNt];
#pragma unroll
      for (int t = 0; t < kNt; ++t) {
        xa[t] = base + 4 * (istap[t] ? ((it - g.lag + tkh[t]) % g.stages) *
                                               g.slot_words + toff[t] + ha
                                     : g.ones_words + ones_lane);
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[t][q] = 0.f;
      }
      const int nk = (u.nq + 15) >> 4;
#pragma unroll 1
      for (int ks = sl; ks < nk; ks += slices) {
        const int k0 = ks * 16;
        const uint32_t rowa = 4 * x_row(g, min(k0 + ra, u.nq - 1));
        uint32_t b[4];
        ldmatrix_x4_trans(dya + 4 * k0 * kRowWordsBf16, b);
#pragma unroll
        for (int t = 0; t < kNt; ++t) {
          uint32_t a[4];
          ldmatrix_x4_trans(xa[t] + (istap[t] ? rowa : 0u), a);
          mma_bf16(acc[t], a, b[0], b[1]);
          mma_bf16(acc[t] + 4, a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < kNt; ++t) {
#pragma unroll
        for (int q = 0; q < 8; ++q) tot[t][q] += acc[t][q];
      }
      mbar_arrive(empty + (it - g.lag) % g.stages);
    }
    release_tail(g, empty, it);
  }
  bar_sync(1, kConsumers);  // every computing warp is done with the ring
  // The accumulators' layout: rows (Cin) lane / 4 and + 8, columns (Cout)
  // 2 (lane % 4) + {0, 1}, and + 8 for the second product.
  const int r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < kNt; ++t) {
    float* o = red + (warp * (kTapsPerWarp + 1) + t) * 256;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[r * 16 + c + 8 * h] = tot[t][4 * h];
      o[r * 16 + c + 8 * h + 1] = tot[t][4 * h + 1];
      o[(r + 8) * 16 + c + 8 * h] = tot[t][4 * h + 2];
      o[(r + 8) * 16 + c + 8 * h + 1] = tot[t][4 * h + 3];
    }
  }
}

// A block: the staging warpgroup (warps 8-11) fills the ring, the computing
// warps (0-7) take each step's products, over the block's units; then the
// computing threads sum the warps' results in float64 in a fixed order into
// the block's partials.
template <int S, int T, bool kBf16, bool kVec, int kNt>
__global__ void __launch_bounds__(kThreads, 1)
    shallow_dw_kernel(const Geom g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Role ro = role_at(g, g.role0 + static_cast<int>(blockIdx.x % g.rpl));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + g.bar_words);
  uint64_t* const empty = full + g.stages;
  // Zeros everywhere (the channels past a tile stay so), bfloat16's rows
  // of ones after the ring.
  for (int e = threadIdx.x * 4; e < g.bar_words; e += kThreads * 4) {
    const uint32_t v =
        g.ones_words >= 0 && e >= g.ones_words &&
                e < g.ones_words + 16 * kRowWordsBf16
            ? kOnesBf16
            : 0u;
    *reinterpret_cast<uint4*>(smem + e) = make_uint4(v, v, v, v);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + s, kStagers);
      mbar_init(empty + s, kConsumers);
    }
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kStagerRegs));
    const int tid = threadIdx.x - kConsumers;
    int it = 0;
#pragma unroll 1
    for (int un = blockIdx.x / g.rpl; un < g.units; un += g.groups) {
      const Unit u = unit_at(g, un);
#pragma unroll 1
      for (int i = 0; i < u.n_items; ++i, ++it) {
        const int s = it % g.stages;
        if (it >= g.stages) {
          mbar_wait(empty + s, ((it / g.stages) - 1) & 1);
        }
        // A row's words: bfloat16 16 values, float32 the tiles' T and S.
        stage_item<kVec, kBf16 ? 8 : T, kBf16 ? 8 : S>(
            g, ro, u, i, smem + s * g.slot_words, tid);
        if constexpr (kVec) {
          mbar_arrive_copies(full + s);
        } else {
          mbar_arrive(full + s);
        }
      }
    }
    ctseg::cp_async_wait<0>();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const size_t blk = blockIdx.x;
  float* red = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  if constexpr (kBf16) {
    consume_bf16<kNt>(g, ro, smem, full, empty, red);
    bar_sync(1, kConsumers);
    // Each tap's sum over the k-step slices; db from the ones tap's row 0.
    const int nwt = g.tg >= 4 ? 4 : g.tg >= 2 ? 2 : 1;
    const int tpw = (g.tg + nwt - 1) / nwt;
    for (int e = tid; e < ro.tgr * 256; e += kConsumers) {
      const int t = e >> 8, rest = e & 255;
      double sum = 0.0;
      for (int w = t / tpw; w < kWarps; w += nwt) {
        sum += red[(w * (kTapsPerWarp + 1) + t % tpw) * 256 + rest];
      }
      g.part[(blk * g.tg + t) * 256 + rest] = static_cast<float>(sum);
    }
    if (ro.db && tid < 16) {
      const int slot = max(0, min(ro.tgr - (nwt - 1) * tpw, tpw));
      double sum = 0.0;
      for (int w = nwt - 1; w < kWarps; w += nwt) {
        sum += red[(w * (kTapsPerWarp + 1) + slot) * 256 + tid];
      }
      g.dbpart[blk * 16 + tid] = sum;
    }
  } else {
    double* dbred = reinterpret_cast<double*>(red + kConsumers * T * S);
    consume_f32<S, T>(g, ro, reinterpret_cast<const float*>(smem), full,
                      empty, red, dbred);
    bar_sync(1, kConsumers);
    // Each (tap, Cin, Cout) over the warps and voxel slots; db over the
    // thread groups.
    const int slots = 32 / g.tg;
    for (int e = tid; e < ro.tgr * T * S; e += kConsumers) {
      const int t = e / (T * S), rest = e - t * (T * S);
      double sum = 0.0;
      for (int w = 0; w < kWarps; ++w) {
        for (int j = 0; j < slots; ++j) {
          sum += red[(w * 32 + j * g.tg + t) * (T * S) + rest];
        }
      }
      g.part[(blk * g.tg + t) * (T * S) + rest] = static_cast<float>(sum);
    }
    if (ro.db && tid < S) {
      double sum = 0.0;
      for (int dg = 0; dg < kConsumers / S; ++dg) sum += dbred[dg * S + tid];
      g.dbpart[blk * S + tid] = sum;
    }
  }
}

// One thread a partial entry (role of the launch, tap of its group, Cin,
// Cout of its tiles), summing the role's `groups` blocks' partials in
// float64 in block order into dW; then one thread a (db role, Cout of its
// tile) likewise into db. Entries past the group's taps or the channels
// write nothing.
template <typename Sto>
__global__ void shallow_dw_finalize(const Geom g, Sto* dw, Sto* db) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int per_block = g.tg * g.tt * g.st;
  const int outs = g.rpl * per_block;
  if (idx < outs) {
    const int rl = idx / per_block, inner = idx - rl * per_block;
    const int t = inner / (g.tt * g.st);
    const int a = inner / g.st % g.tt, b = inner % g.st;
    const Role ro = role_at(g, g.role0 + rl);
    const int ci = ro.ci0 + a, co = ro.co0 + b;
    if (t >= ro.tgr || ci >= g.cin || co >= g.cout) return;
    double s = 0.0;
    for (int grp = 0; grp < g.groups; ++grp) {
      s += g.part[(static_cast<size_t>(grp) * g.rpl + rl) * per_block +
                  inner];
    }
    dw[(static_cast<size_t>(co) * g.cin + ci) * g.taps + ro.tap0 + t] =
        from_float<Sto>(static_cast<float>(s));
  } else if (idx < outs + g.rpl * g.st) {
    const int e = idx - outs;
    const int rl = e / g.st, b = e % g.st;
    const int role = g.role0 + rl, co = role * g.st + b;
    if (role >= g.n_cot || co >= g.cout) return;  // db's roles: role < n_cot
    double s = 0.0;
    for (int grp = 0; grp < g.groups; ++grp) {
      s += g.dbpart[(static_cast<size_t>(grp) * g.rpl + rl) * g.st + b];
    }
    db[co] = from_float<Sto>(static_cast<float>(s));
  }
}

template <typename K>
cudaError_t launch(K kernel, const Geom& g, long long blocks, size_t smem,
                   cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(g);
  return cudaGetLastError();
}

// The kernel for the type, the Cout tile, the copy unit and (bfloat16) the
// slots a warp runs: 2 where a warp holds one tap (and db), else
// kTapsPerWarp.
cudaError_t launch_main(const Geom& g, bool bf16, bool vec, int slots,
                        long long blocks, size_t smem, cudaStream_t st) {
  if (bf16) {
    constexpr int kT = kTapsPerWarp;
    if (slots <= 2) {
      return vec ? launch(shallow_dw_kernel<16, 16, true, true, 2>, g,
                          blocks, smem, st)
                 : launch(shallow_dw_kernel<16, 16, true, false, 2>, g,
                          blocks, smem, st);
    }
    return vec ? launch(shallow_dw_kernel<16, 16, true, true, kT>, g, blocks,
                        smem, st)
               : launch(shallow_dw_kernel<16, 16, true, false, kT>, g,
                        blocks, smem, st);
  }
  switch (g.st) {
    case 4: return launch(shallow_dw_kernel<4, 16, false, true, 0>, g, blocks, smem, st);
    case 8: return launch(shallow_dw_kernel<8, 12, false, true, 0>, g, blocks, smem, st);
    case 10: return launch(shallow_dw_kernel<10, 10, false, true, 0>, g, blocks, smem, st);
    case 16: return launch(shallow_dw_kernel<16, 8, false, true, 0>, g, blocks, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// dW and db of the stride-1 3D conv with an odd kernel k and pad (k - 1) /
// 2 along H and W and pd (0 to it) along D from x (n, e0, e1, xd, cin) and
// dy (n, e0, e1, e2, cout), xd = e2 + 2 ((k - 1) / 2 - pd) (pd 0: a depth
// slab with its halo rows), both contiguous of one type (float32 or
// bfloat16), on the device. The geometry is the wrapper's plan
// (ops/shallow_grad.py::dw_plan, its one copy): the taps a line tl (k^3 or
// k^2) and a role's tg, the Cout and Cin tiles (s_tile, t_tile; float32 (4,
// 16), (8, 12), (10, 10) or (16, 8), bfloat16 (16, 16)), units of t1
// columns by td depths by hs rows of h, the kh and kw a role's planes
// cover (hspan, wspan; every kd), the ring's slots, the row strides sx and sdy and a slot's
// x plane and total words (words of 4 bytes), the blocks a role `groups`
// and the roles a launch rpl, the shared memory, and the workspaces part
// (float32, groups x rpl x tg x t_tile x s_tile) and dbpart (float64, groups
// x rpl x s_tile), which each launch reuses; this entry only checks that
// they hold what the kernels index. dw is torch's (cout, cin, k, k, k) in
// x's type, db (cout,). Launches on `stream` (the main kernel and its
// finalize for each launch's roles), allocates nothing.
extern "C" int ctseg_shallow_dw(const void* x, const void* dy, void* part,
                                void* dbpart, void* dw, void* db, int n,
                                int e0, int e1, int e2, int xd, int cin,
                                int cout, int k, int pd, int tl, int tg,
                                int s_tile, int t_tile,
                                int t1, int td, int hs, int hspan, int wspan,
                                int stages, int sx, int sdy,
                                int x_words, int slot_words, int groups,
                                int rpl, int smem, long long part_elems,
                                long long dbpart_elems, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool bf16 = dtype == ctseg::kBFloat16;
  const bool tiles_ok =
      bf16 ? s_tile == 16 && t_tile == 16
           : (s_tile == 4 && t_tile == 16) || (s_tile == 8 && t_tile == 12) ||
                 (s_tile == 10 && t_tile == 10) || (s_tile == 16 && t_tile == 8);
  // k <= 1290 keeps k^3, the taps, inside an int (1290^3 < 2^31).
  if ((dtype != ctseg::kFloat32 && !bf16) || k < 1 || k % 2 == 0 ||
      k > 1290 || pd < 0 || pd > (k - 1) / 2 ||
      xd != e2 + 2 * ((k - 1) / 2 - pd) || n <= 0 || e0 <= 0 || e1 <= 0 ||
      e2 <= 0 || cin <= 0 ||
      cout <= 0 || !tiles_ok || !(tl == k * k || tl == k * k * k) ||
      tg < 1 || tg > (bf16 ? kMaxTapsBf16 : kMaxTapsF32) || tg > tl ||
      t1 < 1 || t1 > e1 || td < 1 || td > e2 || hs < 1 || hs > e0 ||
      hspan < 1 || hspan > k || wspan < 1 || wspan > k) {
    return cudaErrorInvalidValue;
  }
  Geom g{};
  g.x = static_cast<const unsigned char*>(x);
  g.dy = static_cast<const unsigned char*>(dy);
  g.part = static_cast<float*>(part);
  g.dbpart = static_cast<double*>(dbpart);
  g.isz = bf16 ? 2 : 4;
  g.n = n;
  g.e0 = e0;
  g.e1 = e1;
  g.e2 = e2;
  g.cin = cin;
  g.cout = cout;
  g.k = k;
  g.p = (k - 1) / 2;
  g.xd = xd;
  g.pd = pd;
  g.taps = k * k * k;
  g.tl = tl;
  g.tg = tg;
  g.gpl = static_cast<int>(ceil_div(tl, tg));
  g.tt = t_tile;
  g.st = s_tile;
  g.n_ct = static_cast<int>(ceil_div(cin, t_tile));
  g.n_cot = static_cast<int>(ceil_div(cout, s_tile));
  const long long roles =
      static_cast<long long>(g.taps / tl) * g.gpl * g.n_ct * g.n_cot;
  g.t1 = t1;
  g.td = td;
  g.hs = hs;
  g.nw1 = static_cast<int>(ceil_div(e1, t1));
  g.ndt = static_cast<int>(ceil_div(e2, td));
  g.nseg = static_cast<int>(ceil_div(e0, hs));
  const long long units = static_cast<long long>(n) * g.nseg * g.nw1 * g.ndt;
  g.wspan = wspan;
  g.lag = hspan - 1;
  g.dpx = td + k - 1;
  g.sx = sx;
  g.sdy = sdy;
  g.x_words = x_words;
  g.slot_words = slot_words;
  g.stages = stages;
  g.div_td = make_fastdiv(td);
  g.div_dpx = make_fastdiv(g.dpx);
  // Every group of a line covers no more kh and kw than the planes hold
  // (ops/shallow_grad.py::group_span; every line alike).
  bool spans_ok = roles <= 2147483647LL;
  for (int first = 0; spans_ok && first < tl; first += tg) {
    const int last = (first + tg < tl ? first + tg : tl) - 1, k2 = k * k;
    const int h0 = first / k2, h1 = last / k2;
    const int ww = h0 != h1 ? k : last / k % k - first / k % k + 1;
    spans_ok = h1 - h0 + 1 <= hspan && ww <= wspan;
  }
  g.roles = static_cast<int>(roles);
  // Rows hold their tile (float32 rows read as float2 by 16 lanes at once:
  // a stride of 2 words past a multiple of 4; bfloat16 rows of 16 values
  // read by ldmatrix: 12 words); a slot holds its x plane (t1 + wspan - 1
  // columns of td + k - 1 rows) and its dy plane (t1 x td rows;
  // bfloat16: to the next 16 voxels, which the last k-step reads); the ring
  // has the hspan planes a step reads and one more; the computing warps'
  // sums fit the ring's words; the barriers follow both; at most kMaxGrid
  // blocks a launch, no more than the units a role and the roles; the
  // partials of one launch's blocks.
  g.dy_rows = static_cast<int>(
      bf16 ? ceil_div(static_cast<long long>(t1) * td, 16) * 16
           : static_cast<long long>(t1) * td);
  const bool rows_ok =
      bf16 ? sx == kRowWordsBf16 && sdy == kRowWordsBf16
           : sx >= t_tile && sx % 4 == 2 && sdy >= s_tile && sdy % 4 == 2;
  const long long ring_words =
      static_cast<long long>(stages) * slot_words +
      (bf16 ? 16 * kRowWordsBf16 : 0);
  g.ones_words = bf16 ? stages * slot_words : -1;
  const long long red_words =
      bf16 ? static_cast<long long>(kWarps) * (kTapsPerWarp + 1) * 256
           : kConsumers * static_cast<long long>(t_tile) * s_tile +
                 2LL * kConsumers;
  const long long blocks = static_cast<long long>(groups) * rpl;
  if (!spans_ok || !rows_ok || x_words % 4 || slot_words % 4 ||
      x_words < static_cast<long long>(t1 + wspan - 1) * g.dpx * sx ||
      slot_words < x_words + static_cast<long long>(g.dy_rows) * sdy ||
      stages < hspan + 1 ||
      smem < ((ring_words > red_words ? ring_words : red_words) + 3) / 4 * 4 *
                     4 + 16LL * stages ||
      smem > kMaxShared || groups < 1 || groups > units || rpl < 1 ||
      rpl > roles || blocks > kMaxGrid ||
      part_elems < blocks * tg * t_tile * s_tile ||
      dbpart_elems < blocks * s_tile) {
    return cudaErrorInvalidValue;
  }
  g.bar_words = static_cast<int>(
      ((ring_words > red_words ? ring_words : red_words) + 3) / 4 * 4);
  g.units = static_cast<int>(units);
  g.groups = groups;
  // Copy unit: 4 bytes where every row's channel tile and both bases align,
  // else (bfloat16 with an odd count) 2.
  const bool vec = (static_cast<long long>(cin) * g.isz) % 4 == 0 &&
                   (static_cast<long long>(cout) * g.isz) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 4 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // bfloat16: the slots of the busiest warp (its taps, and db's).
  const int nwt = tg >= 4 ? 4 : tg >= 2 ? 2 : 1;
  const int tpw = (tg + nwt - 1) / nwt;
  const int slots = tpw > tg - (nwt - 1) * tpw ? tpw : tg - (nwt - 1) * tpw + 1;
  for (int role0 = 0; role0 < g.roles; role0 += rpl) {
    g.role0 = role0;
    g.rpl = rpl < g.roles - role0 ? rpl : g.roles - role0;
    err = launch_main(g, bf16, vec, slots,
                      static_cast<long long>(groups) * g.rpl, smem, st);
    if (err != cudaSuccess) return err;
    const int entries = g.rpl * (tg * t_tile * s_tile + s_tile);
    if (bf16) {
      shallow_dw_finalize<__nv_bfloat16><<<(entries + 255) / 256, 256, 0,
                                           st>>>(
          g, static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db));
    } else {
      shallow_dw_finalize<float><<<(entries + 255) / 256, 256, 0, st>>>(
          g, static_cast<float*>(dw), static_cast<float*>(db));
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
