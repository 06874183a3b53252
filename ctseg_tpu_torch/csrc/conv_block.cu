// K2: PReLU(InstanceNorm(conv3x3_same(x, w) + b)), NHWC, the forward.
//
// Replaces: ctseg_tpu/ops/pallas/conv_block.py::fused_conv3x3_in_prelu,
// forward (_run_forward / _fwd_kernel), and with it the float32 prototype
// ctseg_tpu/ops/pallas/conv_fused.py::conv3x3_in_prelu (same function). Its
// backward from the saved residuals, conv_block.py::in_prelu_bwd
// (_bwd_kernel, K2b), is K1b's kernels in csrc/instance_norm.cu reading
// xhat and rsinv (ctseg_in_prelu_bwd_saved*). Same arithmetic: products of the stored values accumulated in
// float32, + bias, then TWO-pass statistics per (sample, channel): mean,
// then the centred variance mean((y - mean)^2), rsqrt(var + eps), PReLU.
// The training forward (train=True) also writes xhat in x's type and rsinv
// = rsqrt(var + eps) as (N, Cout) float32, so the backward never re-runs the
// convolution:
//   gh = g * (xhat >= 0 ? 1 : alpha)
//   dy = rsinv * (gh - mean(gh) - xhat * mean(gh * xhat))
//   dalpha = sum(g * min(xhat, 0)), as per-(sample, channel-tile) partials.
// The conv's own gradients (dx, dw, db from dy) are cuDNN's, as the JAX rule
// leaves them to XLA.
//
// What bounds it on an H100: at the UNet's widths the conv is compute-bound
// (2*9*Cin flops per output against 4 bytes written; 4.8 GFLOP per slice at
// the 16x16, 1024->1024 bottom site); the norm and the backward are
// memory-bound. On the FP32 pipes (67 TFLOP/s) the first version of this
// file reached 23-32 TFLOP/s with synchronous scalar loads, and its norm
// kernel made five passes over the conv output where two are needed.
//
// The forward's design (Cin and Cout multiples of 8, 16-byte aligned
// tensors; the wrapper sends other shapes to the FP32-pipe kernels below,
// which are kept for them and counted apart):
//   - The conv is an implicit GEMM per sample (M = H*W pixels, N = Cout,
//     K = 9*Cin taken tap by tap in steps of 128 bytes of input channels) on
//     the tensor cores by `wgmma`, one kernel for both storage types: 256
//     threads, two warpgroups of 64 pixels x 128 channels each (x 64 where
//     Cout is no multiple of 128), the float32 accumulators in registers. A
//     tile never straddles two samples: the grid is (pixel tiles, channel
//     tiles, N).
//   - wgmma wants its shared-memory operand as K-major core matrices (tf32
//     takes no other), and `w` is Cout-fastest. So prepare_weights_kernel
//     re-lays the weights once a call in the very order the conv stages
//     them, a step's tile one contiguous run (fetching 128-byte pieces 4 KB
//     apart instead ran at less than half the rate). The activations take
//     the A operand's register form: rows of 128 bytes in shared memory, read
//     by ldmatrix, where each lane gives its own row address.
//   - bfloat16 storage: m64nNk16 bf16 x bf16 -> f32 (products of bf16 values
//     are exact in float32: the arithmetic of the upcast). The staging's
//     L2-to-SM traffic bounds it, not the instruction: `mma.sync` m16n8k16 on
//     the same tiles ran as fast (2.54 against 2.53 ms over Model L's sites
//     at batch 32). Wider tiles, or one halo tile for all 9 taps, are
//     the open step (PERF.md).
//   - float32 storage, m64nNk8 tf32 by the split-TF32 scheme: each operand
//     a = a_big + a_small with a_big = tf32(a) (cvt.rna) and a_small =
//     tf32(a - a_big); a*b is taken as a_small*b_big + a_big*b_small +
//     a_big*b_big, small terms first. The dropped a_small*b_small is about
//     2^-22 of the product: float32's own rounding. Single TF32 is not used.
//     wgmma would read an unrounded float32 by truncation, so both parts are
//     made before it reads them: the weights' by prepare_weights_kernel (a
//     big and a small plane), the activations' in registers after ldmatrix,
//     where one split serves all N channels of the instruction. `mma.sync`
//     (m16n8k8) was tried first: it tops out at 325 TFLOP/s on this card
//     (tools/mma_rate.cu), a third of which is the scheme's ceiling, and each
//     fragment value was split again by every warp that used it.
//   - The tensor cores add into their accumulator by truncation. Over the
//     3 * 9 * Cin / 8 additions of one float32 output the bias reached 2e-4
//     of the normalized value at Cin = 1024 (measured), beyond the float32
//     tolerance. So a step's 12 products go into a fresh accumulator, which
//     is added to the running one on the FP32 pipes (round to nearest): the
//     chain that truncates is 12 long whatever Cin is, and the result is
//     closer to a float64 conv than cuDNN's FP32 one.
//   - Staging: a ring of 4 stages (bfloat16: 3 or 4, two blocks an SM) of the
//     A and B tiles in dynamic shared memory, filled by 16-byte `cp.async`
//     with zero-fill for the padded border and the ragged edges; one
//     `__syncthreads()` a step. The kernel queues a step's products, then
//     issues the copies ahead, and waits for the products only after it has
//     prepared the next step's fragments.
//   - The statistics start in the conv's epilogue: from its accumulators
//     (+ bias) each block writes, for each of its channels, the tile's mean
//     and centred sum of squares M2 (two passes over registers, shuffles and
//     a fixed-order sum across the warps: no atomics) into a (N, tiles,
//     Cout, 2) workspace; the tile's count follows from its index. A small
//     kernel combines the tiles in index order (Chan's parallel form, the
//     two-pass variance up to float32 round-off) into mean and rsinv per
//     (sample, channel); the apply kernel then reads the float32 scratch
//     ONCE, 32 bytes a lane, normalizes, applies PReLU and writes out (and
//     xhat when training). Passes over the output: conv write, one read, one
//     write (two when training), where there were five.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 3; the 9
// launches of one Model L forward at batch 32): float32 7.768 ms (16.975 ms
// before the redesign; bound 3.062 ms, three TF32 products a product at 495
// TFLOP/s; cuDNN's FP32 conv alone, without the norm, 20.156 ms), bfloat16
// 2.526 ms (bound 0.525 ms at 989 TFLOP/s; cuDNN's conv alone 1.314 ms).
// Per site and per path: PERF.md, section 6.
#include <cstdint>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// FP32-pipe route: any Cin, Cout. Kept for the shapes the tensor-core kernel
// does not take.
// ---------------------------------------------------------------------------

constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // input channels per step
constexpr int kTM = 8;    // pixels per thread
constexpr int kTN = 4;    // output channels per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;   // As row padding, keeps float4 rows aligned
constexpr int kAPerThread = kBM * kBK / kThreads;    // 8
constexpr int kBPerThread = kBK * kBN / kThreads;    // 4
static_assert(kThreads % kBK == 0 && kThreads % kBN == 0, "loader layout");

// out[m, co] = b[co] + sum_{tap, ci} x[pixel m shifted by tap, ci] * w[tap, ci, co]
// x: (n, h, wd, cin); w: (3, 3, cin, cout); out: (n*h*wd, cout) float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_bias_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int n, int h, int wd,
                        int cin, int cout) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int hw = h * wd;
  const int total = n * hw;
  const int m0 = blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;

  // Input loader: this thread stages input channel (tid % kBK) of pixels
  // tid / kBK + j * (kThreads / kBK); 16 lanes read 16 neighbouring channels.
  const int a_ci = tid % kBK;
  int a_img[kAPerThread];  // first pixel of the sample, in pixels
  int a_y[kAPerThread];
  int a_x[kAPerThread];
#pragma unroll
  for (int j = 0; j < kAPerThread; ++j) {
    const int m = m0 + tid / kBK + j * (kThreads / kBK);
    if (m < total) {
      const int img = m / hw;
      const int rem = m - img * hw;
      a_img[j] = img * hw;
      a_y[j] = rem / wd;
      a_x[j] = rem - (rem / wd) * wd;
    } else {
      a_img[j] = 0;
      a_y[j] = -4;  // every tap lands outside the image: loads zero
      a_x[j] = -4;
    }
  }
  // Weight loader: output channel (tid % kBN) of input channels
  // tid / kBN + j * (kThreads / kBN); a warp reads 32 neighbouring channels.
  const int b_co = tid % kBN;

  // Compute layout: pixels tm*kTM.. and output channels tn*kTN...
  const int tn = tid % (kBN / kTN);
  const int tm = tid / (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < cin; c0 += kBK) {
      const int ci = c0 + a_ci;
#pragma unroll
      for (int j = 0; j < kAPerThread; ++j) {
        const int yy = a_y[j] + dy;
        const int xx = a_x[j] + dx;
        float v = 0.f;
        if (ci < cin && yy >= 0 && yy < h && xx >= 0 && xx < wd) {
          v = ctseg::to_float(
              x[static_cast<size_t>(a_img[j] + yy * wd + xx) * cin + ci]);
        }
        As[a_ci][tid / kBK + j * (kThreads / kBK)] = v;
      }
#pragma unroll
      for (int j = 0; j < kBPerThread; ++j) {
        const int k = tid / kBN + j * (kThreads / kBN);
        const int co = co0 + b_co;
        float v = 0.f;
        if (c0 + k < cin && co < cout) {
          v = ctseg::to_float(
              w[(static_cast<size_t>(tap) * cin + c0 + k) * cout + co]);
        }
        Bs[k][b_co] = v;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][tm * kTM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[k][tm * kTM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tn * kTN]);
        const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[kTN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + tm * kTM + i;
    if (m >= total) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int co = co0 + tn * kTN + j;
      if (co < cout) {
        out[static_cast<size_t>(m) * cout + co] = acc[i][j] + bias[co];
      }
    }
  }
}

constexpr int kTileC = 32;  // channels per block: one per lane
constexpr int kRows = 16;   // warps per block, striding over pixels

// Two-pass InstanceNorm + PReLU of the float32 conv output, per (sample,
// 32-channel tile): mean, centred variance, then normalize and store in T.
// With xhat_out and rsinv_out (training), also stores xhat in T and rsinv.
// The FP32-pipe route's norm: three reads of the scratch.
template <typename T>
__global__ void __launch_bounds__(kTileC * kRows)
    in_prelu_two_pass_kernel(const float* __restrict__ y, T* __restrict__ out,
                             const float* __restrict__ alpha,
                             T* __restrict__ xhat_out,
                             float* __restrict__ rsinv_out, int s, int c) {
  __shared__ float buf[kRows][32];
  const int ch = blockIdx.x * kTileC + threadIdx.x;
  const bool active = ch < c;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * c + ch;

  float sum = 0.f;
  if (active) {
    for (int p = threadIdx.y; p < s; p += kRows) {
      sum += y[base + static_cast<size_t>(p) * c];
    }
  }
  const float mean = ctseg::column_sum<kRows>(sum, buf) / static_cast<float>(s);

  float sq = 0.f;
  if (active) {
    for (int p = threadIdx.y; p < s; p += kRows) {
      const float d = y[base + static_cast<size_t>(p) * c] - mean;
      sq += d * d;
    }
  }
  const float var = ctseg::column_sum<kRows>(sq, buf) / static_cast<float>(s);
  if (!active) return;

  const float rsinv = rsqrtf(var + ctseg::kEps);
  const float a = alpha[0];
  if (xhat_out != nullptr) {
    if (threadIdx.y == 0) {
      rsinv_out[static_cast<size_t>(blockIdx.y) * c + ch] = rsinv;
    }
    for (int p = threadIdx.y; p < s; p += kRows) {
      const size_t i = base + static_cast<size_t>(p) * c;
      const float xhat = (y[i] - mean) * rsinv;
      out[i] = ctseg::from_float<T>(ctseg::prelu(xhat, a));
      xhat_out[i] = ctseg::from_float<T>(xhat);
    }
    return;
  }
  for (int p = threadIdx.y; p < s; p += kRows) {
    const size_t i = base + static_cast<size_t>(p) * c;
    out[i] = ctseg::from_float<T>(ctseg::prelu((y[i] - mean) * rsinv, a));
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route: Cin % 8 == 0, Cout % 8 == 0, 16-byte aligned tensors.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcBM = 128;       // output pixels per block (one sample's)
constexpr int kTcThreads = 256;  // two warpgroups of 64 pixels each
constexpr int kStepBytes = 128;  // of input channels per pipeline step
constexpr int kKSteps = 4;       // instructions per step: 32 bytes of k each

// Shared-memory geometry of the conv for storage type T and a channel tile
// of BN. A pipeline step takes 128 bytes of input channels (32 float32, 64
// bfloat16), so both types share one geometry in bytes.
template <typename T, int BN>
struct WgSmem {
  // float32: one block an SM (242 registers a thread) and a ring of 4
  // stages; bfloat16: two blocks an SM, with 3 stages each at BN = 128 and
  // 4 at BN = 64, what shared memory holds. (Measured, bfloat16, H100 at
  // 700 W, summed over Model L's sites at batch 32: 2.53 ms so, 2.79 with 4
  // stages and one block, 2.99 with 5 or 6: the staging's traffic bounds
  // it, not its latency.)
  static constexpr int kStages = sizeof(T) == 4 || BN == 64 ? 4 : 3;
  static constexpr int kBlocksPerSM = sizeof(T) == 4 ? 1 : 2;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kBK = kStepBytes / static_cast<int>(sizeof(T));
  // float32 stages the weights' big and small tf32 planes.
  static constexpr int kPlanes = sizeof(T) == 4 ? 2 : 1;
  // A: rows of kBK channels, padded by 16 bytes so that the 8 rows of an
  // ldmatrix fall into distinct bank groups.
  static constexpr int kAStride = kBK + kVec;       // elements
  static constexpr int kAStage = kTcBM * kAStride;  // elements
  // One plane of B: BN x kBK elements as core matrices of 8 channels x 16
  // bytes, ordered [channel / 8][k / kVec][channel % 8][k % kVec].
  static constexpr int kBPlane = BN * kBK;
  static constexpr int kBStage = kPlanes * kBPlane;
  static constexpr int kBytes =
      kStages * (kAStage + kBStage) * static_cast<int>(sizeof(T));
};
constexpr int kCoreBytes = 128;  // 8 rows x 16 bytes
constexpr int kCoreRowBytes = kStepBytes / 16 * kCoreBytes;  // 8 channels' step

// v = big + small + O(2^-22 |v|), both representable in tf32 (cvt.rna:
// round to nearest, 10 mantissa bits).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// Four 8 x 16-byte matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; each thread gets 4 bytes of each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most kPending of the warpgroup's committed groups run.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Makes shared memory written through the generic proxy (cp.async) visible
// to the asynchronous proxy that wgmma reads with.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The shared-memory descriptor of a K-major operand without swizzle: core
// matrices of 8 rows x 16 bytes, the next one along K `kCoreBytes` on (the
// leading byte offset), the next 8 rows `kCoreRowBytes` on (the stride byte
// offset); all in units of 16 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(kCoreBytes >> 4) << 16) |
         (static_cast<uint64_t>(kCoreRowBytes >> 4) << 32);
}

// One asynchronous product of a warpgroup, d (+)= a * B: 64 rows, N = 2 x the
// length of d, a the thread's A fragment (tf32: k = 8, bfloat16: k = 16) and
// B read from shared memory through `desc` (K-major core matrices).
// `accumulate` false overwrites d.
#define CTSEG_ACC8(b)                                                        \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define CTSEG_ACC32(b) \
  CTSEG_ACC8(b), CTSEG_ACC8(b + 8), CTSEG_ACC8(b + 16), CTSEG_ACC8(b + 24)
#define CTSEG_REGS32                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define CTSEG_REGS64                                                         \
  CTSEG_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "   \
               "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
               "%55, %56, %57, %58, %59, %60, %61, %62, %63"
// `tail`: the scales of a and B, and for bfloat16 "B is not transposed".
#define CTSEG_WGMMA(name, shape, tail)                                        \
  __device__ __forceinline__ void name(float (&d)[64], const uint32_t (&a)[4], \
                                       uint64_t desc, bool accumulate) {      \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n128" shape " {" CTSEG_REGS64        \
        "}, {%64, %65, %66, %67}, %68, p, " tail ";\n}\n"                     \
        : CTSEG_ACC32(0), CTSEG_ACC32(32)                                     \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),              \
          "r"(static_cast<int>(accumulate)));                                 \
  }                                                                           \
  __device__ __forceinline__ void name(float (&d)[32], const uint32_t (&a)[4], \
                                       uint64_t desc, bool accumulate) {      \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n64" shape " {" CTSEG_REGS32         \
        "}, {%32, %33, %34, %35}, %36, p, " tail ";\n}\n"                     \
        : CTSEG_ACC32(0)                                                      \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),              \
          "r"(static_cast<int>(accumulate)));                                 \
  }
CTSEG_WGMMA(wgmma_tf32, "k8.f32.tf32.tf32", "1, 1")
CTSEG_WGMMA(wgmma_bf16, "k16.f32.bf16.bf16", "1, 1, 0")
#undef CTSEG_WGMMA
#undef CTSEG_REGS64
#undef CTSEG_REGS32
#undef CTSEG_ACC32
#undef CTSEG_ACC8

// y[img, m, co] = bias[co] + conv3x3_same(x[img], w)[m, co] for the block's
// 128 pixels and BN channels, float32, and the tile's (mean, M2) per channel
// into stats[img, tile, co, 0:2]. Grid (pixel tiles, channel tiles, N), 256
// threads: two warpgroups of 64 pixels x BN channels each. `wk` is the
// weights as prepare_weights_kernel lays them out.
//
// A is staged as rows of 128 bytes of input channels and read by ldmatrix
// into the m64 A fragments (warp w of a warpgroup holds its rows 16w..16w +
// 15); B is staged as core matrices and read by the tensor cores straight
// from shared memory.
//   - bfloat16: a step is 4 products of k = 16 into the one accumulator; one
//     step's products stay in flight while the warps fetch the next step's
//     fragments.
//   - float32: the fragments are split in registers (one split serves all BN
//     channels of the instruction), and a step's 12 products of k = 8 go
//     into a fresh accumulator that is then added to the running one in
//     float32 (see the head of this file): the chain that truncates is 12
//     long whatever Cin is. Measured on the way (H100, 700 W): a step takes
//     about 2,400 cycles with the copies taken out, at BN = 64 as at 128,
//     where the tensor cores' rate would allow 770 and 1,540: a k = 8
//     instruction costs about 100 cycles whatever its width, so splitting
//     BN into two chains of narrower instructions was slower, and flushing
//     every fourth step gained nothing.
template <typename T, int BN>
__global__ void __launch_bounds__(kTcThreads, WgSmem<T, BN>::kBlocksPerSM)
    conv3x3_wgmma_kernel(const T* __restrict__ x, const T* __restrict__ wk,
                         const float* __restrict__ bias, float* __restrict__ y,
                         float* __restrict__ stats, int h, int wd, int cin,
                         int cout) {
  using Smem = WgSmem<T, BN>;
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int kStages = Smem::kStages;
  constexpr int kVec = Smem::kVec;
  constexpr int kBK = Smem::kBK;
  constexpr int kAChunks = kStepBytes / 16;  // 16-byte copies a row
  constexpr int kAIters = kTcBM * kAChunks / kTcThreads;
  constexpr int kBIters = BN * kAChunks / kTcThreads;  // per plane
  constexpr int kAcc = BN / 2;                         // registers a thread

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* a_smem = reinterpret_cast<T*>(smem_raw);
  T* b_smem = a_smem + kStages * Smem::kAStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hw = h * wd;
  const int tile = blockIdx.x;
  const int m0 = tile * kTcBM;
  const int co0 = blockIdx.y * BN;
  const int img = blockIdx.z;
  const T* xin = x + static_cast<size_t>(img) * hw * cin;

  // A loader: rows tid / kAChunks + j * (threads / kAChunks), 16-byte chunk
  // tid % kAChunks of the step's input channels. (y, x) of each row's pixel,
  // packed; -1 for rows past the sample's last pixel.
  const int a_chunk = tid % kAChunks;
  int a_pos[kAIters];
#pragma unroll
  for (int j = 0; j < kAIters; ++j) {
    const int m = m0 + tid / kAChunks + j * (kTcThreads / kAChunks);
    a_pos[j] = m < hw ? ((m / wd) << 16) | (m % wd) : -1;
  }
  const int kchunks = (cin + kBK - 1) / kBK;
  const int steps = 9 * kchunks;
  const size_t plane_stride = static_cast<size_t>(9) * kchunks * kBK * cout;

  auto load_stage = [&](int step, int stage) {
    const int tap = step / kchunks;
    const int chunk = step - tap * kchunks;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    T* a_dst = a_smem + stage * Smem::kAStage;
    T* b_dst = b_smem + stage * Smem::kBStage;
    const int ci = chunk * kBK + a_chunk * kVec;
#pragma unroll
    for (int j = 0; j < kAIters; ++j) {
      const int row = tid / kAChunks + j * (kTcThreads / kAChunks);
      const int yy = (a_pos[j] >> 16) + dy;
      const int xx = (a_pos[j] & 0xffff) + dx;
      const bool ok = a_pos[j] >= 0 && ci < cin && yy >= 0 && yy < h &&
                      xx >= 0 && xx < wd;
      const T* src =
          ok ? xin + static_cast<size_t>(yy * wd + xx) * cin + ci : xin;
      ctseg::cp_async16(a_dst + row * Smem::kAStride + a_chunk * kVec, src, ok);
    }
    // B: the step's tile is one contiguous run of each plane, already in
    // core-matrix order (prepare_weights_kernel), so chunk i of the run goes
    // to chunk i of the stage. Channel tiles past Cout read zeros.
    const size_t b_src = ((static_cast<size_t>(tap) * kchunks + chunk) *
                              (cout >> 3) + (co0 >> 3)) * (kBK * 8);
#pragma unroll
    for (int plane = 0; plane < Smem::kPlanes; ++plane) {
#pragma unroll
      for (int j = 0; j < kBIters; ++j) {
        const int idx = tid + j * kTcThreads;  // 16-byte chunk of the tile
        const bool ok = co0 + (idx >> 6) * 8 < cout;
        const T* src =
            ok ? wk + plane * plane_stride + b_src + idx * kVec : wk;
        ctseg::cp_async16(b_dst + plane * Smem::kBPlane + idx * kVec, src, ok);
      }
    }
  };

  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  // This lane's ldmatrix row of the warp's 16 and 16-byte column of the
  // instruction's two; warpgroup wg's rows start at wg * 64.
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = lane >> 4;

  // The ring runs kStages - 2 steps ahead, and a step's products are only
  // waited for in the next step, after that step's fragments have been
  // loaded (and split): the tensor cores work through step s while the
  // warps prepare step s + 1. The fragments are double-buffered (wgmma reads
  // its A registers until it completes), so the loop is unrolled by two. The
  // copies of step s + kStages - 2 go to the stage that step s - 2 read,
  // whose products every warpgroup has waited for before this step's
  // barrier; they are issued after the products are queued, so that a
  // cp.async waiting for room in the memory pipeline holds up no arithmetic.
  static_assert(kStages >= 3, "a step of copies and two of products");
#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < steps) load_stage(s, s);
    ctseg::cp_async_commit();
  }
  uint32_t a_big[2][kKSteps][4], a_small[2][kKSteps][4];
  float step_acc[kAcc];
  for (int step0 = 0; step0 < steps; step0 += 2) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int step = step0 + half;
      if (step >= steps) break;
      ctseg::cp_async_wait<kStages - 3>();
      fence_async_shared();
      __syncthreads();
      const int stage = step % kStages;
      const T* a_tile = a_smem + stage * Smem::kAStage;
      const T* b_tile = b_smem + stage * Smem::kBStage;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t raw[4];
        ldmatrix_x4(raw, a_tile + a_row * Smem::kAStride +
                             (kk * 2 + a_col) * kVec);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (kSplit) {
            split_tf32(__uint_as_float(raw[r]), a_big[half][kk][r],
                       a_small[half][kk][r]);
          } else {
            a_big[half][kk][r] = raw[r];
          }
        }
      }
      if constexpr (kSplit) {
        if (step > 0) {
          wgmma_wait<0>();
#pragma unroll
          for (int r = 0; r < kAcc; ++r) acc[r] += step_acc[r];
        }
      }
      const uint64_t big_desc = wgmma_desc(b_tile);
      const uint64_t small_desc = wgmma_desc(b_tile + Smem::kBPlane);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        // k advances by 32 bytes: two core matrices.
        const uint64_t adv = static_cast<uint64_t>(kk * 2 * kCoreBytes >> 4);
        if constexpr (kSplit) {
          wgmma_tf32(step_acc, a_small[half][kk], big_desc + adv, kk > 0);
          wgmma_tf32(step_acc, a_big[half][kk], small_desc + adv, true);
          wgmma_tf32(step_acc, a_big[half][kk], big_desc + adv, true);
        } else {
          wgmma_bf16(acc, a_big[half][kk], big_desc + adv, step > 0 || kk > 0);
        }
      }
      wgmma_commit();
      // bfloat16: the step before has completed, so its stage and the other
      // fragment buffer are free; this step's products run on.
      if constexpr (!kSplit) wgmma_wait<1>();
      const int ahead = step + kStages - 2;
      if (ahead < steps) load_stage(ahead, ahead % kStages);
      ctseg::cp_async_commit();
    }
  }
  wgmma_wait<0>();
  if constexpr (kSplit) {
#pragma unroll
    for (int r = 0; r < kAcc; ++r) acc[r] += step_acc[r];
  }
  ctseg::cp_async_wait<0>();
  __syncthreads();  // the ring is free: reused below for the reductions

  // Epilogue. acc[4 j + r] is pixel warp*16 + g + 8*(r / 2), channel
  // 8 j + 2 t + r % 2 (g = lane / 4, t = lane % 4).
  const int g = lane >> 2;
  const int t = lane & 3;
  float* red_sum = reinterpret_cast<float*>(smem_raw);  // [8 warps][BN]
  float* red_m2 = red_sum + 8 * BN;                     // [8 warps][BN]
  const int count = min(kTcBM, hw - m0);
  const int m_lo = m0 + warp * 16 + g;
  const bool ok_lo = m_lo < hw;
  const bool ok_hi = m_lo + 8 < hw;
  float* yout = y + static_cast<size_t>(img) * hw * cout;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = co0 + j * 8 + 2 * t;
    if (co < cout) {  // cout is even
      const float b0 = bias[co], b1 = bias[co + 1];
      acc[4 * j] += b0;
      acc[4 * j + 1] += b1;
      acc[4 * j + 2] += b0;
      acc[4 * j + 3] += b1;
      if (ok_lo) {
        *reinterpret_cast<float2*>(yout + static_cast<size_t>(m_lo) * cout +
                                   co) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      }
      if (ok_hi) {
        *reinterpret_cast<float2*>(yout + static_cast<size_t>(m_lo + 8) * cout +
                                   co) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
  // Per channel: the thread's two pixels, the 8 lanes that share t (xor
  // shuffles: a fixed tree), then the 8 warps in order.
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float v = (ok_lo ? acc[4 * j + p] : 0.f) +
                (ok_hi ? acc[4 * j + 2 + p] : 0.f);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (g == 0) red_sum[warp * BN + j * 8 + 2 * t + p] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = j * 8 + 2 * t + p;
      float total = 0.f;
#pragma unroll
      for (int wi = 0; wi < 8; ++wi) total += red_sum[wi * BN + col];
      const float mean = total / static_cast<float>(count);
      const float d_lo = acc[4 * j + p] - mean;
      const float d_hi = acc[4 * j + 2 + p] - mean;
      float sq = (ok_lo ? d_lo * d_lo : 0.f) + (ok_hi ? d_hi * d_hi : 0.f);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      }
      if (g == 0) red_m2[warp * BN + col] = sq;
    }
  }
  __syncthreads();
  if (tid < BN && co0 + tid < cout) {
    float total = 0.f, m2 = 0.f;
#pragma unroll
    for (int wi = 0; wi < 8; ++wi) {
      total += red_sum[wi * BN + tid];
      m2 += red_m2[wi * BN + tid];
    }
    float* dst = stats + ((static_cast<size_t>(img) * gridDim.x + tile) * cout +
                          co0 + tid) * 2;
    dst[0] = total / static_cast<float>(count);
    dst[1] = m2;
  }
}

// The conv's B operand: the weights w (3, 3, cin, cout) transposed to K-major
// and laid out as the conv stages them, (plane, tap, cin chunk of kBK, cout /
// 8, k / kVec, cout % 8, k % kVec), so that a step's tile of 8 j channels x
// kBK input channels is one contiguous run of core matrices. float32: plane
// 0 = tf32(w) and plane 1 = tf32(w - tf32(w)), split once a call; bfloat16:
// one plane, the values as they are. Input channels past Cin (the last
// chunk's tail) are zeros. Grid (ceil(cout / 32), ceil(cin / kBK), 9), 256
// threads; cout % 8 == 0.
template <typename T>
__global__ void __launch_bounds__(256)
    prepare_weights_kernel(const T* __restrict__ w, T* __restrict__ wk,
                           int cin, int cout) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kBK = kStepBytes / static_cast<int>(sizeof(T));
  __shared__ float tile[kBK][33];  // [input channel][output channel]
  const int tap = blockIdx.z;
  const int co0 = blockIdx.x * 32;
  const int chunk = blockIdx.y;
  const int tx = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kBK; r += 8) {
    const int ci = chunk * kBK + r;
    const int co = co0 + tx;
    const size_t at = (static_cast<size_t>(tap) * cin + ci) * cout + co;
    tile[r][tx] = ci < cin && co < cout ? ctseg::to_float(w[at]) : 0.f;
  }
  __syncthreads();
  const int kchunks = gridDim.y;
  const size_t plane_stride = static_cast<size_t>(9) * kchunks * kBK * cout;
  const size_t base = ((static_cast<size_t>(tap) * kchunks + chunk) *
                           (cout >> 3) + (co0 >> 3)) * (kBK * 8);
  for (int e = threadIdx.x; e < 32 * kBK; e += 256) {
    const int core = e / (kBK * 8);  // which 8 output channels of the 32
    const int within = e % (kBK * 8);
    const int ci = within / (8 * kVec) * kVec + within % kVec;
    const int co = core * 8 + within / kVec % 8;
    if (co0 + co >= cout) continue;
    if constexpr (sizeof(T) == 4) {
      uint32_t big, small;
      split_tf32(tile[ci][co], big, small);
      wk[base + e] = __uint_as_float(big);
      wk[plane_stride + base + e] = __uint_as_float(small);
    } else {
      wk[base + e] = ctseg::from_float<T>(tile[ci][co]);
    }
  }
}

constexpr int kFinalizeThreads = 128;

// mean and rsinv per (sample, channel) from the tiles' (mean, M2), combined
// in tile order by Chan's parallel form; tile t holds min(128, hw - 128 t)
// pixels.
__global__ void __launch_bounds__(kFinalizeThreads)
    conv_stats_finalize_kernel(const float* __restrict__ stats,
                               float* __restrict__ mean_out,
                               float* __restrict__ rsinv_out, int tiles,
                               int hw, int cout) {
  const int co = blockIdx.x * kFinalizeThreads + threadIdx.x;
  const int img = blockIdx.y;
  if (co >= cout) return;
  const float2* src = reinterpret_cast<const float2*>(stats) +
                      static_cast<size_t>(img) * tiles * cout + co;
  float na = 0.f, mean = 0.f, m2 = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const float2 v = src[static_cast<size_t>(tile) * cout];
    const float nb = static_cast<float>(min(kTcBM, hw - tile * kTcBM));
    const float total = na + nb;
    const float delta = v.x - mean;
    mean += delta * (nb / total);
    m2 += v.y + delta * delta * (na * nb / total);
    na = total;
  }
  const size_t i = static_cast<size_t>(img) * cout + co;
  mean_out[i] = mean;
  rsinv_out[i] = rsqrtf(m2 / static_cast<float>(hw) + ctseg::kEps);
}

constexpr int kApplyThreads = 256;

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(ctseg::pack_bf16(v[0], v[1]), ctseg::pack_bf16(v[2], v[3]),
                 ctseg::pack_bf16(v[4], v[5]), ctseg::pack_bf16(v[6], v[7]));
}

// out = PReLU((y - mean) * rsinv) (and xhat when xhat_out is given), one
// read of the float32 scratch, 8 channels (32 bytes of y) a lane, lanes on
// consecutive groups of the flattened (pixel, channel) rows. groups = n * hw
// * cout / 8; cgroups = cout / 8.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
    in_prelu_apply_kernel(const float* __restrict__ y,
                          const float* __restrict__ mean,
                          const float* __restrict__ rsinv,
                          const float* __restrict__ alpha, T* __restrict__ out,
                          T* __restrict__ xhat_out, int groups,
                          int groups_per_sample, int cgroups) {
  const float a = alpha[0];
  for (int idx = blockIdx.x * kApplyThreads + threadIdx.x; idx < groups;
       idx += gridDim.x * kApplyThreads) {
    const int img = idx / groups_per_sample;
    const int stat = (img * cgroups + idx % cgroups) * 8;
    const float4* yp = reinterpret_cast<const float4*>(y) +
                       static_cast<size_t>(idx) * 2;
    const float4 y0 = yp[0], y1 = yp[1];
    const float4 m0 = *reinterpret_cast<const float4*>(mean + stat);
    const float4 m1 = *reinterpret_cast<const float4*>(mean + stat + 4);
    const float4 r0 = *reinterpret_cast<const float4*>(rsinv + stat);
    const float4 r1 = *reinterpret_cast<const float4*>(rsinv + stat + 4);
    const float xhat[8] = {
        (y0.x - m0.x) * r0.x, (y0.y - m0.y) * r0.y, (y0.z - m0.z) * r0.z,
        (y0.w - m0.w) * r0.w, (y1.x - m1.x) * r1.x, (y1.y - m1.y) * r1.y,
        (y1.z - m1.z) * r1.z, (y1.w - m1.w) * r1.w};
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = ctseg::prelu(xhat[i], a);
    store8(out + static_cast<size_t>(idx) * 8, o);
    if (xhat_out != nullptr) {
      store8(xhat_out + static_cast<size_t>(idx) * 8, xhat);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* alpha, void* scratch, void* out,
                   void* xhat_out, void* rsinv_out, int n, int h, int wd,
                   int cin, int cout, cudaStream_t stream) {
  const int total = n * h * wd;
  const dim3 conv_grid((total + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  conv3x3_bias_kernel<T><<<conv_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<float*>(scratch), n, h, wd,
      cin, cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 norm_grid((cout + kTileC - 1) / kTileC, n);
  in_prelu_two_pass_kernel<T><<<norm_grid, dim3(kTileC, kRows), 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<T*>(out),
      static_cast<const float*>(alpha), static_cast<T*>(xhat_out),
      static_cast<float*>(rsinv_out), h * wd, cout);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t launch_wgmma_conv(const T* x, const T* wk, const float* bias,
                              float* scratch, float* stats, int n, int h,
                              int wd, int cin, int cout, cudaStream_t stream) {
  constexpr int kBytes = WgSmem<T, BN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((h * wd + kTcBM - 1) / kTcBM, (cout + BN - 1) / BN, n);
  conv3x3_wgmma_kernel<T, BN><<<grid, kTcThreads, kBytes, stream>>>(
      x, wk, bias, scratch, stats, h, wd, cin, cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const void* x, const void* w, const void* bias,
                      const void* alpha, void* scratch, void* stats,
                      void* mean, void* rsinv, void* out, void* xhat_out,
                      void* wk, int n, int h, int wd, int cin, int cout,
                      cudaStream_t stream) {
  constexpr int kBK = kStepBytes / static_cast<int>(sizeof(T));
  const int hw = h * wd;
  const int tiles = (hw + kTcBM - 1) / kTcBM;
  const dim3 prep_grid((cout + 31) / 32, (cin + kBK - 1) / kBK, 9);
  prepare_weights_kernel<T><<<prep_grid, 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(wk), cin, cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto conv = cout % 128 == 0 ? &launch_wgmma_conv<T, 128>
                                    : &launch_wgmma_conv<T, 64>;
  err = conv(static_cast<const T*>(x), static_cast<const T*>(wk),
             static_cast<const float*>(bias), static_cast<float*>(scratch),
             static_cast<float*>(stats), n, h, wd, cin, cout, stream);
  if (err != cudaSuccess) return err;
  const dim3 fin_grid((cout + kFinalizeThreads - 1) / kFinalizeThreads, n);
  conv_stats_finalize_kernel<<<fin_grid, kFinalizeThreads, 0, stream>>>(
      static_cast<const float*>(stats), static_cast<float*>(mean),
      static_cast<float*>(rsinv), tiles, hw, cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int groups = n * hw * (cout / 8);
  const int wanted = (groups + kApplyThreads - 1) / kApplyThreads;
  const int blocks = wanted < 132 * 16 ? wanted : 132 * 16;
  in_prelu_apply_kernel<T><<<blocks, kApplyThreads, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<const float*>(mean),
      static_cast<const float*>(rsinv), static_cast<const float*>(alpha),
      static_cast<T*>(out), static_cast<T*>(xhat_out), groups,
      hw * (cout / 8), cout / 8);
  return cudaGetLastError();
}

}  // namespace

// Forward, FP32-pipe route (any Cin, Cout). x: (n, h, wd, cin) and w: (3, 3,
// cin, cout), contiguous, of the type `dtype` names; bias: (cout,) float32;
// alpha: one float32; scratch: (n, h, wd, cout) float32; out: (n, h, wd,
// cout) of x's type. xhat_out (like out) and rsinv_out ((n, cout) float32)
// for the training forward, or both null (serving). All on the device.
// Launches both kernels on `stream`, allocates nothing, returns the first
// failing launch's cudaError_t.
extern "C" int ctseg_conv3x3_in_prelu_fwd(const void* x, const void* w,
                                          const void* bias, const void* alpha,
                                          void* scratch, void* out,
                                          void* xhat_out, void* rsinv_out,
                                          int n, int h, int wd, int cin,
                                          int cout, int dtype, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((xhat_out == nullptr) != (rsinv_out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch<float>(x, w, bias, alpha, scratch, out, xhat_out,
                           rsinv_out, n, h, wd, cin, cout, st);
    case ctseg::kBFloat16:
      return launch<__nv_bfloat16>(x, w, bias, alpha, scratch, out, xhat_out,
                                   rsinv_out, n, h, wd, cin, cout, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Forward, tensor-core route: cin and cout multiples of 8, h and wd below
// 32768, every tensor 16-byte aligned (else cudaErrorInvalidValue). Tensors
// as above, plus the workspaces stats: (n, ceil(h*wd / 128), cout, 2)
// float32, mean and rsinv: (n, cout) float32 (rsinv is the training
// forward's residual; serving allocates it all the same). xhat_out like out
// (training) or null. wk: the weights as the conv stages them, written here,
// of x's type: (2, 9, cin rounded up to 32, cout) for float32 (the big and
// small tf32 planes), (1, 9, cin rounded up to 64, cout) for bfloat16.
// Launches four kernels on `stream`.
extern "C" int ctseg_conv3x3_in_prelu_fwd_tc(
    const void* x, const void* w, const void* bias, const void* alpha,
    void* scratch, void* stats, void* mean, void* rsinv, void* out,
    void* xhat_out, void* wk, int n, int h, int wd, int cin, int cout,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(scratch) |
      reinterpret_cast<uintptr_t>(stats) |
      reinterpret_cast<uintptr_t>(mean) | reinterpret_cast<uintptr_t>(rsinv) |
      reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(xhat_out) |
      reinterpret_cast<uintptr_t>(wk);
  if (wk == nullptr || cin % 8 != 0 || cout % 8 != 0 || h >= 32768 ||
      wd >= 32768 || bits % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ctseg::kFloat32:
      return launch_tc<float>(x, w, bias, alpha, scratch, stats, mean, rsinv,
                              out, xhat_out, wk, n, h, wd, cin, cout, st);
    case ctseg::kBFloat16:
      return launch_tc<__nv_bfloat16>(x, w, bias, alpha, scratch, stats, mean,
                                      rsinv, out, xhat_out, wk, n, h, wd, cin,
                                      cout, st);
    default:
      return cudaErrorInvalidValue;
  }
}
