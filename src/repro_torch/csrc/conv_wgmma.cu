// bf16 implicit-GEMM valid convolution with a fused epilogue on Hopper's
// warpgroup MMA:
//     out[n, k, oy, ox] = relu?(sum_{c,a,b} w[k, c, a, b] * x[n, c, oy*s + a, ox*s + b]
//                               + bias[k] + residual[n, k, oy, ox])
// The wgmma route of rt_conv_im2col_batch_bf16 / rt_conv_im2col_bf16
// (im2col_gemm.cu): bf16 x and w with at least 64 output channels, fp32
// accumulation, bias and residual each read as fp32 or bf16, the output
// rounded once to bf16. kernels/im2col_gemm/ops.route decides before
// anything launches; fp32 calls and bf16 calls with fewer than 64 output
// channels run im2col_gemm.cu's mma.sync kernels, unchanged, and a call that
// names this route on operands it cannot take is refused in im2col_gemm.py,
// never rerouted.
//
// Replaces, for those calls, the same two TPU kernels as im2col_gemm.cu:
// `conv_im2col_batch` (src/repro/kernels/im2col_gemm/im2col_gemm.py:155,
// body `_conv_batch_kernel` :129) and `conv_im2col` (:76, body `_conv_kernel`
// :50), which build each output row's (C*f*f, ow) patch block in VMEM and
// feed it to the MXU, accumulate in fp32 (`preferred_element_type=f32`,
// :66, :145), widen bias and residual to fp32 and apply `_finish` (:38)
// before the one store in x's dtype. One image runs as N = 1.
//
// The GEMM: M = output channels K, N = batch * output pixels P, reduction
// R = C*f*f in the reference's (c, a, b) order. A is the (K, R) weight
// matrix; B, the (R, P) patch matrix, is gathered stage by stage from x and
// never exists in device memory.
//
// What bounds it on the H100: resnet18's 20 convs at b = 8 are 58.6 GFLOP
// against about 300 MB of 2-byte traffic, 0.059 ms at the bf16 rate (989
// TFLOP/s) and 0.092 ms at 3.35 TB/s (chip_smoke.py's bound): bound by
// bytes, and only just. The patches
// are the problem: every x element enters f^2 patch rows, and TMA cannot
// address them (NCHW rows are W * 2 bytes apart, 218 for resnet18's W =
// 109, off 16 bytes; TMA's im2col mode describes a padded NHWC window, not
// this valid-padded NCHW layout), so threads gather them element by
// element. im2col_gemm.cu's bf16 kernel gathers inside its stage loader
// with plain loads that every warp waits for before its mma.sync, which
// itself reaches at most a quarter of the bf16 rate.
//
// What the design does:
// 1. Weights (A, K-major, 64 deep a stage) by TMA through wgmma_bf16.cuh's
//    make_map (64-wide boxes, 128-byte swizzle, zero fill past K and R)
//    where R % 8 == 0 and w is 16-byte aligned: 19 of resnet18's 20 convs.
//    Elsewhere (R = 147, resnet18's first conv) the producer warpgroup
//    writes A into the same swizzled layout with plain loads. Nothing is
//    padded or copied in device memory.
// 2. Patches (B) gathered by a producer warpgroup, as a K-major operand:
//    one row of 64 k (128 bytes) a pixel, 8-row atoms 1,024 bytes apart,
//    the 16-byte chunk j of row n at chunk j ^ (n % 8) (TMA's 128-byte
//    swizzle), read by wgmma with the transpose-B bit 0, as attention reads
//    K in flash_wgmma.cu. Thread t owns pixel t of each 128-pixel round
//    (two threads a pixel at BN = 64, each half of the k): the x offset of
//    its patch origin, img*C*H*W + oy*s*W + ox*s, is computed once a tile
//    and kept in a register, and each warp tabulates a stage's 64 offsets
//    c*H*W + a*W + b in shared memory (one lane two of them), read back as
//    broadcasts. A thread issues all of its stage's loads (64 at BN >= 128)
//    through the read-only path before it packs and stores any, so a warp's
//    loads hit 32 neighbouring pixels at one k (64 contiguous bytes at
//    stride 1; each x element is read f^2 times) and its stores are 16
//    bytes a lane, conflict-free under the swizzle. An element costs one
//    load, one 32-bit add and one wide multiply-add of its address, and
//    half a byte-permute to pack it. The MN-major layout (8 pixels at one
//    k a chunk) would need 8 pixel offsets a thread and spread a warp's
//    loads over 512 bytes. The gather still binds on the wide layers (PERF.md
//    section 6): a stage's loads fly together, but the next stage's wait
//    for its stores. A prefetch of the next stage's lines into L1, and a register pipeline
//    that issued the next round's loads before storing this one's, both
//    ran slower (the second spilled) and were dropped (PERF.md section 6).
// 3. Proxy order: the producers' stores are generic-proxy writes that
//    wgmma reads through the async proxy, so every producer thread runs
//    fence.proxy.async.shared::cta after its stores, and only then does its
//    warp arrive on the stage's full barrier; without the fence a stage can
//    be read stale. The full barrier counts the four producer warps and one
//    arrival of thread 0 that carries A's TMA bytes (expect_tx), or none
//    where the producers wrote A themselves.
// 4. Warp specialisation: warpgroup 0 produces, and warpgroups 1..BM/64
//    consume, each running m64nBNk16 wgmma on its 64-row slab of output
//    channels against the stage's BN pixels. A ring of kStages stages, a
//    full and an empty mbarrier each, and no __syncthreads() in the main
//    loop; a consumer keeps one stage's wgmma group in flight
//    while it waits for the next and frees each stage as soon as it is
//    read, as matmul_wgmma.cu does (its design points 3 and 5).
// 5. Persistent: as many CTAs as the card holds walk the output tiles
//    (output channels fastest, so CTAs on one pixel tile share x through
//    L2), and the producer gathers the next tile's stages while the
//    consumers run this tile's epilogue.
// 6. Accuracy. For BN <= 128 each run of kPromoteSteps stages (256 deep) is
//    summed from zero and added to the running sum with a rounding fp32
//    add, read only after wgmma.wait_group 0 (matmul_wgmma.cu's point 5);
//    BN = 256 has no registers for a second accumulator and sums all of R
//    (at most 4,608 in resnet18) in one.
// 7. The epilogue: bias -> residual -> ReLU on the fp32 sum (the order of
//    epilogue.cuh's `finish`), one bf16 rounding at the store. The
//    accumulator's columns are pixels: each consumer warp passes its 16
//    channels through 2.5 KB of staging rows in shared memory, 32 pixels a
//    pass, so a warp instruction reads the residual of, and stores, 32
//    neighbouring pixels of one channel; from the fragment itself a quad of
//    lanes wrote 8 of them, 2 bytes a lane. The residual is read in the
//    pass that adds it: loading it a pass ahead measured no faster.
// 8. Deterministic split-K, only where the output tiles cannot give each of
//    the 132 SMs a CTA (ops.wgmma_plan): each split stores its raw fp32
//    partial to the caller's workspace, and epilogue.cuh's splitk_reduce
//    adds them in split order and applies the epilogue once, so a split
//    result is still rounded once. No atomics: two calls give bit-identical
//    outputs.
//
// The tiles (kernels/im2col_gemm/im2col_gemm.WGMMA_TILES, chosen by
// ops.wgmma_plan): one consumer warpgroup on 64, 128 or 256 pixels, or two
// on 64 (a 384-thread CTA gets 168 registers a thread: a wider tile's
// accumulators spilled), BK 64 (one 128-byte swizzle row), kStages = 4.
#include <cuda_bf16.h>

#include <atomic>

#include "epilogue.cuh"
#include "wgmma_bf16.cuh"

namespace {

using rt::bf::bf16;
using rt::tc::Ep;

// Floats in a row of a consumer warp's staging rows for the epilogue: 32
// columns and 8 of padding, so the fragment's 8-byte writes (8 rows x 4
// column pairs a half warp) and the row reads (32 columns) both hit 32 banks.
constexpr int kStageRow = 40;

// Stages in the ring.
constexpr int kStages = 4;

// Shape of one instantiated tile.
template <int BM, int BN>
struct ConvTile {
  static constexpr int S = kStages;
  static constexpr int BK = 64;                     // one swizzle row
  static constexpr int kConsumers = BM / 64;        // warpgroups of wgmma
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kABytes = BM * BK * 2;       // A stage: BM rows of BK
  static constexpr int kBBytes = BN * BK * 2;       // B stage: BN pixel rows
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the producer's gather: 128 pixels a round (BN of them where BN < 128,
  // two threads a pixel), each thread kChunks 8-deep chunks of its pixel's
  // row a round
  static constexpr int kPix = BN < 128 ? BN : 128;
  static constexpr int kRounds = BN / kPix;
  static constexpr int kChunks = 8 * kPix / 128;
  // each producer warp's table of a stage's 64 patch-row offsets
  static constexpr int kTableBytes = 4 * 64 * 4;
  // each consumer warp's staging rows for the epilogue: 16 of kStageRow
  // floats
  static constexpr int kStagingBytes = kConsumers * 4 * 16 * kStageRow * 4;
  // 1,024 bytes of alignment slack, the ring, the tables, the staging rows,
  // the 2 S barriers
  static constexpr int kSmemBytes =
      1024 + S * kStageBytes + kTableBytes + kStagingBytes + 2 * S * 8;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma widths");
  // a stage accumulator beside the running sum where registers allow
  static constexpr bool kPromote = BN <= 128;
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

// 64-deep stages summed into one partial before it is added to the running
// sum (the promotion interval)
constexpr int kPromoteSteps = 4;

__device__ __forceinline__ int4 ld_shared_v4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// One stage of this warpgroup's slab: p (+)= A (64 x 64, at `a`) @ B (64 x
// BN, K-major at `b`), four 16-deep wgmma steps, summed from zero where
// `Fresh`, committed as one group.
template <int BN, bool Fresh>
__device__ __forceinline__ void stage_mma(float (&p)[BN / 2], const uint8_t* a,
                                          const uint8_t* b) {
  if constexpr (Fresh)
    rt::wg::fence_regs_overwritten(p);
  else
    rt::wg::fence_regs(p);
  rt::wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    rt::wg::wgmma<BN, 0>(p, rt::wg::desc(a + 32 * kk, 16, 1024),
                         rt::wg::desc(b + 32 * kk, 16, 1024), kk > 0 || !Fresh);
  rt::wg::wgmma_commit();
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);   // bf16 bits
}

// The epilogue of one consumer warp: its 16 output channels m0 .. m0 + 15
// of the tile's BN pixels at n0, through its staging rows `buf` in shared
// memory, 32 pixels a pass: the fragment's sums go in, then each lane takes
// one pixel and walks the 16 channels, so each warp instruction reads the
// residual of, and stores, 32 neighbouring pixels of one channel (NCHW rows:
// contiguous within an image). Bias -> residual (RT: bf16 bits or fp32; null
// for none) -> ReLU on the fp32 sum and one bf16 rounding, or, for a split,
// the raw fp32 partial into `part`. Outputs past K or P are never stored.
template <int BN, class RT>
__device__ __forceinline__ void finish_tile(const float (&acc)[BN / 2],
                                            uint32_t buf, int m0, int n0,
                                            int K, int ohw, int P, Ep bias,
                                            const RT* __restrict__ res,
                                            int relu, bf16* __restrict__ out,
                                            float* __restrict__ part) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int kohw = K * ohw;
  float bz[16];
#pragma unroll
  for (int r = 0; r < 16; ++r)
    bz[r] = part == nullptr && bias && m0 + r < K ? bias[m0 + r] : 0.f;
#pragma unroll
  for (int pass = 0; pass < BN / 32; ++pass) {
    __syncwarp();                    // the last pass has read its rows
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 4 * pass + jj;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         buf + 4 * ((g + 8 * h) * kStageRow + 8 * jj + 2 * q)),
                     "f"(acc[4 * j + 2 * h]), "f"(acc[4 * j + 2 * h + 1])
                     : "memory");
      }
    __syncwarp();
    const int n = n0 + 32 * pass + lane;
    const int img = n / ohw;
    const int base = img * kohw + (n - img * ohw);
    float v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(v[r])
                   : "r"(buf + 4 * (r * kStageRow + lane))
                   : "memory");
    if (n >= P) continue;
    if (part != nullptr) {
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (m0 + r < K) part[base + (m0 + r) * ohw] = v[r];
      continue;
    }
    if (res != nullptr) {
      RT rv[16];                     // every load before any use
#pragma unroll
      for (int r = 0; r < 16; ++r)
        rv[r] = __ldg(res + (m0 + r < K ? base + (m0 + r) * ohw : base));
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = v[r] + bz[r] + widen(rv[r]);
    } else {
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] += bz[r];
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (m0 + r < K)
        out[base + (m0 + r) * ohw] =
            __float2bfloat16_rn(relu ? fmaxf(v[r], 0.f) : v[r]);
  }
}

// One output tile of the persistent walk: output channels [m0, m0 + BM),
// pixels [n0, n0 + BN), R split s, whose 64-deep steps are [first, first +
// steps).
struct Unit {
  int m0, n0, s, first, steps;
};

// A's stage from plain loads (rows whose starts TMA cannot address): rows
// m0.. of w (K, R), columns k0 .. k0 + 63, zero past K and R, written K-major
// in the 128-byte swizzle TMA would write. Producer thread t (of 128) writes
// row t % BM, BM / 16 of its 8 chunks.
template <int BM>
__device__ __forceinline__ void gather_a(uint8_t* a, const bf16* __restrict__ w,
                                         int K, int R, int m0, int k0, int t) {
  constexpr int kPer = BM / 16;
  const int m = t % BM, j0 = t / BM * kPer;
  const bool row = m0 + m < K;
  const unsigned short* src =
      reinterpret_cast<const unsigned short*>(w) + (row ? m0 + m : 0) * R;
  uint32_t v[kPer][8];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + 8 * (j0 + j) + e;
      const bool ok = row && k < R;
      v[j][e] = __ldg(src + (ok ? k : 0)) & (ok ? 0xffffu : 0u);
    }
  const uint32_t base = rt::wg::smem_addr(a + m * 128);
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    st_shared_v4(base + (((j0 + j) ^ (m & 7)) << 4), v[j][0] | v[j][1] << 16,
                 v[j][2] | v[j][3] << 16, v[j][4] | v[j][5] << 16,
                 v[j][6] | v[j][7] << 16);
}

// grid (CTAs): a persistent walk over the output tiles. Units are numbered
// with the output-channel tiles fastest, then the pixel tiles, then the R
// splits; CTA b takes units b, b + gridDim.x, ... Split s walks the 64-deep
// steps [s * per, (s + 1) * per) of R; with split == 1 a unit stores the
// finished bf16 output, else its raw fp32 partial sum into ws[s]. a_tma: A
// arrives by TMA through mapA (else the producers gather it). Offsets into
// x, w and out fit in int32 (the wrapper refuses larger tensors); the
// workspace's are 64-bit.
template <int BM, int BN>
__global__ void __launch_bounds__(ConvTile<BM, BN>::kThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap mapA,
                      const bf16* __restrict__ x, const bf16* __restrict__ w,
                      Ep bias, Ep res, bf16* __restrict__ out,
                      float* __restrict__ ws, int C, int H, int W, int K,
                      int f, int s, int ow, int ohw, int P, int relu,
                      int split, int a_tma) {
  using T = ConvTile<BM, BN>;
  constexpr int S = T::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* table = reinterpret_cast<int*>(smem + S * T::kStageBytes);
  uint8_t* stagings = smem + S * T::kStageBytes + T::kTableBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stagings + T::kStagingBytes);
  uint64_t* empty = full + S;

  const int R = C * f * f;
  const int mt = (K + BM - 1) / BM, nt = (P + BN - 1) / BN;
  const int units = mt * nt * split;
  const int all = (R + T::BK - 1) / T::BK;
  const int per = (all + split - 1) / split;
  auto unit = [&](int u) {
    Unit v;
    v.m0 = u % mt * BM;
    u /= mt;
    v.n0 = u % nt * BN;
    v.s = u / nt;
    v.first = v.s * per;
    v.steps = min(all, v.first + per) - v.first;
    return v;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      rt::wg::mbar_init(&full[i], 4 + 1);        // producer warps + thread 0
      rt::wg::mbar_init(&empty[i], T::kConsumers);
    }
    rt::wg::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer warpgroup: A's TMA loads (thread 0) or plain loads, and
    // the patch gather, across units, so the next unit's stages fill
    // during this one's epilogue
    const int t = threadIdx.x, lane = t % 32;
    // this warp's table of a stage's 64 patch-row offsets, in shared memory
    const uint32_t tab = rt::wg::smem_addr(table + t / 32 * 64);
    const int pix = t % T::kPix;                  // pixel row of a round
    const int j0 = t / T::kPix * T::kChunks;      // first chunk of the row
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
    const int HW = H * W, ff = f * f;
    if (t == 0 && a_tma) rt::wg::prefetch_map(&mapA);
    int g = 0;                                    // stages produced
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit v = unit(u);
      int col[T::kRounds];                        // patch origins; -1 past P
#pragma unroll
      for (int r = 0; r < T::kRounds; ++r) {
        const int j = v.n0 + r * T::kPix + pix;
        const int img = j / ohw, p = j - img * ohw;
        const int oy = p / ow, ox = p - oy * ow;
        col[r] = j < P ? img * C * HW + oy * s * W + ox * s : -1;
      }
      for (int i = 0; i < v.steps; ++i, ++g) {
        const int st = g % S;
        const int k0 = (v.first + i) * T::BK;
        // the stage's 64 patch-row offsets, two a lane, into this warp's
        // table (its lanes have read the last stage's)
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + lane + 32 * h;
          const int c = k / ff, rem = k - c * ff;
          const int a = rem / f, b = rem - a * f;
          rt::wg::st_shared(tab + 4 * (lane + 32 * h), k < R ? c * HW + a * W + b : 0);
        }
        __syncwarp();
        rt::wg::mbar_wait(&empty[st], ((g / S) & 1) ^ 1);
        uint8_t* a = smem + st * T::kStageBytes;
        if (t == 0) {
          if (a_tma) {
            rt::wg::mbar_expect_tx(&full[st], T::kABytes);
            rt::wg::tma_load(a, &mapA, &full[st], k0, v.m0, 0);
          } else {
            rt::wg::mbar_arrive(&full[st]);
          }
        }
        if (!a_tma) gather_a<BM>(a, w, K, R, v.m0, k0, t);
        const uint32_t bs = rt::wg::smem_addr(a + T::kABytes);

#pragma unroll
        for (int r = 0; r < T::kRounds; ++r) {
          // every load of the round, then every store. No predicate: a
          // pixel past P reads x at its patch-row offsets from x's start
          // (its accumulator column is never stored), and only the last
          // stage of R zeroes its rows past R (A's columns there are zero
          // too, but x may hold an Inf that 0 * Inf would spread). Each
          // address is one 32-bit add and one wide multiply-add.
          const unsigned at = max(col[r], 0);
          uint32_t e[T::kChunks * 8];
#pragma unroll
          for (int j = 0; j < T::kChunks; ++j) {
            const int4 lo = ld_shared_v4(tab + 32 * (j0 + j));
            const int4 hi = ld_shared_v4(tab + 32 * (j0 + j) + 16);
            const unsigned o[8] = {at + lo.x, at + lo.y, at + lo.z, at + lo.w,
                                   at + hi.x, at + hi.y, at + hi.z, at + hi.w};
#pragma unroll
            for (int q = 0; q < 8; ++q) e[8 * j + q] = __ldg(xs + o[q]);
          }
          if (k0 + T::BK > R) {
#pragma unroll
            for (int j = 0; j < T::kChunks * 8; ++j)
              if (k0 + 8 * j0 + j >= R) e[j] = 0u;
          }
          const int n = r * T::kPix + pix;
#pragma unroll
          for (int j = 0; j < T::kChunks; ++j)
            st_shared_v4(bs + n * 128 + (((j0 + j) ^ (n & 7)) << 4),
                         e[8 * j] | e[8 * j + 1] << 16,
                         e[8 * j + 2] | e[8 * j + 3] << 16,
                         e[8 * j + 4] | e[8 * j + 5] << 16,
                         e[8 * j + 6] | e[8 * j + 7] << 16);
        }
        // the stores reach the async proxy before the stage is published
        rt::wg::fence_async_shared();
        __syncwarp();
        if (lane == 0) rt::wg::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // a consumer: output channels [64 c, 64 c + 64) of each unit's tile
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  // this warp's staging rows
  const uint32_t staging =
      rt::wg::smem_addr(stagings + (4 * c + t / 32) * 16 * kStageRow * 4);
  constexpr int NR = BN / 2;
  float acc[NR], p[T::kPromote ? NR : 1];
  int g = 0, freed = 0;                           // stages used, released
  auto free_to = [&](int j) {
    for (; freed < j; ++freed)
      if (t == 0) rt::wg::mbar_arrive(&empty[freed % S]);
  };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit v = unit(u);
    for (int i = 0; i < v.steps; ++i, ++g) {
      const int st = g % S;
      rt::wg::mbar_wait(&full[st], (g / S) & 1);
      const uint8_t* a = smem + st * T::kStageBytes;
      if constexpr (T::kPromote) {
        // a partial of kPromoteSteps stages, added once they are all done
        if (i % kPromoteSteps == 0)
          stage_mma<BN, true>(p, a + c * 64 * 128, a + T::kABytes);
        else
          stage_mma<BN, false>(p, a + c * 64 * 128, a + T::kABytes);
        if (i % kPromoteSteps == kPromoteSteps - 1 || i + 1 == v.steps) {
          rt::wg::wgmma_wait<0>();
          rt::wg::fence_regs(p);
          if (i < kPromoteSteps) {
#pragma unroll
            for (int r = 0; r < NR; ++r) acc[r] = p[r];
          } else {
#pragma unroll
            for (int r = 0; r < NR; ++r) acc[r] += p[r];
          }
          free_to(g + 1);
          continue;
        }
      } else {
        if (i == 0)
          stage_mma<BN, true>(acc, a + c * 64 * 128, a + T::kABytes);
        else
          stage_mma<BN, false>(acc, a + c * 64 * 128, a + T::kABytes);
      }
      rt::wg::wgmma_wait<1>();                    // stage g - 1 is done
      free_to(g);
    }
    rt::wg::wgmma_wait<0>();
    rt::wg::fence_regs(acc);
    free_to(g);

    // the epilogue, each warp its 16 channels of the slab
    const int m0w = v.m0 + 64 * c + 16 * (t / 32);
    float* part = split == 1 ? nullptr : ws + (long long)v.s * K * P;
    if (res && res.bf16)
      finish_tile<BN>(acc, staging, m0w, v.n0, K, ohw, P, bias,
                      static_cast<const unsigned short*>(res.p), relu, out, part);
    else
      finish_tile<BN>(acc, staging, m0w, v.n0, K, ohw, P, bias,
                      static_cast<const float*>(res.p), relu, out, part);
  }
}

template <int BM, int BN>
int launch_tile(const bf16* x, const bf16* w, Ep bias, Ep res, bf16* out,
                float* ws, int N, int C, int H, int W, int K, int f, int s,
                int oh, int ow, int relu, int split, cudaStream_t stream) {
  using T = ConvTile<BM, BN>;
  auto* kernel = conv_wgmma_kernel<BM, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int R = C * f * f, ohw = oh * ow, P = N * ohw;
  // A by TMA where its rows start on 16-byte boundaries
  const int a_tma = R % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  CUtensorMap ma = {};
  if (a_tma) {
    const int err = rt::wg::make_map(&ma, w, K, R, 1, 0, 64, BM);
    if (err != 0) return err;
  }
  const long long units =
      (long long)((K + BM - 1) / BM) * ((P + BN - 1) / BN) * split;
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // as many CTAs as the card holds at once (asked once per instantiation),
  // each walking its share of the units
  static std::atomic<int> most{0};
  int fit = most.load();
  if (fit == 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, T::kThreads, T::kSmemBytes);
    if (q == cudaSuccess) q = cudaGetDevice(&dev);
    if (q == cudaSuccess)
      q = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (q != cudaSuccess) return (int)q;
    fit = per_sm * sms;
    if (fit == 0) return (int)cudaErrorInvalidConfiguration;
    most.store(fit);
  }
  const int grid = units < fit ? (int)units : fit;
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      ma, x, w, bias, res, out, ws, C, H, W, K, f, s, ow, ohw, P, relu, split,
      a_tma);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  return rt::tc::launch_splitk_reduce(ws, bias, res, out, K, ohw, split,
                                      (long long)K * P, relu, stream, 1);
}

// Every (BM, BN) tile ops.wgmma_plan may choose (im2col_gemm.WGMMA_TILES).
#define RT_FOR_EACH_CONV_WGMMA_TILE(X) X(64, 64) X(64, 128) X(64, 256) X(128, 64)

}  // namespace

// x (N, C, H, W), w (K, C, f, f) bf16, bias (K,) or null, res (N, K, oh, ow)
// or null, each fp32 or bf16 (bias_bf16, res_bf16) -> out (N, K, oh, ow)
// bf16, all contiguous; ws (split, N, K, oh, ow) fp32 scratch when split >
// 1, else null. One image is N = 1. Returns cudaGetLastError() after the
// launches; an unknown tile or an illegal split returns
// cudaErrorInvalidValue without launching.
extern "C" int rt_conv_wgmma_bf16(const bf16* x, const bf16* w,
                                  const void* bias, const void* res, bf16* out,
                                  float* ws, int N, int C, int H, int W, int K,
                                  int f, int s, int oh, int ow, int relu,
                                  int bm, int bn, int split,
                                  int bias_bf16, int res_bf16,
                                  cudaStream_t stream) {
  // every split must own at least one 64-deep step, and a split needs a
  // workspace
  const int steps = (C * f * f + 63) / 64;
  if (split < 1 || N < 1 || K < 1 || oh < 1 || ow < 1)
    return (int)cudaErrorInvalidValue;
  const int per = (steps + split - 1) / split;
  if (split > 1 && (ws == nullptr || (split - 1) * per >= steps))
    return (int)cudaErrorInvalidValue;
  const Ep eb{bias, bias_bf16}, er{res, res_bf16};
#define RT_LAUNCH(BM_, BN_)                                              \
  if (bm == BM_ && bn == BN_)                                             \
    return launch_tile<BM_, BN_>(x, w, eb, er, out, ws, N, C, H, W, K, f, \
                                 s, oh, ow, relu, split, stream);
  RT_FOR_EACH_CONV_WGMMA_TILE(RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
