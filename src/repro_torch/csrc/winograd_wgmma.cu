// bf16 Winograd point-GEMM on Hopper's warpgroup MMA:
//     M[n, p] = U[p] @ V[n, p]      U (P, K, C), V (N, P, C, T), M (N, P, K, T)
// The wgmma route of rt_winograd_point_gemm_batch_bf16 /
// rt_winograd_point_gemm_bf16 (winograd.cu): bf16 U and V with at least 64
// output channels K and C % 8 == 0, fp32 accumulation, M rounded once to
// bf16. kernels/winograd/ops.route decides before anything launches (and
// sends calls of fewer than 8 output columns to mma.sync); fp32
// calls and the bf16 calls this route cannot take run winograd.cu's
// mma.sync kernels, unchanged, and a call that names this route on operands
// it cannot take is refused in winograd.py, never rerouted.
//
// Replaces, for those calls, the same two TPU kernels as winograd.cu:
// `winograd_point_gemm_batch` (src/repro/kernels/winograd/winograd.py:77,
// body `_point_gemm_batch_kernel` :64) and `winograd_point_gemm` (:36, body
// `_point_gemm_kernel` :23), which accumulate each (K, T) block of M over C
// in an fp32 VMEM scratch and store it once in u's dtype. One image runs as
// N = 1.
//
// What bounds it on the H100: bytes. resnet18's 13 3x3 stride-1 convs at
// F(2x2) and b = 8 move about 535 MB of 2-byte traffic (0.160 ms at 3.35
// TB/s) for 24 GFLOP (0.024 ms at the bf16 rate). Almost all of it is V in
// and M out, as large as each other on the 64-channel layers (K = C = 64, T
// = 2,601-2,916), which hold two thirds of it. TMA cannot address V: its
// rows are T * 2 bytes apart, off 16 bytes on 10 of the 13 layers (T odd or
// T = 4 mod 8), and M's rows likewise. Measured (PERF.md section 6): on
// one 64 x 256 CTA an SM the 64-channel layers ran at about 1.4 TB/s, the
// producer (one DRAM round trip per 40 KB stage) and the consumers (their
// stores) each alone taking the whole time; two 64 x 64 CTAs an SM, each
// its own producer, reach about 1.7 TB/s.
//
// What the design does:
// 1. U (A, K-major) by TMA through wgmma_bf16.cuh's make_map: a 3-D map over
//    the P matrices of (K, C), 64-wide boxes of BM rows, 128-byte swizzle,
//    zero fill past K and C. U is shared by the batch: the box's third
//    coordinate is the point p, never n * P + p. TMA needs C % 8 == 0 and a
//    16-byte aligned u; the route rule requires both.
// 2. V (B) gathered and realigned by a producer warpgroup, as the MN-major
//    operand wgmma reads with the transpose-B bit set (matmul_wgmma.cu's
//    row-major B): a stage is 64 channel rows of kBN = 64 t-values, each
//    row 128 bytes, its 16-byte chunk j at chunk j ^ (c % 8). Thread t owns
//    chunk t % 8 of every 16th row, so a warp's loads cover 128 contiguous
//    bytes of each of four rows. For each chunk it loads the aligned 16-byte
//    window holding its first element and, where the row is off 16 bytes,
//    the next one (ld.global.nc.v4; the second is the neighbour lane's
//    first, an L1 hit), and shifts the pair into place by the row's own
//    misalignment (base + c T + t0) mod 8, which changes from row to row
//    when T is odd: a word select and one funnel shift a word
//    (wgmma_bf16.cuh's load_window and realign, which matmul_wgmma.cu's
//    gathered operands share). Each thread
//    issues all of a stage's loads before it shifts and stores any. A
//    window that starts at or past V's end is not loaded (zero); a window
//    that starts before V (a view at an odd offset) lies in the 16-byte
//    block of V's first element, inside its allocation. Values past a
//    row's T are the next row's and feed only output columns >= T, which
//    are never stored. Rows c >= C are zero: A's zero fill alone would not
//    do, as 0 x NaN is NaN.
// 3. Short rows packed. Where T < kPackT (64) and there is more than one
//    image (resnet18's 512-channel layers: T = 9, 4, 1), a tile's columns
//    run over the N T pairs (image, t), gathered element by element (V is
//    small there). Unpacked, each image would read all of U[p] (512 KB a
//    point) for at most 9 useful columns of a 64-wide tile; packed, U[p] is
//    read once for all images.
// 4. Proxy order: the producers' stores are generic-proxy writes that
//    wgmma reads through the async proxy, so every producer thread runs
//    fence.proxy.async.shared::cta after its stores, and only then does its
//    warp arrive on the stage's full barrier. The full barrier counts the
//    four producer warps and thread 0's arrival that carries U's TMA bytes.
// 5. Warp specialisation and a persistent grid: warpgroup 0 produces,
//    warpgroups 1..BM/64 consume, each running m64n64k16 wgmma on its
//    64-row slab of K. A ring of kStages stages with a full and an empty
//    mbarrier each, no __syncthreads() in the loop; a consumer keeps one
//    stage's group in flight while it waits for the next and frees each
//    stage once read. As many CTAs as the card holds walk the output tiles
//    (K tiles fastest, then column tiles, images, points: CTAs
//    running together share V[n, p]'s tile and U[p] through L2). The ring
//    runs across tiles: on the 64-channel layers C is one 64-deep stage,
//    and the producer gathers the next tiles while the consumers store
//    this one.
// 6. The epilogue: no bias, residual or ReLU (M lives in the transform
//    domain). Each consumer warp passes its 16 rows of K through 4.5 KB of
//    staging rows in shared memory, 64 columns a pass; a lane then takes two
//    neighbouring t of one row, so a warp instruction stores 128 contiguous
//    bytes of a row of M as 4-byte bf16 pairs, 2-byte stores only on a row
//    whose start is off 4 bytes (T odd; packed tiles store element by
//    element). One bf16 rounding, at the store.
// 7. Accuracy: every tile sums all of C in its one fp32 accumulator. A
//    second accumulator summing runs of 256 channels from zero
//    (matmul_wgmma.cu's point 5) left the largest error of resnet18's
//    point-GEMMs unchanged (C <= 512), and at C = 512 left about half as
//    many outputs more than half a bf16 spacing from the exact product
//    (tools/err_wino_bf16.py), but its registers (148 a thread against 80)
//    held a 64 x 64 CTA to one an SM. C is never split and nothing is
//    added atomically: two calls give bit-identical outputs.
//
// The tiles (kernels/winograd/winograd.WGMMA_TILES, chosen by
// ops.wgmma_plan): one or two consumer warpgroups (BM 64 or 128) on kBN =
// 64 t-values, BK 64 (one 128-byte swizzle row of U), kStages = 4. At 80-87
// registers a thread and 85 KB of shared memory, two 64 x 64 CTAs share an
// SM, two producers gathering at once; 128- and 256-wide tiles held one CTA
// an SM and ran slower on every resnet18 layer (tools/ab_wino_bf16.py
// --tiles, PERF.md section 6).
#include <cuda_bf16.h>

#include <atomic>

#include "wgmma_bf16.cuh"

namespace {

using rt::bf::bf16;

// Floats in a row of a consumer warp's staging rows for the epilogue: 64
// columns and 8 of padding, so the fragment's 8-byte writes (8 rows x 4
// column pairs a half warp) and the row reads (64 columns) both hit 32 banks.
constexpr int kStageRow = 72;

// Stages in the ring.
constexpr int kStages = 4;

// t-values (columns) a tile: one 128-byte swizzle row of V, one box
constexpr int kBN = 64;

// Rows of V shorter than this many t-values (one 64-wide box) are packed:
// with more than one image, a tile's columns run over (image, t) pairs, so
// U[p] is read once for all images (kernels/winograd/winograd.WGMMA_PACK_T).
constexpr int kPackT = 64;

// Shape of one instantiated tile.
template <int BM>
struct WinoTile {
  static constexpr int S = kStages;
  static constexpr int BK = 64;                     // one swizzle row of U
  static constexpr int kConsumers = BM / 64;        // warpgroups of wgmma
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kABytes = BM * BK * 2;       // A stage: BM rows of BK
  static constexpr int kBBytes = BK * kBN * 2;      // B stage: one box
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the producer's gather: kChunks 16-byte chunks a row, 128 / kChunks rows
  // a pass of the 128 threads, kPasses passes a stage
  static constexpr int kChunks = kBN / 8;
  static constexpr int kRows = 128 / kChunks;
  static constexpr int kPasses = BK / kRows;
  // each consumer warp's staging rows for the epilogue: 16 of kStageRow
  // floats
  static constexpr int kStagingBytes = kConsumers * 4 * 16 * kStageRow * 4;
  // 1,024 bytes of alignment slack, the ring, the staging rows, the 2 S
  // barriers
  static constexpr int kSmemBytes =
      1024 + S * kStageBytes + kStagingBytes + 2 * S * 8;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

// One stage of this warpgroup's slab: acc (+)= A (64 x 64, K-major at `a`)
// @ B (64 x kBN, MN-major at `b`), four 16-deep wgmma steps, summed from
// zero where `Fresh`, committed as one group.
template <bool Fresh>
__device__ __forceinline__ void stage_mma(float (&acc)[kBN / 2],
                                          const uint8_t* a, const uint8_t* b) {
  if constexpr (Fresh)
    rt::wg::fence_regs_overwritten(acc);
  else
    rt::wg::fence_regs(acc);
  rt::wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    rt::wg::wgmma<kBN, 1>(acc, rt::wg::desc(a + 32 * kk, 16, 1024),
                         rt::wg::desc(b + 2048 * kk, 8192, 1024),
                         kk > 0 || !Fresh);
  rt::wg::wgmma_commit();
}

// The epilogue of one consumer warp: its 16 rows m0 .. m0 + 15 of the
// tile's columns j0 .. j0 + kBN - 1, through its staging rows `buf` in
// shared memory: the fragment's sums go in, then each lane reads the two
// columns j0 + 2 lane (+ 1) of 8 rows before it stores any of them, twice
// (the warp is one of four on its SM quadrant: a read issued between each
// two stores left it waiting on each). Unpacked, the columns are t of
// M[n, p] (K, T), at `o` elements, so each warp instruction stores 128
// contiguous bytes of one row; out's start is 16-byte aligned, so a pair
// lies on a 4-byte boundary where o + m T + t is even. Packed, column j is
// t = j % T of image n = j / T, at o + (n P K) T + t, stored element by
// element. Outputs past K or the columns are never stored.
template <bool Packed>
__device__ __forceinline__ void finish_tile(const float (&acc)[kBN / 2],
                                            uint32_t buf, int m0, int j0,
                                            int K, int T, int cols,
                                            long long PKT, long long o,
                                            bf16* __restrict__ out) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int rows = min(16, K - m0);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                       buf + 4 * ((g + 8 * h) * kStageRow + 8 * j + 2 * q)),
                   "f"(acc[4 * j + 2 * h]), "f"(acc[4 * j + 2 * h + 1])
                   : "memory");
  __syncwarp();
  const int t = j0 + 2 * lane;
  const bool two = t + 1 < cols;
  // each of the two columns at its own image's M[n, p] (packed), or the
  // pair at row m0's t
  long long at[2];
  if constexpr (Packed) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = (t + e) / T;
      at[e] = o + n * PKT + (t + e - n * T) + (long long)m0 * T;
    }
  } else {
    at[0] = o + (long long)m0 * T + t;
    at[1] = at[0] + 1;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float2 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(v[r].x), "=f"(v[r].y)
                   : "r"(buf + 4 * ((8 * half + r) * kStageRow + 2 * lane))
                   : "memory");
    if (t >= cols) continue;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = 8 * half + r;
      if (row >= rows) break;
      const long long e0 = at[0] + (long long)row * T;
      const long long e1 = at[1] + (long long)row * T;
      if (!Packed && two && (e0 & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + e0) =
            __floats2bfloat162_rn(v[r].x, v[r].y);
      } else {
        out[e0] = __float2bfloat16_rn(v[r].x);
        if (two) out[e1] = __float2bfloat16_rn(v[r].y);
      }
    }
  }
  __syncwarp();                      // the rows are read before the next tile
}

// One output tile of the persistent walk: rows [m0, m0 + BM) of K, columns
// [j0, j0 + kBN), of image n at point p (packed: of every image, n = 0).
struct Unit {
  int m0, j0, n, p;
};

// grid (CTAs): a persistent walk over the output tiles. A tile's columns
// are t of one image, or, Packed (rows shorter than kPackT, more than one
// image), the N T pairs (n, t) of every image, n slowest. Units are
// numbered with the K tiles fastest, then the column tiles, the images
// (unpacked) and the points; CTA b takes units b, b + gridDim.x, ... Each
// unit walks all of C's 64-deep steps and stores its finished bf16 M.
// Element offsets into V and M are 64-bit.
template <int BM, bool Packed>
__global__ void __launch_bounds__(WinoTile<BM>::kThreads, 1)
    wino_wgmma_kernel(const __grid_constant__ CUtensorMap mapU,
                      const bf16* __restrict__ V, bf16* __restrict__ O, int N,
                      int P, int K, int C, int T) {
  using TL = WinoTile<BM>;
  constexpr int S = TL::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* stagings = smem + S * TL::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stagings + TL::kStagingBytes);
  uint64_t* empty = full + S;

  const int cols = Packed ? N * T : T, imgs = Packed ? 1 : N;
  const int mt = (K + BM - 1) / BM, nt = (cols + kBN - 1) / kBN;
  const int units = mt * nt * imgs * P;
  const int steps = (C + TL::BK - 1) / TL::BK;
  auto unit = [&](int u) {
    Unit v;
    v.m0 = u % mt * BM;
    u /= mt;
    v.j0 = u % nt * kBN;
    u /= nt;
    v.n = u % imgs;
    v.p = u / imgs;
    return v;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      rt::wg::mbar_init(&full[i], 4 + 1);        // producer warps + thread 0
      rt::wg::mbar_init(&empty[i], TL::kConsumers);
    }
    rt::wg::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer warpgroup: U's TMA loads (thread 0) and V's gather,
    // across units, so the next unit's stages fill during this one's
    // epilogue
    const int t = threadIdx.x, lane = t % 32;
    const int q = t % TL::kChunks;               // this thread's chunk of a row
    const int r0 = t / TL::kChunks;              // its first row of a pass
    // V's elements counted from the 16-byte boundary at or below V
    const int vmis = (int)(reinterpret_cast<uintptr_t>(V) / 2 % 8);
    const int4* V16 = reinterpret_cast<const int4*>(V - vmis);
    const unsigned short* vs = reinterpret_cast<const unsigned short*>(V);
    const long long end = vmis + (long long)N * P * C * T;
    if (t == 0) rt::wg::prefetch_map(&mapU);
    int g = 0;                                    // stages produced
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit v = unit(u);
      // unpacked: this thread's chunk at channel 0, from V16; packed: the
      // offset in V of each of its 8 columns at channel 0, -1 past the
      // last image
      const long long z =
          vmis + ((long long)v.n * P + v.p) * C * T + v.j0 + 8 * q;
      long long col[Packed ? 8 : 1];
      if constexpr (Packed) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = v.j0 + 8 * q + e, n = j / T;
          col[e] = j < cols ? ((long long)n * P + v.p) * C * T + (j - n * T) : -1;
        }
      }
      for (int i = 0; i < steps; ++i, ++g) {
        const int st = g % S;
        const int c0 = i * TL::BK;
        rt::wg::mbar_wait(&empty[st], ((g / S) & 1) ^ 1);
        uint8_t* a = smem + st * TL::kStageBytes;
        if (t == 0) {
          rt::wg::mbar_expect_tx(&full[st], TL::kABytes);
          rt::wg::tma_load(a, &mapU, &full[st], c0, v.m0, v.p);
        }
        // every load of the stage (rows c0 + r0 + j kRows, chunk q), then
        // every shift (unpacked: the two windows by the row's
        // misalignment) or pack (packed: element by element, short rows
        // and a small V) and store
        uint4 x[TL::kPasses];
        if constexpr (Packed) {
          uint32_t e8[TL::kPasses][8];
#pragma unroll
          for (int j = 0; j < TL::kPasses; ++j) {
            const int c = c0 + r0 + j * TL::kRows;
            const long long ct = (long long)c * T;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              e8[j][e] = c < C && col[e] >= 0 ? __ldg(vs + col[e] + ct) : 0u;
          }
#pragma unroll
          for (int j = 0; j < TL::kPasses; ++j)
            x[j] = make_uint4(e8[j][0] | e8[j][1] << 16, e8[j][2] | e8[j][3] << 16,
                              e8[j][4] | e8[j][5] << 16, e8[j][6] | e8[j][7] << 16);
        } else {
          int4 lo[TL::kPasses], hi[TL::kPasses];
          int mis[TL::kPasses];
#pragma unroll
          for (int j = 0; j < TL::kPasses; ++j) {
            const int c = c0 + r0 + j * TL::kRows;
            rt::wg::load_window(lo[j], hi[j], mis[j], V16, z + (long long)c * T,
                                end, c < C);
          }
#pragma unroll
          for (int j = 0; j < TL::kPasses; ++j)
            x[j] = rt::wg::realign(lo[j], hi[j], mis[j]);
        }
        const uint32_t bs = rt::wg::smem_addr(a + TL::kABytes);
#pragma unroll
        for (int j = 0; j < TL::kPasses; ++j) {
          const int r = r0 + j * TL::kRows;
          rt::wg::st_shared_v4(bs + r * 128 + (((q & 7) ^ (r & 7)) << 4), x[j]);
        }
        // the stores reach the async proxy before the stage is published
        rt::wg::fence_async_shared();
        __syncwarp();
        if (lane == 0) rt::wg::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // a consumer: rows [64 c, 64 c + 64) of each unit's K tile
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  // this warp's staging rows
  const uint32_t staging =
      rt::wg::smem_addr(stagings + (4 * c + t / 32) * 16 * kStageRow * 4);
  float acc[kBN / 2];
  int g = 0, freed = 0;                           // stages used, released
  auto free_to = [&](int j) {
    for (; freed < j; ++freed)
      if (t == 0) rt::wg::mbar_arrive(&empty[freed % S]);
  };
  const long long KT = (long long)K * T;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit v = unit(u);
    for (int i = 0; i < steps; ++i, ++g) {
      const int st = g % S;
      rt::wg::mbar_wait(&full[st], (g / S) & 1);
      const uint8_t* a = smem + st * TL::kStageBytes;
      if (i == 0)
        stage_mma<true>(acc, a + c * 64 * 128, a + TL::kABytes);
      else
        stage_mma<false>(acc, a + c * 64 * 128, a + TL::kABytes);
      rt::wg::wgmma_wait<1>();                    // stage g - 1 is done
      free_to(g);
    }
    rt::wg::wgmma_wait<0>();
    rt::wg::fence_regs(acc);
    free_to(g);

    // the epilogue, each warp its 16 rows of the slab
    const int m0w = v.m0 + 64 * c + 16 * (t / 32);
    finish_tile<Packed>(acc, staging, m0w, v.j0, K, T, cols, P * KT,
                        ((long long)v.n * P + v.p) * KT, O);
  }
}

template <int BM, bool Packed>
int launch_tile(const bf16* U, const bf16* V, bf16* O, int N, int P, int K,
                int C, int T, cudaStream_t stream) {
  using TL = WinoTile<BM>;
  auto* kernel = wino_wgmma_kernel<BM, Packed>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mu = {};
  const int err = rt::wg::make_map(&mu, U, K, C, P, (long long)K * C, 64, BM);
  if (err != 0) return err;
  const long long cols = Packed ? (long long)N * T : T;
  const long long units = (long long)((K + BM - 1) / BM) * ((cols + kBN - 1) / kBN) *
                          (Packed ? 1 : N) * P;
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // as many CTAs as the card holds at once (asked once per instantiation),
  // each walking its share of the units
  static std::atomic<int> most{0};
  int fit = most.load();
  if (fit == 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, TL::kThreads, TL::kSmemBytes);
    if (q == cudaSuccess) q = cudaGetDevice(&dev);
    if (q == cudaSuccess)
      q = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (q != cudaSuccess) return (int)q;
    fit = per_sm * sms;
    if (fit == 0) return (int)cudaErrorInvalidConfiguration;
    most.store(fit);
  }
  const int grid = units < fit ? (int)units : fit;
  kernel<<<grid, TL::kThreads, TL::kSmemBytes, stream>>>(mu, V, O, N, P, K,
                                                          C, T);
  return (int)cudaGetLastError();
}

// Every BM ops.wgmma_plan may choose (winograd.WGMMA_TILES: BM x kBN).
#define RT_FOR_EACH_WINO_WGMMA_BM(X) X(64) X(128)

}  // namespace

// U (P, K, C), V (N, P, C, T) bf16 -> O (N, P, K, T) bf16, all contiguous
// (V at any element offset), C % 8 == 0 and U 16-byte aligned (U's TMA
// map), O 16-byte aligned, on the tile of bm rows of K by kBN columns. One
// image is N = 1. Returns cudaGetLastError() after the launch; an unknown
// bm or operands TMA cannot address return cudaErrorInvalidValue without
// launching.
extern "C" int rt_winograd_wgmma_bf16(const bf16* U, const bf16* V, bf16* O,
                                      int N, int P, int K, int C, int T,
                                      int bm, cudaStream_t stream) {
  if (N < 1 || P < 1 || K < 1 || C < 1 || T < 1 || C % 8 != 0 ||
      reinterpret_cast<uintptr_t>(U) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(O) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // rows shorter than one box, more than one image: columns packed
  const bool packed = N > 1 && T < kPackT;
#define RT_LAUNCH(BM_)                                                        \
  if (bm == BM_)                                                               \
    return packed ? launch_tile<BM_, true>(U, V, O, N, P, K, C, T, stream)     \
                  : launch_tile<BM_, false>(U, V, O, N, P, K, C, T, stream);
  RT_FOR_EACH_WINO_WGMMA_BM(RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
