// bf16 matmul with a fused epilogue, C = relu?(A @ B + bias + residual), on
// Hopper's warpgroup MMA: the wgmma route of rt_matmul_bf16 /
// rt_matmul_batch_bf16 (matmul.cu), for bf16 operands of at least 64 rows
// of A. fp32 accumulation; bias and residual each read as fp32 or bf16; the
// output stored once as fp32 or bf16.
//
// Replaces, for those calls, the same two TPU kernels as matmul.cu:
// `matmul` (src/repro/kernels/matmul/matmul.py:140) and `matmul_batch`
// (:87), the epilogue `_finish` (:33) applied once to the finished fp32 sum.
//
// Which calls take it (kernels/matmul/ops.route decides before anything
// launches): bf16 operands with M >= 64, whatever their alignment. Each
// operand is loaded by TMA where TMA can address it (K, or N, a multiple of
// 8, so every row starts on a 16-byte boundary; a 16-byte aligned base and
// a batch stride that is a multiple of 8 elements), else gathered by the
// producer warpgroup (matmul.loaders decides, per call). Both by TMA: every
// GEMM site of the LM configs (M = 5,120-65,536, K and N 128-16,384;
// core/autotune.site_shapes) and the resnet18 convs as GEMMs whose K = C f f
// and N = oh ow are both multiples of 8 (3 of 20 at 224 x 224), on
// matmul_wgmma_kernel. The other 17 (N = oh ow odd or 4 mod 8; conv0 also
// K = 147) and the autotune's sampled GEMMs off 8 run matmul_gather_kernel.
// fp32 and M < 64 run matmul.cu's mma.sync kernels, unchanged; a call that
// names this route on operands it cannot take is refused in matmul.py,
// never rerouted.
//
// What bounds it on the H100. The LM sites are bound by operations at the
// bf16 rate (989 TFLOP/s): one chatglm3_6b layer's five sites are 1.26
// TFLOP, 1.28 ms, against 0.41 ms of 2-byte traffic. A wide-output site
// such as (65,536, 256, 4,096) writes 537 MB of bf16 for 137 GFLOP and is
// close to bound by its bytes. mma.sync from ldmatrix fragments (matmul.cu's
// bf16 tiles) reaches at most a quarter of the bf16 rate there; only wgmma
// reaches the tensor cores' full rate. Measured on the card, the rate of
// loads from L2 into shared memory bounds a 128 x 128 tile before the
// tensor cores do (a kernel that skips either operand's loads runs the
// same MMAs faster), and the epilogue's stores cannot hide under the next
// tile's MMAs when every SM stores at once.
//
// What the design does:
// 1. TMA loads (wgmma_bf16.cuh). A and B tiles arrive by cp.async.bulk.tensor
//    from tensor maps encoded on the host per call (3-D: columns, rows,
//    batch; an operand broadcast over the batch gets a batch of one and
//    coordinate 0), 128-byte swizzled, zero-filled past every ragged edge.
//    A is K-major, B MN-major (wgmma's transpose-B bit), so neither operand
//    is transposed or padded anywhere.
// 2. Clusters of two CTAs on neighbouring M tiles share B: each loads half
//    of every B box and multicasts it into both CTAs' shared memory, so a
//    128 x 256 tile reads 32 KB a stage from L2 instead of 48.
// 3. A ring of S stages with a full and an empty mbarrier each. Warpgroup 0
//    is the producer: it gives back its registers (setmaxnreg) and one of
//    its threads keeps the ring's TMA loads in flight; the full barrier
//    counts each stage's bytes, the empty barrier the releases of the
//    consumers of both CTAs of the pair. Warpgroups 1..BM/64 are consumers
//    with raised registers; each runs m64nBNk16 wgmma on its 64-row slab,
//    keeps a stage's MMAs in flight while it waits for the one before
//    (wgmma.wait_group 1), and frees each stage as soon as it is read. No
//    __syncthreads() in the main loop.
// 4. Persistent: one cluster per pair of SMs walks the output tiles, so
//    the producer loads the next tile's stages while the consumers finish
//    the last one, and no tile waits for a new CTA's first loads.
// 5. Accuracy. The tensor cores' own adds truncate. For BN <= 128 each run
//    of kPromoteSteps stages (256 deep) is summed from zero in a second
//    accumulator and added to the running sum with an fp32 FADD, which
//    rounds to nearest: the truncation stays inside one partial. The
//    partial is read only after wgmma.wait_group 0: reading one while
//    another group is in flight makes ptxas serialise every wgmma of the
//    kernel. BN = 256 has no room for a second accumulator (128 registers a
//    thread each) and sums all of K in one; at (65,536, 16,384, 1,024),
//    the longest K of the LM sites, it stays within 2.3e-5 of the largest
//    |result| (chip_smoke.py phase 14 (b) and tools/wgmma_tiles.py on an
//    H100 SXM at 700 W), against the 1e-4 it is held to.
// 6. The epilogue: bias -> residual -> ReLU on the fp32 sum where the call
//    has any, in registers. With BN = 256 a bf16 output goes through
//    shared memory, 64 rows by 128 columns a consumer at a time, and
//    leaves by TMA store, which drains while the next tile's MMAs run
//    (stored from registers, each tile's stores wait on the card's write
//    bandwidth, as every SM finishes its tile at about the same time).
//    Narrower tiles have no registers to spare for the staging (their
//    promotion's second accumulator): they store from registers, 16 bytes
//    a lane after a 4 x 4 transpose over each quad of lanes. fp32 (an fp32
//    output, a split's partial) is stored from registers, 16 bytes a lane
//    after neighbouring lanes swap a pair.
// 7. Deterministic split-K, only where the output tiles cannot give each of
//    the 132 SMs a CTA (a wgmma CTA fills an SM by itself): each split
//    stores its raw fp32 partial to the caller's workspace, and
//    epilogue.cuh's splitk_reduce adds them in order and applies the
//    epilogue once. Two calls give bit-identical outputs.
//
// 8. Gathered operands (matmul_gather_kernel). A row that starts off 16
//    bytes is read by the producer warpgroup as aligned 16-byte windows
//    shifted by the row's own misalignment (base + batch stride + row ld +
//    column) mod 8, which changes from row to row when K or N is odd
//    (wgmma_bf16.cuh's load_window and realign, winograd_wgmma.cu's V
//    gather), into the same 128-byte-swizzled stage TMA writes: B
//    MN-major (thread t owns chunk t % (BN / 8) of every (1,024 / BN)-th
//    K-row), A K-major (chunk t % 8 of every 16th row). Every load of a
//    stage is issued before any is shifted. An operand TMA can address
//    still comes by TMA into the same ring (A in 19 of resnet18's 20). A
//    gathered B's K-rows at or past K, and a gathered A's columns at or
//    past K, are written as zeros (0 x NaN is NaN); a window at or past the
//    operand's end is not loaded; values a row reads past N feed only
//    columns never stored. Each producer thread fences its stores into the
//    async proxy before its warp arrives on the full barrier. No cluster,
//    no multicast, no setmaxnreg; tiles walk with the M tiles fastest, so
//    CTAs running together share B's tile through L2. Where A is
//    broadcast over more than one entry and N < kPackN, B's short rows are
//    packed: a tile's columns run over the (entry, n) pairs, gathered
//    element by element, so A (512 x 2,304-4,608 in resnet18's last
//    layers, N = 49-1) is read once for all entries. C's rows may be off
//    16 bytes: each consumer warp passes its rows through staging rows in
//    shared memory, 64 columns at a time, and a warp instruction then
//    stores 64 columns of one row as 4-byte bf16 (8-byte fp32) pairs,
//    element by element where a pair starts on an odd element or the tile
//    is packed; the residual is read element by element, coalesced the
//    same way. Split-K as in point 7. What bounds the gathered tiles is
//    not the loads in flight: in copies of this kernel timed by
//    tools/ab_matmul_batch_bf16.py on resnet18's layers, asking L2 for B's
//    rows 4 or 8 stages ahead cost the pass 9-12%, and a second set of
//    registers loading the next stage while this one is shifted gained
//    1.5% (PERF.md section 6). Every gathered tile sums all of K in one
//    accumulator: on resnet18's 20 GEMMs at b = 8 point 5's promotion left
//    the largest error unchanged and about half as many outputs more than
//    half a bf16 spacing off, but its registers (128 a thread and ~1 KB of
//    spills at two 64 x 64 CTAs an SM, against 96 and none) cost the pass
//    16% (tools/err_matmul_bf16.py, tools/ab_matmul_batch_bf16.py).
//
// The tiles (kernels/matmul/matmul.WGMMA_TILES, chosen per variant by
// ops.wgmma_plan): BM 64 or 128 (one or two consumer warpgroups), BN 64,
// 128 or 256, BK 64 (one 128-byte swizzle row of A), S = 3, 4 or 8 stages.
// Gathered (matmul.WGMMA_GATHER_TILES): BM 64 (two CTAs an SM) or 128 by
// BN 64, kGatherStages deep (RT_FOR_EACH_GATHER_TILE); a gathered A only
// on 64 x 64.
#include <cuda_bf16.h>

#include <atomic>

#include "epilogue.cuh"
#include "wgmma_bf16.cuh"

namespace {

using rt::bf::bf16;
using rt::bf::pack_bf16;
using rt::tc::Ep;

// Shape of one instantiated tile.
template <int BM, int BN, int S>
struct WgTile {
  static constexpr int BK = 64;                     // one swizzle row of A
  static constexpr int kConsumers = BM / 64;        // warpgroups of wgmma
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kABytes = BM * BK * 2;       // A stage: BM rows of BK
  static constexpr int kBBytes = BK * BN * 2;       // B stage: BN / 64 boxes
  static constexpr int kStageBytes = kABytes + kBBytes;
  // BN = 256 stores a bf16 output through shared memory: each consumer
  // stages its 64 rows 128 columns at a time, as 64 x 64 boxes of 128-byte
  // rows. Narrower tiles store from registers: their promotion's second
  // accumulator leaves no registers for the staging (ptxas spills the main
  // loop's sums at 168 registers a thread).
  static constexpr bool kTmaStore = BN == 256;
  static constexpr int kCCols = 128;
  static constexpr int kCBytes = kTmaStore ? 64 * kCCols * 2 : 0;
  // 1,024 bytes of alignment slack, the ring, the consumers' staging, then
  // the ring's 2 S barriers
  static constexpr int kSmemBytes =
      1024 + S * kStageBytes + kConsumers * kCBytes + 2 * S * 8;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma widths");
  // a stage accumulator beside the running sum where registers allow
  static constexpr bool kPromote = BN <= 128;
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

// Registers a thread of the producer keeps and a consumer takes: 128 x
// (40 + kConsumers x 232) fits the 65,536 of an SM.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// 64-deep stages summed into one partial before it is added to the running
// sum (the promotion interval)
constexpr int kPromoteSteps = 4;

// One stage of this warpgroup's slab: p (+)= A (64 x 64, at `a`) @ B (64 x
// BN, at `b`), four 16-deep wgmma steps, summed from zero where `Fresh`,
// committed as one group.
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
    rt::wg::wgmma<BN>(p, rt::wg::desc(a + 32 * kk, 16, 1024),
                      rt::wg::desc(b + 2048 * kk, 8192, 1024),
                      kk > 0 || !Fresh);
  rt::wg::wgmma_commit();
}

// Lane q of each quad holds x[0..3]; afterwards it holds x_k[q] in x[k],
// lane k's element q (a 4 x 4 transpose over the quad, three shuffles).
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4]) {
  const int q = threadIdx.x % 4, base = threadIdx.x % 32 - q;
  uint32_t y[4] = {x[0], x[1], x[2], x[3]};
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const int give = (q + r) & 3, from = (q - r) & 3;
    const uint32_t sent = give == 0 ? x[0] : give == 1 ? x[1] : give == 2 ? x[2] : x[3];
    const uint32_t got = __shfl_sync(0xffffffffu, sent, base + from);
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] = from == k ? got : y[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = y[k];
}

// One output tile of the persistent walk: rows [m0, m0 + BM), columns
// [n0, n0 + BN) of batch entry z, K split s, whose 64-deep steps are
// [first, first + steps).
struct Unit {
  int m0, n0, z, s, first, steps;
};

// grid (1, clusters x pair): a persistent walk over the output tiles. Units
// are numbered with N fastest, then pairs of M tiles, then batch entries,
// then K splits; cluster c takes units c, c + clusters, ... and its two CTAs
// (rank 0 and 1) the two M tiles of each. Split s walks the 64-deep steps
// [s * per, (s + 1) * per) of K; with split == 1 a unit stores the finished
// output (fp32, or bf16 where out_bf16), else its raw partial sum into
// ws[s][z]. a_bat / b_bat: the operand's map has a batch dimension (else it
// is one matrix, broadcast).
template <int BM, int BN, int S>
__global__ void __launch_bounds__(WgTile<BM, BN, S>::kThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap mapA,
                        const __grid_constant__ CUtensorMap mapB,
                        const __grid_constant__ CUtensorMap mapC, Ep bias,
                        Ep res, void* __restrict__ C, float* __restrict__ ws,
                        int M, int N, int K, int relu, int split, int Bn,
                        int a_bat, int b_bat, int out_bf16) {
  using T = WgTile<BM, BN, S>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staged = smem + S * T::kStageBytes;     // the consumers' C boxes
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staged + T::kConsumers * T::kCBytes);
  uint64_t* empty = full + S;

  // a pair of CTAs on neighbouring M tiles shares its B tiles: each loads
  // one half of every B box and multicasts it to both
  const uint32_t rank = rt::wg::cluster_rank(), pair = rt::wg::cluster_size();
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int mp = (mt + pair - 1) / pair;
  const int units = mp * nt * Bn * split;
  const int clusters = gridDim.y / pair, cl = blockIdx.y / pair;
  const int all = (K + T::BK - 1) / T::BK;
  const int per = (all + split - 1) / split;
  auto unit = [&](int u) {
    Unit w;
    w.n0 = u % nt * BN;
    u /= nt;
    w.m0 = (u % mp * (int)pair + (int)rank) * BM;
    u /= mp;
    w.z = u % Bn;
    w.s = u / Bn;
    w.first = w.s * per;
    w.steps = min(all, w.first + per) - w.first;
    return w;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      rt::wg::mbar_init(&full[i], 1);
      rt::wg::mbar_init(&empty[i], T::kConsumers * pair);
    }
    rt::wg::mbar_init_fence();
  }
  if (pair > 1)
    rt::wg::cluster_sync();       // the peer's barriers exist before use
  else
    __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: one thread keeps the ring's loads in flight, across
    // units, so the next unit's stages load during this one's epilogue
    rt::wg::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      rt::wg::prefetch_map(&mapA);
      rt::wg::prefetch_map(&mapB);
      int g = 0;                                    // stages issued
      for (int u = cl; u < units; u += clusters) {
        const Unit w = unit(u);
        const int za = a_bat ? w.z : 0, zb = b_bat ? w.z : 0;
        for (int i = 0; i < w.steps; ++i, ++g) {
          const int st = g % S;
          rt::wg::mbar_wait(&empty[st], ((g / S) & 1) ^ 1);
          rt::wg::mbar_expect_tx(&full[st], T::kStageBytes);
          uint8_t* a = smem + st * T::kStageBytes;
          const int k0 = (w.first + i) * T::BK;
          rt::wg::tma_load(a, &mapA, &full[st], k0, w.m0, za);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            // box j of B: 64 K-rows by 64 columns, in two halves of 32 rows
            uint8_t* b = a + T::kABytes + 8192 * j;
            if (pair > 1) {
              rt::wg::tma_load_multicast(b + 4096 * rank, &mapB, &full[st],
                                         w.n0 + 64 * j, k0 + 32 * rank, zb, 3);
            } else {
              rt::wg::tma_load(b, &mapB, &full[st], w.n0 + 64 * j, k0, zb);
              rt::wg::tma_load(b + 4096, &mapB, &full[st], w.n0 + 64 * j,
                               k0 + 32, zb);
            }
          }
        }
      }
      // stay until both CTAs' consumers have freed every stage: the peer
      // arrives on this CTA's barriers and must find them
      if (pair > 1)
        for (int i = max(0, g - S); i < g; ++i)
          rt::wg::mbar_wait(&empty[i % S], (i / S) & 1);
    }
    return;
  }

  // a consumer: rows [64 c, 64 c + 64) of each unit's tile
  rt::wg::regs_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int t = threadIdx.x % 128, q = t % 4;
  constexpr int R = BN / 2;
  float acc[R], p[T::kPromote ? R : 1];
  int g = 0, freed = 0;                           // stages used, released
  auto free_to = [&](int j) {
    for (; freed < j; ++freed)
      if (t == 0) {
        rt::wg::mbar_arrive(&empty[freed % S]);
        if (pair > 1) rt::wg::mbar_arrive_cluster(&empty[freed % S], rank ^ 1);
      }
  };
  for (int u = cl; u < units; u += clusters) {
    const Unit w = unit(u);
    for (int i = 0; i < w.steps; ++i, ++g) {
      const int st = g % S;
      rt::wg::mbar_wait(&full[st], (g / S) & 1);
      const uint8_t* a = smem + st * T::kStageBytes;
      if constexpr (T::kPromote) {
        // a partial of kPromoteSteps stages, added once they are all done
        if (i % kPromoteSteps == 0)
          stage_mma<BN, true>(p, a + c * 64 * 128, a + T::kABytes);
        else
          stage_mma<BN, false>(p, a + c * 64 * 128, a + T::kABytes);
        if (i % kPromoteSteps == kPromoteSteps - 1 || i + 1 == w.steps) {
          rt::wg::wgmma_wait<0>();
          rt::wg::fence_regs(p);
          if (i < kPromoteSteps) {
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = p[r];
          } else {
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] += p[r];
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

    // the epilogue: this thread holds rows r0 and r0 + 8, columns n0 + 8 j
    // + 2 q (+1) of the slab
    const int r0 = w.m0 + 64 * c + 16 * (t / 32) + t % 32 / 4;
    const long long MN = (long long)M * N;
    const long long base =
        split == 1 ? w.z * MN : (w.s * (long long)Bn + w.z) * MN;
    if (split == 1 && (bias || res || relu)) {
      // bias -> residual -> ReLU on the fp32 sum (epilogue.cuh's `finish`),
      // the bias read once per row
      const Ep rz = res.offset(w.z * MN);
      float bz[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (bias && r0 + 8 * h < M) bz[h] = bias[r0 + 8 * h];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r0 + 8 * h, n = w.n0 + 8 * j + 2 * q;
          float& v0 = acc[4 * j + 2 * h];
          float& v1 = acc[4 * j + 2 * h + 1];
          if (bias) {
            v0 += bz[h];
            v1 += bz[h];
          }
          if (rz && m < M && n < N) {
            const long long idx = (long long)m * N + n;
            v0 += rz[idx];
            v1 += rz[idx + 1];
          }
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
        }
    }
    if (T::kTmaStore && split == 1 && out_bf16) {
      // through shared memory: this warpgroup's 64 rows, kCCols columns at
      // a time, written into 64 x 64 boxes in TMA's 128-byte swizzle (the
      // 16-byte chunk of a row XOR the row's index in its 8-row atom, so a
      // warp's writes hit 32 banks) and stored by TMA, clipped at M and N.
      // The store drains while the next tile's MMAs run; the staging is
      // reused once the store has read it.
      uint8_t* box0 = staged + c * T::kCBytes;
      // this lane's rows 16 warp + g (+8) at its column pair 2 q; the
      // 16-byte chunk j of a row lands at chunk j ^ g, g = row % 8, and
      // bits 4-6 of a row's address are zero (128-byte rows, 1,024-byte
      // aligned boxes), so chunk j's address is `mine ^ (j << 4)`
      const uint32_t g = t % 32 / 4;
      const uint32_t mine =
          rt::wg::smem_addr(box0 + (t / 32 * 16 + g) * 128 + q * 4) | g << 4;
#pragma unroll
      for (int h = 0; h < BN / T::kCCols; ++h) {
        if (t == 0) rt::wg::bulk_wait_read<0>();
        rt::wg::named_sync(2 + c, 128);
#pragma unroll
        for (int j = 0; j < T::kCCols / 8; ++j) {
          const uint32_t at = (mine ^ (j % 8) << 4) + j / 8 * 8192;
          const int a = 4 * (j + h * T::kCCols / 8);
          rt::wg::st_shared(at, pack_bf16(acc[a], acc[a + 1]));
          rt::wg::st_shared(at + 1024, pack_bf16(acc[a + 2], acc[a + 3]));
        }
        rt::wg::fence_async_shared();
        rt::wg::named_sync(2 + c, 128);
        if (t == 0) {
#pragma unroll
          for (int b = 0; b < T::kCCols / 64; ++b)
            rt::wg::tma_store(&mapC, box0 + 8192 * b,
                              w.n0 + h * T::kCCols + 64 * b, w.m0 + 64 * c, w.z);
          rt::wg::bulk_commit();
        }
      }
    } else if (split == 1 && out_bf16) {
      // per pair of 8-column blocks, a quad transpose gives each lane one
      // 8-element row segment: 16-byte stores
#pragma unroll
      for (int jp = 0; jp < BN / 16; ++jp) {
        uint32_t x[4] = {pack_bf16(acc[8 * jp], acc[8 * jp + 1]),
                         pack_bf16(acc[8 * jp + 2], acc[8 * jp + 3]),
                         pack_bf16(acc[8 * jp + 4], acc[8 * jp + 5]),
                         pack_bf16(acc[8 * jp + 6], acc[8 * jp + 7])};
        quad_transpose(x);
        const int m = r0 + 8 * (q & 1), n = w.n0 + 16 * jp + 8 * (q >> 1);
        if (m < M && n < N)
          *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + base +
                                    (long long)m * N + n) =
              make_uint4(x[0], x[1], x[2], x[3]);
      }
    } else {
      // fp32 (the output, or a split's partial): neighbouring lanes swap a
      // pair, each then holds 4 columns of one row: 16-byte stores
      float* out = split == 1 ? static_cast<float*>(C) : ws;
      const bool even = (q & 1) == 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float a0 = acc[4 * j], a1 = acc[4 * j + 1];
        const float b0 = acc[4 * j + 2], b1 = acc[4 * j + 3];
        const float g0 = __shfl_xor_sync(0xffffffffu, even ? b0 : a0, 1);
        const float g1 = __shfl_xor_sync(0xffffffffu, even ? b1 : a1, 1);
        const int m = r0 + (even ? 0 : 8), n = w.n0 + 8 * j + 2 * (q & ~1);
        if (m < M && n < N)
          *reinterpret_cast<float4*>(out + base + (long long)m * N + n) =
              even ? make_float4(a0, a1, g0, g1) : make_float4(g0, g1, b0, b1);
      }
    }
  }
  if (T::kTmaStore && t == 0) rt::wg::bulk_wait<0>();   // the stores landed
}

template <int BM, int BN, int S>
int launch_tile(const bf16* A, const bf16* B, Ep bias, Ep res, void* C,
                float* ws, int Bn, int M, int N, int K, int relu, long long sA,
                long long sB, int split, int out_bf16, cudaStream_t stream) {
  using T = WgTile<BM, BN, S>;
  auto* kernel = matmul_wgmma_kernel<BM, BN, S>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int a_bat = Bn > 1 && sA != 0, b_bat = Bn > 1 && sB != 0;
  CUtensorMap ma, mb, mc = {};
  int err = rt::wg::make_map(&ma, A, M, K, a_bat ? Bn : 1, sA, 64, BM);
  if (err == 0) err = rt::wg::make_map(&mb, B, K, N, b_bat ? Bn : 1, sB, 64, 32);
  // a bf16 output is stored by TMA in 64 x 64 boxes (else the map is unused)
  if (err == 0 && T::kTmaStore && out_bf16 && split == 1)
    err = rt::wg::make_map(&mc, C, M, N, Bn, (long long)M * N, 64, 64);
  if (err != 0) return err;
  // clusters of two M tiles where there are two; a CTA past M (M tiles
  // odd) loads its half of B and stores nothing
  const long long mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int pair = mt >= 2 ? 2 : 1;
  const long long units = (mt + pair - 1) / pair * nt * Bn * split;
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = pair;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  // as many clusters as the card holds at once (asked once per
  // instantiation and cluster size), each walking its share of the units
  static std::atomic<int> most[3];
  int fit = most[pair].load();
  if (fit == 0) {
    cfg.gridDim = dim3(1, pair, 1);
    const cudaError_t q = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (q != cudaSuccess) return (int)q;
    if (fit == 0) return (int)cudaErrorInvalidConfiguration;
    most[pair].store(fit);
  }
  const long long clusters = units < fit ? units : fit;
  cfg.gridDim = dim3(1, (unsigned)(clusters * pair), 1);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, ma, mb, mc, bias, res, C,
                                     ws, M, N, K, relu, split, Bn, a_bat,
                                     b_bat, out_bf16);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  return rt::tc::launch_splitk_reduce(ws, bias, res, C, M, N, split,
                                      (long long)Bn * M * N, relu, stream,
                                      out_bf16);
}

// ---------------------------------------------------------------------------
// Operands TMA cannot address: gathered by the producer warpgroup
// ---------------------------------------------------------------------------

// Stages in the gathered route's ring.
constexpr int kGatherStages = 4;
// B's rows shorter than this (one 64-wide box), with A broadcast over more
// than one batch entry, are packed: a tile's columns run over the Bn N
// (entry, n) pairs, so A is read once for every entry
// (kernels/matmul/matmul.WGMMA_PACK_N).
constexpr int kPackN = 64;
// Floats in a row of a consumer warp's staging rows: 64 columns and 8 of
// padding, so the fragment's 8-byte writes and the row reads hit 32 banks.
constexpr int kStageRow = 72;

// Shape of one instantiated gathered tile.
template <int BM, int BN>
struct GaTile {
  static constexpr int S = kGatherStages;
  static constexpr int BK = 64;                     // one swizzle row of A
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kBBytes = BK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // B's gather: kBChunks 16-byte chunks a K-row of the stage, kBRows rows a
  // pass of the 128 producer threads, kBPasses passes a stage
  static constexpr int kBChunks = BN / 8;
  static constexpr int kBRows = 128 / kBChunks;
  static constexpr int kBPasses = BK / kBRows;
  // A's gather: 8 chunks an M-row, 16 rows a pass
  static constexpr int kAPasses = BM / 16;
  // each consumer warp's staging rows for the epilogue: 16 of kStageRow
  static constexpr int kStagingBytes = kConsumers * 4 * 16 * kStageRow * 4;
  static constexpr int kSmemBytes =
      1024 + S * kStageBytes + kStagingBytes + 2 * S * 8;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 64, "gathered width: one box");
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

// A gathered call: the operands, epilogue, output and shape. sA / sB are
// batch strides in elements (0: broadcast); a_gather / b_gather say which
// operands the producer gathers (the others come by TMA).
struct Gather {
  const bf16* A;
  const bf16* B;
  Ep bias, res;
  void* C;
  float* ws;
  long long sA, sB;
  int M, N, K, Bn, relu, split, out_bf16, a_gather, b_gather;
};

// The 8 bf16 of x with those at or past `keep` zeroed (A's chunk at K's
// edge: the next row's values must not meet B's zero rows, 0 x NaN = NaN).
__device__ __forceinline__ uint4 keep_first(uint4 x, int keep) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] &= (2 * i < keep ? 0xffffu : 0u) | (2 * i + 1 < keep ? 0xffff0000u : 0u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The epilogue of one consumer warp: its 16 rows m0 .. m0 + 15 of the
// tile's columns j0 .. j0 + BN - 1, 64 at a time through its staging rows
// `buf`: the fragment's sums go in, then each lane takes the two columns
// j0 + 2 lane (+ 1) of 8 rows before it stores any of them, twice. Column
// j is n = j of entry z, or, Packed, n = j % N of entry j / N; element
// (z, m, n) lies at z M N + m N + n of C, of the residual and of split s's
// partial in ws. With split == 1 bias -> residual -> ReLU apply to the fp32
// sum and the output is stored as fp32 or bf16; else the raw partial, fp32.
// A pair is stored as one 4-byte bf16 pair (8-byte fp32 pair) where its
// first element's offset from C or ws is even (both are 16-byte aligned;
// split s's partial starts s Bn M N elements into ws), else element by
// element, as is every element of a packed tile; the residual is read
// element by element. Outputs past M or the columns are never stored.
template <int BN, bool Packed>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           uint32_t buf, int m0, int j0,
                                           int z, int s, const Gather& g) {
  const int lane = threadIdx.x % 32, gq = lane / 4, q = lane % 4;
  const long long MN = (long long)g.M * g.N;
  const int cols = Packed ? g.Bn * g.N : g.N;
  const bool fin = g.split == 1;
  const long long o0 = fin ? 0 : (long long)s * g.Bn * MN;   // C's or ws's
#pragma unroll
  for (int h = 0; h < BN / 64; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         buf + 4 * ((gq + 8 * hh) * kStageRow + 8 * j + 2 * q)),
                     "f"(acc[4 * (8 * h + j) + 2 * hh]),
                     "f"(acc[4 * (8 * h + j) + 2 * hh + 1])
                     : "memory");
    __syncwarp();
    const int j = j0 + 64 * h + 2 * lane;
    bool ok[2];
    long long at[2];                     // element (z, m0, n) of each column
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ok[e] = j + e < cols;
      const int zz = Packed ? (j + e) / g.N : z;
      const int n = Packed ? j + e - zz * g.N : j + e;
      at[e] = zz * MN + (long long)m0 * g.N + n;
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
      if (!ok[0]) continue;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = 8 * half + r, m = m0 + row;
        if (m >= g.M) break;
        const long long i0 = at[0] + (long long)row * g.N;
        const long long i1 = at[1] + (long long)row * g.N;
        float x0 = v[r].x, x1 = v[r].y;
        if (fin) {
          x0 = rt::tc::finish(x0, g.bias, g.res, m, i0, g.relu);
          if (ok[1]) x1 = rt::tc::finish(x1, g.bias, g.res, m, i1, g.relu);
        }
        const bool pair = !Packed && ok[1] && ((o0 + i0) & 1) == 0;
        if (fin && g.out_bf16) {
          bf16* o = static_cast<bf16*>(g.C);
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(o + i0) = __floats2bfloat162_rn(x0, x1);
          } else {
            o[i0] = __float2bfloat16_rn(x0);
            if (ok[1]) o[i1] = __float2bfloat16_rn(x1);
          }
        } else {
          float* o = fin ? static_cast<float*>(g.C) : g.ws + o0;
          if (pair) {
            *reinterpret_cast<float2*>(o + i0) = make_float2(x0, x1);
          } else {
            o[i0] = x0;
            if (ok[1]) o[i1] = x1;
          }
        }
      }
    }
    __syncwarp();                  // the rows are read before the next pass
  }
}

// grid (CTAs): a persistent walk over the output tiles, as the TMA kernel's
// but with no cluster: units are numbered with the M tiles fastest (CTAs
// running together share B's tile through L2), then the column tiles,
// the batch entries (unpacked) and the K splits; CTA b takes units b, b +
// gridDim.x, ... Warpgroup 0 produces each stage: A by TMA (thread 0) or,
// where GatherA, gathered by all 128 threads; B gathered (Packed: element
// by element) or, only where GatherA and !g.b_gather, by TMA; every load
// of the stage issued before any is shifted and stored. Then every thread
// fences its stores into the async proxy and each warp arrives on the
// stage's full barrier (4 warps + thread 0's arrival, which carries the
// TMA bytes). A's gather is a template flag so that the B-only producer
// holds no A windows: 64-row tiles fit two CTAs an SM. Warpgroups
// 1..BM/64 consume, as in matmul_wgmma_kernel, and store their rows
// through staging rows (store_tile).
template <int BM, int BN, bool GatherA, bool Packed>
__global__ void __launch_bounds__(GaTile<BM, BN>::kThreads, BM == 64 ? 2 : 1)
    matmul_gather_kernel(const __grid_constant__ CUtensorMap mapA,
                         const __grid_constant__ CUtensorMap mapB,
                         const Gather g) {
  using T = GaTile<BM, BN>;
  constexpr int S = T::S;
  static_assert(!(GatherA && Packed), "B is packed only beside a TMA A");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* stagings = smem + S * T::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stagings + T::kStagingBytes);
  uint64_t* empty = full + S;

  const int M = g.M, N = g.N, K = g.K;
  const bool b_gather = !GatherA || g.b_gather;
  const int cols = Packed ? g.Bn * N : N, imgs = Packed ? 1 : g.Bn;
  const int mt = (M + BM - 1) / BM, nt = (cols + BN - 1) / BN;
  const int units = mt * nt * imgs * g.split;
  const int all = (K + T::BK - 1) / T::BK;
  const int per = (all + g.split - 1) / g.split;
  auto unit = [&](int u) {
    Unit w;
    w.m0 = u % mt * BM;
    u /= mt;
    w.n0 = u % nt * BN;
    u /= nt;
    w.z = u % imgs;
    w.s = u / imgs;
    w.first = w.s * per;
    w.steps = min(all, w.first + per) - w.first;
    return w;
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
  const int a_bat = g.Bn > 1 && g.sA != 0, b_bat = g.Bn > 1 && g.sB != 0;
  if (wg == 0) {
    const int t = threadIdx.x, lane = t % 32;
    const int qb = t % T::kBChunks, rb = t / T::kBChunks;   // B: chunk, row
    const int qa = t % 8, ra = t / 8;                       // A: chunk, row
    // each operand's elements counted from the 16-byte boundary at or
    // below it, and its end
    const int amis = (int)(reinterpret_cast<uintptr_t>(g.A) / 2 % 8);
    const int bmis = (int)(reinterpret_cast<uintptr_t>(g.B) / 2 % 8);
    const int4* A16 = reinterpret_cast<const int4*>(g.A - amis);
    const int4* B16 = reinterpret_cast<const int4*>(g.B - bmis);
    const unsigned short* bs = reinterpret_cast<const unsigned short*>(g.B);
    const long long aend =
        amis + (a_bat ? (g.Bn - 1) * g.sA : 0) + (long long)M * K;
    const long long bend =
        bmis + (b_bat ? (g.Bn - 1) * g.sB : 0) + (long long)K * N;
    const uint32_t tma_bytes =
        (GatherA ? 0 : T::kABytes) + (b_gather ? 0 : T::kBBytes);
    if (t == 0) {
      if (!GatherA) rt::wg::prefetch_map(&mapA);
      if (!b_gather) rt::wg::prefetch_map(&mapB);
    }
    int gs = 0;                                   // stages produced
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit(u);
      const long long za = a_bat ? w.z * g.sA : 0;
      const long long zb = b_bat ? w.z * g.sB : 0;
      // packed: the offset in B of each of this thread's 8 columns at K-row
      // 0, -1 past the last entry's
      long long col[Packed ? 8 : 1];
      if constexpr (Packed) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = w.n0 + 8 * qb + e, n = j / N;
          col[e] = j < cols ? (b_bat ? n * g.sB : 0) + (j - n * N) : -1;
        }
      }
      for (int i = 0; i < w.steps; ++i, ++gs) {
        const int st = gs % S;
        const int k0 = (w.first + i) * T::BK;
        rt::wg::mbar_wait(&empty[st], ((gs / S) & 1) ^ 1);
        uint8_t* a = smem + st * T::kStageBytes;
        uint8_t* b = a + T::kABytes;
        if (t == 0) {
          if (tma_bytes == 0) {
            rt::wg::mbar_arrive(&full[st]);
          } else {
            rt::wg::mbar_expect_tx(&full[st], tma_bytes);
            if (!GatherA)
              rt::wg::tma_load(a, &mapA, &full[st], k0, w.m0, a_bat ? w.z : 0);
            if (!b_gather) {
#pragma unroll
              for (int j = 0; j < BN / 64; ++j) {
                rt::wg::tma_load(b + 8192 * j, &mapB, &full[st], w.n0 + 64 * j,
                                 k0, b_bat ? w.z : 0);
                rt::wg::tma_load(b + 8192 * j + 4096, &mapB, &full[st],
                                 w.n0 + 64 * j, k0 + 32, b_bat ? w.z : 0);
              }
            }
          }
        }
        // every load of the stage: A's rows w.m0 + ra + 16 j (chunk qa, K
        // from k0 + 8 qa), B's K-rows k0 + rb + kBRows j (chunk qb, columns
        // from w.n0 + 8 qb)
        constexpr int kA = GatherA ? T::kAPasses : 1;
        int4 alo[kA], ahi[kA], blo[T::kBPasses], bhi[T::kBPasses];
        int amv[kA], bmv[T::kBPasses];
        uint32_t e8[Packed ? T::kBPasses : 1][8];
        const int kc = k0 + 8 * qa;
        if constexpr (GatherA) {
#pragma unroll
          for (int j = 0; j < T::kAPasses; ++j) {
            const int m = w.m0 + ra + 16 * j;
            rt::wg::load_window(alo[j], ahi[j], amv[j], A16,
                                amis + za + (long long)m * K + kc, aend,
                                m < M && kc < K);
          }
        }
        if (b_gather) {
#pragma unroll
          for (int j = 0; j < T::kBPasses; ++j) {
            const int k = k0 + rb + T::kBRows * j;
            if constexpr (Packed) {
#pragma unroll
              for (int e = 0; e < 8; ++e)
                e8[j][e] = k < K && col[e] >= 0
                               ? __ldg(bs + col[e] + (long long)k * N)
                               : 0u;
            } else {
              rt::wg::load_window(blo[j], bhi[j], bmv[j], B16,
                                  bmis + zb + (long long)k * N + w.n0 + 8 * qb,
                                  bend, k < K);
            }
          }
        }
        // then every shift and store, into the layouts TMA writes: A's row m
        // at 128 m, B's K-row r of box x at 8,192 x + 128 r, the 16-byte
        // chunk c of a row at chunk c ^ (row % 8)
        if constexpr (GatherA) {
          const uint32_t as = rt::wg::smem_addr(a);
#pragma unroll
          for (int j = 0; j < T::kAPasses; ++j) {
            const int r = ra + 16 * j;
            rt::wg::st_shared_v4(as + r * 128 + ((qa ^ (r & 7)) << 4),
                                 keep_first(rt::wg::realign(alo[j], ahi[j], amv[j]),
                                            K - kc));
          }
        }
        if (b_gather) {
          const uint32_t bsm = rt::wg::smem_addr(b) + 8192 * (qb / 8);
#pragma unroll
          for (int j = 0; j < T::kBPasses; ++j) {
            const int r = rb + T::kBRows * j;
            uint4 x;
            if constexpr (Packed)
              x = make_uint4(e8[j][0] | e8[j][1] << 16, e8[j][2] | e8[j][3] << 16,
                             e8[j][4] | e8[j][5] << 16, e8[j][6] | e8[j][7] << 16);
            else
              x = rt::wg::realign(blo[j], bhi[j], bmv[j]);
            rt::wg::st_shared_v4(bsm + r * 128 + (((qb & 7) ^ (r & 7)) << 4), x);
          }
        }
        // the stores reach the async proxy before the stage is published
        rt::wg::fence_async_shared();
        __syncwarp();
        if (lane == 0) rt::wg::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // a consumer: rows [64 c, 64 c + 64) of each unit's tile
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const uint32_t staging =
      rt::wg::smem_addr(stagings + (4 * c + t / 32) * 16 * kStageRow * 4);
  float acc[BN / 2];
  int gs = 0, freed = 0;                          // stages used, released
  auto free_to = [&](int j) {
    for (; freed < j; ++freed)
      if (t == 0) rt::wg::mbar_arrive(&empty[freed % S]);
  };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit(u);
    for (int i = 0; i < w.steps; ++i, ++gs) {
      const int st = gs % S;
      rt::wg::mbar_wait(&full[st], (gs / S) & 1);
      const uint8_t* a = smem + st * T::kStageBytes;
      if (i == 0)
        stage_mma<BN, true>(acc, a + c * 64 * 128, a + T::kABytes);
      else
        stage_mma<BN, false>(acc, a + c * 64 * 128, a + T::kABytes);
      rt::wg::wgmma_wait<1>();                    // stage gs - 1 is done
      free_to(gs);
    }
    rt::wg::wgmma_wait<0>();
    rt::wg::fence_regs(acc);
    free_to(gs);
    store_tile<BN, Packed>(acc, staging, w.m0 + 64 * c + 16 * (t / 32), w.n0,
                           w.z, w.s, g);
  }
}

template <int BM, int BN, bool GatherA, bool Packed>
int launch_gather(const Gather& g, cudaStream_t stream) {
  using T = GaTile<BM, BN>;
  auto* kernel = matmul_gather_kernel<BM, BN, GatherA, Packed>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int a_bat = g.Bn > 1 && g.sA != 0, b_bat = g.Bn > 1 && g.sB != 0;
  CUtensorMap ma = {}, mb = {};
  int err = 0;
  if (!g.a_gather)
    err = rt::wg::make_map(&ma, g.A, g.M, g.K, a_bat ? g.Bn : 1, g.sA, 64, BM);
  if (err == 0 && !g.b_gather)
    err = rt::wg::make_map(&mb, g.B, g.K, g.N, b_bat ? g.Bn : 1, g.sB, 64, 32);
  if (err != 0) return err;
  const long long cols = Packed ? (long long)g.Bn * g.N : g.N;
  const long long units = (long long)((g.M + BM - 1) / BM) *
                          ((cols + BN - 1) / BN) * (Packed ? 1 : g.Bn) * g.split;
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
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(ma, mb, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || g.split == 1) return (int)e;
  return rt::tc::launch_splitk_reduce(g.ws, g.bias, g.res, g.C, g.M, g.N,
                                      g.split, (long long)g.Bn * g.M * g.N,
                                      g.relu, stream, g.out_bf16);
}

// Every (BM, BN) gathered tile ops.wgmma_plan may choose
// (matmul.WGMMA_GATHER_TILES), each kGatherStages deep, where A comes by
// TMA; a gathered A takes the first (matmul.WGMMA_GATHER_A_TILE).
#define RT_FOR_EACH_GATHER_TILE(X) X(64, 64) X(128, 64)
constexpr int kGatherABM = 64, kGatherABN = 64;

// Every (BM, BN, S) tile ops.wgmma_plan may choose (matmul.WGMMA_TILES):
// the six variants' ceilings and the smaller BM / BN their fit reaches.
#define RT_FOR_EACH_WGMMA_TILE(X)                                      \
  X(64, 64, 3) X(64, 128, 3) X(64, 256, 3) X(128, 64, 3) X(128, 128, 3) \
      X(128, 256, 3) X(64, 64, 4) X(64, 128, 4) X(64, 256, 4)          \
          X(128, 64, 4) X(128, 128, 4) X(128, 256, 4) X(64, 64, 8)     \
              X(64, 128, 8)

int launch(const bf16* A, const bf16* B, Ep bias, Ep res, void* C, float* ws,
           int Bn, int M, int N, int K, int relu, long long sA, long long sB,
           int bm, int bn, int stages, int split, int out_bf16, int a_gather,
           int b_gather, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || Bn < 1 || sA < 0 || sB < 0)
    return (int)cudaErrorInvalidValue;
  // what TMA needs of an operand it loads: 16-byte rows, base and batch
  // stride
  const bool a_tma = K % 8 == 0 && sA % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool b_tma = N % 8 == 0 && sB % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(B) % 16 == 0;
  if ((!a_gather && !a_tma) || (!b_gather && !b_tma))
    return (int)cudaErrorInvalidValue;
  // every split must own at least one 64-deep step, and a split needs a
  // workspace
  const int steps = (K + 63) / 64;
  if (split < 1) return (int)cudaErrorInvalidValue;
  const int per = (steps + split - 1) / split;
  if (split > 1 && (ws == nullptr || (split - 1) * per >= steps))
    return (int)cudaErrorInvalidValue;
  if (a_gather || b_gather) {
    if (stages != kGatherStages || reinterpret_cast<uintptr_t>(C) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    // B's short rows packed across the entries that share a broadcast A
    // (by TMA)
    const bool packed = !a_gather && sA == 0 && Bn > 1 && N < kPackN;
    const Gather g{A, B, bias, res, C, ws, sA, sB, M, N, K, Bn, relu, split,
                   out_bf16, a_gather, b_gather};
    if (a_gather)
      return bm == kGatherABM && bn == kGatherABN
                 ? launch_gather<kGatherABM, kGatherABN, true, false>(g, stream)
                 : (int)cudaErrorInvalidValue;
#define RT_LAUNCH(BM_, BN_)                                            \
  if (bm == BM_ && bn == BN_)                                          \
    return packed ? launch_gather<BM_, BN_, false, true>(g, stream)    \
                  : launch_gather<BM_, BN_, false, false>(g, stream);
    RT_FOR_EACH_GATHER_TILE(RT_LAUNCH)
#undef RT_LAUNCH
    return (int)cudaErrorInvalidValue;
  }
#define RT_LAUNCH(BM_, BN_, S_)                                              \
  if (bm == BM_ && bn == BN_ && stages == S_)                               \
    return launch_tile<BM_, BN_, S_>(A, B, bias, res, C, ws, Bn, M, N, K,   \
                                     relu, sA, sB, split, out_bf16, stream);
  RT_FOR_EACH_WGMMA_TILE(RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A (Bn, M, K) with batch stride sA, B (Bn, K, N) with batch stride sB (each
// matrix row-major; a stride of 0 broadcasts one matrix over the batch; Bn
// = 1 for one product), bias (M,) or null, res (Bn, M, N) or null -> C (Bn,
// M, N) contiguous, 16-byte aligned; A and B bf16, bias, res and C each
// fp32 or bf16 (bias_bf16, res_bf16, out_bf16); ws (split, Bn, M, N) fp32
// scratch when split > 1, else null. a_gather / b_gather: the producer
// gathers that operand (at any offset, K or N, and batch stride), else it
// comes by TMA, which needs 16-byte rows, base and batch stride. The
// strides are 64-bit, in elements. Returns cudaGetLastError() after the
// launches; an unknown tile, an illegal split or an operand named for TMA
// that TMA cannot address return cudaErrorInvalidValue without launching.
extern "C" int rt_matmul_wgmma_bf16(const bf16* A, const bf16* B,
                                    const void* bias, const void* res, void* C,
                                    float* ws, int Bn, int M, int N, int K,
                                    int relu, int bm, int bn, int stages,
                                    int split, int out_bf16, int bias_bf16,
                                    int res_bf16, int a_gather, int b_gather,
                                    long long sA, long long sB,
                                    cudaStream_t stream) {
  return launch(A, B, Ep{bias, bias_bf16}, Ep{res, res_bf16}, C, ws, Bn, M, N,
                K, relu, sA, sB, bm, bn, stages, split, out_bf16, a_gather,
                b_gather, stream);
}
