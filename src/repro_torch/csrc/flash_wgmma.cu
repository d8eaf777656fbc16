// bf16 flash attention on Hopper's warpgroup MMA: O = softmax(scale * Q K^T
// [causal mask]) V over bf16 q (BH, Sq, d) and k, v (BH / rep, Sk, d), query
// row bh reading KV row bh / rep (grouped-query attention without copying
// K and V to the query heads), scores, softmax state and output
// accumulator in fp32, O stored as bf16. The wgmma route of flash attention
// (kernels/flash_attention/flash_attention.route): bf16 q, k, v with d = 64
// or 128 and 16-byte-aligned bases. Everything else (fp32, d = 32) runs
// flash_attention.cu's mma.sync kernels; a call that names this route on
// operands it cannot take is refused in flash_attention.py, never rerouted.
//
// Replaces, for those calls, the same TPU kernel as flash_attention.cu:
// `flash_attention` (src/repro/kernels/flash_attention/flash_attention.py:62,
// body `_flash_kernel` :23): the online softmax over KV blocks with the
// running max, sum and accumulator in f32, the causal mask top-left aligned
// with NEG_INF = -1e30, fully masked blocks skipped, acc / max(l, 1e-30)
// stored in q's dtype.
//
// What bounds it on the H100: a causal pass over S keys does 2 S^2 d FLOPs a
// head (Q K^T and P V over the kept pairs) against 8 S d bytes of bf16 q, k,
// v and o: bound by operations at the bf16 rate (989 TFLOP/s), 0.139 ms for
// chatglm3_6b causal at S = 4,096 (32 heads, d = 128). P enters P V as two
// bf16 parts (below), so the tensor cores do 1.5x that work: 0.2085 ms is
// this kernel's floor there. flash_attention.cu's bf16 kernel issues warp
// mma.sync from ldmatrix fragments, which reaches at most a quarter of the
// bf16 rate; only wgmma reaches the full rate.
//
// What the design does:
// 1. One CTA per (bh, BQ-row query block): BQ / 64 consumer warpgroups, 64
//    query rows each, and one producer warp. The grid walks heads fastest
//    and the query blocks from the last, so the heaviest causal blocks of
//    every head are scheduled first.
// 2. TMA (wgmma_bf16.cuh). Q is loaded once; K and V stream through a ring
//    of kStages stages, each with a full barrier for K, one for V and an
//    empty barrier that every live consumer warpgroup arrives on once it has
//    read the stage. One lane of the producer warp keeps the ring's loads
//    in flight. The maps are 3-D (d, S, heads): a box past Sq or Sk is
//    zero-filled within its own head and never reads the next head's rows
//    (keys past Sk are also masked in the scores). d * 2 bytes is 128 or
//    256, so every row is 16-byte aligned; boxes are 64 columns (one
//    128-byte swizzle row) by BQ or BKV rows, d / 64 of them a tile.
// 3. S = Q K^T: m64nBKVk16 wgmma with Q (K-major A) and K as a K-major B
//    (K row-major is (N, K) with N the keys: the transpose-B bit 0), summed
//    over all of d in one chain. The scale (times log2e) multiplies the fp32
//    scores, which stay in the accumulator registers: the softmax's row max
//    and sum reduce over the quad of lanes that holds a row.
// 4. P V: m64nDk16 wgmma with A from registers. The S accumulator's 8-column
//    tiles 2 k and 2 k + 1 are the k-th 16-key step's A fragment as they lie,
//    so P = exp2(S - m), packed to bf16 pairs, needs no shuffle. P is fp32 in
//    the reference: it enters as two bf16 parts, hi = bf16(P) and lo =
//    bf16(P - hi), two wgmma a step (one part alone rounds P to 8 bits, and
//    failed hold_bf16 on 22% of the elements on the card, PERF.md section
//    6). V (keys x d) row-major is an MN-major B, matmul's B layout. O is
//    rescaled by exp2(m_old - m_new) in fp32 and accumulated in place.
// 5. Accuracy. The fp32 kernel sums each 16-deep slice of d, and each KV
//    block's P V, from zero and adds it with a rounding fp32 add, because the
//    tensor cores' adds truncate and it is held near a float64 result. This
//    route is held to one bf16 rounding of the fp32 result (hold_bf16 in
//    chip_smoke.py), and on the card Q K^T over all of d in one chain and O
//    accumulated in place across the 4,096 keys of chatglm3_6b held it
//    (tests/test_torch_gpu.py, chip_smoke.py phase 5): no fresh partial sum.
// 6. Causal: a warpgroup skips the blocks past its own diagonal (it still
//    waits for their data, so it never frees a stage early); only a block
//    that crosses the diagonal or Sk is masked element by element.
// 7. Overlap, fixed by the tile (FwTile::kOverlap, kTurns). At BKV = 64,
//    Q K_{j+1}^T is issued before P_j V_j, and the softmax of block j + 1
//    runs on its fp32 scores while P_j V_j is in flight (FlashAttention-3's
//    intra-warpgroup pipelining); the two consumer warpgroups of a 128-row
//    CTA also issue their MMAs in turns on a pair of mbarriers, so one's
//    softmax runs under the other's MMAs (FlashAttention-3's ping-pong). At
//    BKV = 128 the next block's scores leave ptxas too few registers and it
//    serialises the wgmmas, so a warpgroup's MMAs and its softmax alternate;
//    the two warpgroups of a CTA (or the two one-warpgroup CTAs of an SM)
//    still overlap each other's, as the warp schedulers interleave them.
//    PERF.md section 6 gives the times of the three schedules on every tile
//    that chose these.
// A masked score is NEG_INF, so exp2(NEG_INF - m) is exactly 0 once m is
// finite; every row's first block holds its key 0. No atomics and no split
// of the KV loop: a call repeats bit for bit.
//
// The tiles (kernels/flash_attention/flash_attention.WGMMA_TILES, chosen
// per variant by ops.wgmma_tile): BQ 64 or 128 (one or two consumer
// warpgroups), BKV 64 or 128 at d = 64, 64 at d = 128 (the registers: a
// consumer holds S, BKV / 2 a thread, P's two parts, BKV / 4 each, and O,
// d / 2).
#include <cuda_bf16.h>

#include "wgmma_bf16.cuh"

namespace {

using rt::bf::bf16;
using rt::bf::split_bf16;

constexpr float NEG_INF = -1e30f;   // the reference's mask value, not -inf
constexpr float LOG2E = 1.4426950408889634f;

template <int BQ, int BKV, int D>
struct FwTile {
  static constexpr int kConsumers = BQ / 64;         // warpgroups of wgmma
  static constexpr int kThreads = 128 * kConsumers + 32;   // + a producer warp
  static constexpr int kBoxes = D / 64;              // 64-column boxes along d
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kKVBytes = BKV * D * 2;       // one K or one V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  // one-warpgroup CTAs run two to an SM (registers and shared memory for
  // two), two-warpgroup CTAs one
  static constexpr int kCtasPerSm = BQ == 64 ? 2 : 1;
  // item 7: pipelined at 64 keys a block, with turns where there are two
  // consumer warpgroups; alternating at 128
  static constexpr bool kOverlap = BKV == 64;
  static constexpr bool kTurns = kOverlap && kConsumers == 2;
  static constexpr int kBudget = kCtasPerSm == 2 ? 115712 : 232448;
  static constexpr int kFixed = 1024 + kQBytes + 256;   // alignment, Q, barriers
  static constexpr int kFit = (kBudget - kFixed) / kStageBytes;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  // 1,024 bytes of alignment slack, Q, the ring, then 3 kStages + 3
  // barriers (Q, the ring's, the ping-pong's two)
  static constexpr int kSmemBytes =
      1024 + kQBytes + kStages * kStageBytes + (3 * kStages + 3) * 8;
  static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
  static_assert(BKV == 64 || BKV == 128, "wgmma widths of S");
  static_assert(D == 64 || D == 128, "wgmma widths of O, 64-column boxes");
  static_assert(kStages >= 2, "a ring of at least two stages");
  static_assert(kOverlap || !kTurns, "turns only in the pipelined schedule");
  static_assert(kSmemBytes <= kBudget, "more shared memory than a block has");
};

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The scores s of one BKV-key block (the accumulator of m64nBKVk16: s[4 n +
// 2 h + e] is row row0 + 8 h, key k0 + 8 n + 2 q + e), scaled by qscale into
// the log2 domain, become P = exp2(s - m) in place. Keys past Sk, and with
// `causal` keys past the row, are masked to NEG_INF first (only in a block
// that crosses the diagonal or Sk; w0 is the warp's first row). The running
// maxima m0, m1 move to the block's, corr0, corr1 = exp2(m_old - m_new)
// rescale what was summed before, and l0, l1 take this lane's share of the
// row sums (its quad adds them at the end).
template <int BKV>
__device__ __forceinline__ void softmax_block(
    float (&s)[BKV / 2], float qscale, int k0, int Sk, int causal, int w0,
    int row0, int q, float& m0, float& m1, float& l0, float& l1,
    float& corr0, float& corr1) {
  constexpr int NS = BKV / 8;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s[i] *= qscale;
  if (k0 + BKV > Sk || (causal && k0 + BKV - 1 > w0)) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + n * 8 + 2 * q + (e & 1);
        if (c >= Sk || (causal && c > row0 + (e < 2 ? 0 : 8)))
          s[4 * n + e] = NEG_INF;
      }
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  corr0 = exp2_approx(m0 - mn0);
  corr1 = exp2_approx(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    s[4 * n] = exp2_approx(s[4 * n] - mn0);
    s[4 * n + 1] = exp2_approx(s[4 * n + 1] - mn0);
    s[4 * n + 2] = exp2_approx(s[4 * n + 2] - mn1);
    s[4 * n + 3] = exp2_approx(s[4 * n + 3] - mn1);
    sum0 += s[4 * n] + s[4 * n + 1];
    sum1 += s[4 * n + 2] + s[4 * n + 3];
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
}

// P (fp32, in the S accumulator's layout) as bf16 hi and lo parts, the A
// fragments of the P V steps (p_hi[k] / p_lo[k]: keys 16 k .. 16 k + 15):
// the A fragment of step k is tile 2 k rows g (a0) and g + 8 (a1), tile
// 2 k + 1 rows g (a2) and g + 8 (a3).
template <int BKV>
__device__ __forceinline__ void split_p(const float (&s)[BKV / 2],
                                        uint32_t (&p_hi)[BKV / 16][4],
                                        uint32_t (&p_lo)[BKV / 16][4]) {
#pragma unroll
  for (int k = 0; k < BKV / 16; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(s[8 * k + 2 * r], s[8 * k + 2 * r + 1], p_hi[k][r],
                 p_lo[k][r]);
}

// S = Q K^T for this warpgroup's 64 rows: d / 16 steps summed in one chain
// from zero, committed as one group. `qa`: the warpgroup's rows of the Q
// tile (BQ rows a box), `kt`: the K tile (BKV rows a box).
template <int BQ, int BKV, int D>
__device__ __forceinline__ void issue_qk(float (&s)[BKV / 2],
                                         const uint8_t* qa,
                                         const uint8_t* kt) {
  rt::wg::fence_regs_overwritten(s);
  rt::wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    rt::wg::wgmma<BKV, 0>(
        s, rt::wg::desc(qa + kk / 4 * BQ * 128 + 32 * (kk % 4), 16, 1024),
        rt::wg::desc(kt + kk / 4 * BKV * 128 + 32 * (kk % 4), 16, 1024),
        kk > 0);
  rt::wg::wgmma_commit();
}

// acc += P V for one block: for each 16-key step, hi then lo, V (BKV key
// rows by d, d / 64 boxes BKV * 128 bytes apart) as an MN-major B,
// committed as one group.
template <int BKV, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p_hi)[BKV / 16][4],
                                         const uint32_t (&p_lo)[BKV / 16][4],
                                         const uint8_t* vt) {
  rt::wg::fence_regs(acc);
  rt::wg::wgmma_fence();
#pragma unroll
  for (int k = 0; k < BKV / 16; ++k) {
    const uint64_t b = rt::wg::desc(vt + 2048 * k, BKV * 128, 1024);
    rt::wg::wgmma_rs<D, 1>(acc, p_hi[k], b, 1);
    rt::wg::wgmma_rs<D, 1>(acc, p_lo[k], b, 1);
  }
  rt::wg::wgmma_commit();
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], float corr0,
                                        float corr1) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[4 * n] *= corr0;
    acc[4 * n + 1] *= corr0;
    acc[4 * n + 2] *= corr1;
    acc[4 * n + 3] *= corr1;
  }
}

// grid (BH, query blocks). Q's map (d, Sq, BH), K's and V's (d, Sk, BH /
// rep); O (BH, Sq, d) bf16.
template <int BQ, int BKV, int D>
__global__ void __launch_bounds__(FwTile<BQ, BKV, D>::kThreads,
                                  FwTile<BQ, BKV, D>::kCtasPerSm)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap mapQ,
                       const __grid_constant__ CUtensorMap mapK,
                       const __grid_constant__ CUtensorMap mapV,
                       bf16* __restrict__ O, int Sq, int Sk, int rep,
                       float qscale, int causal) {
  using T = FwTile<BQ, BKV, D>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                               // Q: kBoxes boxes of BQ rows
  uint8_t* ring = smem + T::kQBytes;                // stage: K tile, V tile
  uint64_t* full_q = reinterpret_cast<uint64_t*>(ring + S * T::kStageBytes);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty = full_v + S;
  uint64_t* turn_bar = empty + S;                   // the ping-pong's turns

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // consumer warpgroups with a row below Sq, and the blocks of keys any row
  // of this CTA sees
  const int live = min(T::kConsumers, (Sq - q0 + 63) / 64);
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int blocks = ((causal ? min(Sk, q_last + 1) : Sk) + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    rt::wg::mbar_init(full_q, 1);
    for (int i = 0; i < S; ++i) {
      rt::wg::mbar_init(&full_k[i], 1);
      rt::wg::mbar_init(&full_v[i], 1);
      rt::wg::mbar_init(&empty[i], live);
    }
    rt::wg::mbar_init(&turn_bar[0], 1);
    rt::wg::mbar_init(&turn_bar[1], 1);
    rt::wg::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == T::kConsumers) {
    // the producer warp: one lane issues every load
    if (threadIdx.x % 32 == 0) {
      const int kvh = bh / rep;
      rt::wg::prefetch_map(&mapQ);
      rt::wg::prefetch_map(&mapK);
      rt::wg::prefetch_map(&mapV);
      rt::wg::mbar_expect_tx(full_q, T::kQBytes);
#pragma unroll
      for (int b = 0; b < T::kBoxes; ++b)
        rt::wg::tma_load(qs + b * BQ * 128, &mapQ, full_q, 64 * b, q0, bh);
      for (int j = 0; j < blocks; ++j) {
        const int st = j % S;
        rt::wg::mbar_wait(&empty[st], ((j / S) & 1) ^ 1);
        uint8_t* kt = ring + st * T::kStageBytes;
        rt::wg::mbar_expect_tx(&full_k[st], T::kKVBytes);
#pragma unroll
        for (int b = 0; b < T::kBoxes; ++b)
          rt::wg::tma_load(kt + b * BKV * 128, &mapK, &full_k[st], 64 * b,
                           j * BKV, kvh);
        rt::wg::mbar_expect_tx(&full_v[st], T::kKVBytes);
#pragma unroll
        for (int b = 0; b < T::kBoxes; ++b)
          rt::wg::tma_load(kt + T::kKVBytes + b * BKV * 128, &mapV,
                           &full_v[st], 64 * b, j * BKV, kvh);
      }
    }
    return;
  }
  if (wg >= live) return;            // every row of this warpgroup is past Sq

  // a consumer: rows [r0, r0 + 64)
  const int t = threadIdx.x % 128, q = t % 4;
  const int r0 = q0 + 64 * wg;
  const int w0 = r0 + 16 * (t / 32);                // this warp's first row
  const int row0 = w0 + t % 32 / 4;                 // and this lane's rows
  const int r_last = min(r0 + 64, Sq) - 1;
  const int mine = ((causal ? min(Sk, r_last + 1) : Sk) + BKV - 1) / BKV;
  const uint8_t* qa = qs + wg * 64 * 128;
  auto k_tile = [&](int j) { return ring + j % S * T::kStageBytes; };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BKV / 2];
  uint32_t p_hi[BKV / 16][4], p_lo[BKV / 16][4];
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, corr0, corr1;
  rt::wg::mbar_wait(full_q, 0);

  if constexpr (!T::kOverlap) {
    for (int j = 0; j < blocks; ++j) {
      const uint32_t par = (j / S) & 1;
      const uint8_t* kt = k_tile(j);
      rt::wg::mbar_wait(&full_k[j % S], par);
      if (j < mine) {
        issue_qk<BQ, BKV, D>(s, qa, kt);
        rt::wg::wgmma_wait<0>();
        rt::wg::fence_regs(s);
        softmax_block<BKV>(s, qscale, j * BKV, Sk, causal, w0, row0, q, m0,
                           m1, l0, l1, corr0, corr1);
        split_p<BKV>(s, p_hi, p_lo);
        rescale<D>(acc, corr0, corr1);
      }
      rt::wg::mbar_wait(&full_v[j % S], par);
      if (j < mine) {
        issue_pv<BKV, D>(acc, p_hi, p_lo, kt + T::kKVBytes);
        rt::wg::wgmma_wait<0>();
        rt::wg::fence_regs(acc);
      }
      if (t == 0) rt::wg::mbar_arrive(&empty[j % S]);
    }
  } else {
    // block 0's scores and P first; then each step issues Q K_{j+1}^T and
    // P_j V_j together and runs block j + 1's softmax on its fp32 scores
    // under P_j V_j; O's rescale and P_{j+1}'s bf16 parts wait for P_j V_j
    // (registers a wgmma in flight reads are written only after it:
    // otherwise ptxas serialises every wgmma, C7513). The loop bounds, not
    // branches, pick the steps: a wgmma in a branch ptxas cannot prove
    // uniform serialises them too (C7518).
    //
    // In a tile with turns (kTurns) and two live consumer warpgroups, each
    // step's MMAs are issued in turns: a warpgroup waits for the phase of
    // its turn barrier that the other completes when it has issued its
    // own, so one warpgroup's softmax runs under the other's MMAs. Both
    // take blocks + 1 turns (an empty one for each block past the
    // diagonal), so a turn barrier is never two phases ahead of its waiter;
    // its waits trap on a hang as every barrier wait does.
    const bool pp = T::kTurns && live == 2;
    uint32_t turns = 0;
    auto turn = [&]() {
      if (pp) rt::wg::mbar_wait(&turn_bar[wg], turns++ & 1);
    };
    auto done = [&]() {
      if (pp && t == 0) rt::wg::mbar_arrive(&turn_bar[1 - wg]);
    };
    if (pp && wg == 1 && t == 0) rt::wg::mbar_arrive(&turn_bar[0]);   // 0 first
    rt::wg::mbar_wait(&full_k[0], 0);
    turn();
    issue_qk<BQ, BKV, D>(s, qa, k_tile(0));
    done();
    rt::wg::wgmma_wait<0>();
    rt::wg::fence_regs(s);
    softmax_block<BKV>(s, qscale, 0, Sk, causal, w0, row0, q, m0, m1, l0, l1,
                       corr0, corr1);
    split_p<BKV>(s, p_hi, p_lo);
    int j = 0;
    for (; j + 1 < mine; ++j) {
      rt::wg::mbar_wait(&full_k[(j + 1) % S], ((j + 1) / S) & 1);
      rt::wg::mbar_wait(&full_v[j % S], (j / S) & 1);
      turn();
      issue_qk<BQ, BKV, D>(s, qa, k_tile(j + 1));
      issue_pv<BKV, D>(acc, p_hi, p_lo, k_tile(j) + T::kKVBytes);
      done();
      rt::wg::wgmma_wait<1>();                      // S_{j+1}; P_j V_j in flight
      rt::wg::fence_regs(s);
      softmax_block<BKV>(s, qscale, (j + 1) * BKV, Sk, causal, w0, row0, q,
                         m0, m1, l0, l1, corr0, corr1);
      rt::wg::wgmma_wait<0>();
      rt::wg::fence_regs(acc);
      if (t == 0) rt::wg::mbar_arrive(&empty[j % S]);
      rescale<D>(acc, corr0, corr1);
      split_p<BKV>(s, p_hi, p_lo);
    }
    // the last block this warpgroup sees, then those past its diagonal
    rt::wg::mbar_wait(&full_v[j % S], (j / S) & 1);
    turn();
    issue_pv<BKV, D>(acc, p_hi, p_lo, k_tile(j) + T::kKVBytes);
    done();
    rt::wg::wgmma_wait<0>();
    rt::wg::fence_regs(acc);
    if (t == 0) rt::wg::mbar_arrive(&empty[j % S]);
    for (++j; j < blocks; ++j) {
      rt::wg::mbar_wait(&full_k[j % S], (j / S) & 1);
      rt::wg::mbar_wait(&full_v[j % S], (j / S) & 1);
      turn();
      done();
      if (t == 0) rt::wg::mbar_arrive(&empty[j % S]);
    }
  }

  // the quads' row sums, floored at 1e-30 as the reference's finish is
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  bf16* o = O + ((long long)bh * Sq + row0) * D + 2 * q;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n] / l0, acc[4 * n + 1] / l0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * D + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2] / l1, acc[4 * n + 3] / l1);
  }
}

template <int BQ, int BKV, int D>
int launch_tile(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH,
                int Sq, int Sk, int rep, float scale, int causal,
                cudaStream_t stream) {
  using T = FwTile<BQ, BKV, D>;
  auto* kernel = flash_wgmma_kernel<BQ, BKV, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq, mk, mv;
  int err = rt::wg::make_map(&mq, q, Sq, D, BH, (long long)Sq * D, 64, BQ);
  if (err == 0)
    err = rt::wg::make_map(&mk, k, Sk, D, BH / rep, (long long)Sk * D, 64, BKV);
  if (err == 0)
    err = rt::wg::make_map(&mv, v, Sk, D, BH / rep, (long long)Sk * D, 64, BKV);
  if (err != 0) return err;
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      mq, mk, mv, o, Sq, Sk, rep, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Every (BQ, BKV, d) tile flash_attention.WGMMA_TILES names.
#define RT_FOR_EACH_FLASH_WGMMA_TILE(X) \
  X(64, 64, 64) X(64, 128, 64) X(128, 64, 64) X(128, 128, 64) \
      X(64, 64, 128) X(128, 64, 128)

// q (BH, Sq, d), k and v (BH / rep, Sk, d) -> o (BH, Sq, d), bf16
// contiguous, q, k and v 16-byte aligned; query row bh reads KV row
// bh / rep; `scale` (times log2e) multiplies the fp32 scores; the tile
// fixes the schedule (item 7). Returns
// cudaGetLastError() after the launch; an unknown tile, head dim or rep,
// an empty sequence or a misaligned base returns cudaErrorInvalidValue
// without launching.
extern "C" int rt_flash_wgmma_bf16(const bf16* q, const bf16* k,
                                   const bf16* v, bf16* o, int BH, int Sq,
                                   int Sk, int d, int causal, int bq, int bkv,
                                   int rep, float scale,
                                   cudaStream_t stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || rep < 1 || BH % rep != 0 ||
      Sq > 65535 * 64 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
#define RT_LAUNCH(BQ_, BKV_, D_)                                         \
  if (bq == BQ_ && bkv == BKV_ && d == D_)                              \
    return launch_tile<BQ_, BKV_, D_>(q, k, v, o, BH, Sq, Sk, rep, scale, \
                                      causal, stream);
  RT_FOR_EACH_FLASH_WGMMA_TILE(RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
