// Flash attention: O = softmax(scale * Q K^T [causal mask]) V over (BH, S, d)
// tensors, one online-softmax pass over the keys per query block, both
// products on the tensor cores: fp32 q, k, v at fp32 accuracy (3xTF32,
// flash_kernel) and bf16 q, k, v on bf16 mma.sync with fp32 scores, softmax
// state and accumulator (flash_kernel_bf16, below), the output in q's type.
// k and v hold BH / rep heads: query row bh reads KV row bh / rep (grouped-
// query attention without copying K and V to the query heads). bf16 calls
// at d = 64 or 128 with aligned bases take flash_wgmma.cu instead (the
// wgmma route); this file's bf16 kernel takes d = 32 and calls that name
// the mma.sync route.
//
// Replaces the TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py:62, body
// `_flash_kernel` :23): grid (BH, Q blocks, KV blocks) with the KV blocks
// innermost on the sequential grid, the running max m, sum l and output
// accumulator carried in f32 VMEM scratch from one KV step to the next, the
// causal mask applied per element with NEG_INF = -1e30, fully masked KV
// blocks skipped under `pl.when`, and acc / max(l, 1e-30) stored at the last
// KV step.
//
// On the H100 the blocks run in parallel, so the sequential KV axis becomes
// a loop inside the CTA: one CTA per (bh, Q block), the heaviest causal Q
// blocks scheduled first, and a causal loop that stops at the diagonal (the
// TPU kernel's `qi*bq + bq - 1 >= ki*bkv`) instead of visiting the blocks
// past it. The work is split as in FlashAttention-2:
//
// - Each warp owns 16 query rows (one m16 tile): BQ = 64 takes 4 warps,
//   BQ = 128 takes 8. Its scores S = (scale log2e Q) K^T for a block of BKV
//   keys, and then P = exp2(S - m), stay in the mma accumulator registers;
//   a row's max and sum reduce within the 4 lanes (a quad) that hold it, and
//   the sum only once, at the end (each lane keeps a partial l).
// - Q K^T and P V run on mma.sync.m16n8k8.tf32 with mma_tf32.cuh's 3xTF32
//   split (split_tf32, then small*big + big*small + big*big). The tensor
//   cores' sums round toward zero, so no accumulator runs long: each 16-wide
//   slice of d in Q K^T is summed from zero in a fresh fragment and added to
//   S with an fp32 add (one fragment over all of d = 128 drifted past twice
//   the plain version's distance from a float64 result at S = 4,096), and
//   each KV block's P V (four 8-wide d columns at a time) is summed from
//   zero and folded into the running output by one fp32 fma,
//   acc * corr + part, which rounds to nearest.
// - P needs no move from the C-fragment layout to the A-fragment layout of
//   the P V mma: the 8 keys of a k-step are taken in the order 0 2 4 6 1 3
//   5 7, so A's columns t and t + 4 are keys 2t and 2t + 1, which are the
//   two columns the lane already holds (c0, c1 of row g; c2, c3 of row
//   g + 8). V's fragment is read in the same key order: rows 2t and 2t + 1.
// - Q is staged once by cp.async, then multiplied by scale * log2e (so the
//   softmax takes exp2) and split once in shared memory, big in place and
//   small beside it, where every KV block reads both. K and V are split in
//   registers as their fragments are read. They stream through two
//   shared-memory stages, one for K and one for V, filled by 16-byte
//   cp.async copies: V of block j is copied while the warps compute
//   Q K_j^T and its softmax, and K of block j + 1 while they compute P V_j.
//   Two barriers per block; past a ragged Sq or Sk the copies zero-fill
//   (the copy's source-size operand), so nothing is padded in device memory.
// - Rows of Q, K and V in shared memory are padded to d + 4 words: the Q
//   and K fragment reads (row g, column t) and the V reads (rows 2t and
//   2t + 1, column g) of a warp hit 32 distinct banks.
// - A warp whose 16 rows see no key of a block (past the causal diagonal, or
//   past Sq) skips that block's products; only a block that crosses the
//   diagonal or Sk is masked element by element.
//
// A masked score is NEG_INF, not -inf, so exp2(NEG_INF - m) is exactly 0
// once m is finite; a row's first block always holds its key 0, so m is
// finite from then on. Keys past Sk are masked and their V rows are zero;
// queries past Sq are never stored. No atomics and no split of the KV loop:
// a call repeats bit for bit.
//
// The tile needs (2 BQ + 2 BKV) (d + 4) * 4 bytes of dynamic shared memory:
// 101,376 B at (64, 32, d=128), so two 4-warp CTAs share an SM (the launch
// bound lets each take 255 registers); 168,960 B at (128, 32, 128).
// ops.cta_tile takes BKV = 32 at d = 128 for this kernel, where the O
// accumulator takes 64 registers a thread: S and its partial then fit
// beside it.
//
// Bound: a causal pass over S keys does about 2 S^2 d FLOPs per head
// against 16 S d bytes of q, k, v and o (8 S d at bf16): tensor-core bound,
// at the 3xTF32 rate (494.7 / 3 TFLOP/s at 700 W) or the bf16 rate (989).
//
// The bf16 kernel reads q, k and v as bf16 (no fp32 copy in device memory;
// the reference's kernel upcasts each block inside, flash_attention.py:40-42)
// and keeps the fp32 kernel's split, order of work and softmax:
// - S = Q K^T on mma.sync.m16n8k16.bf16 (mma_bf16.cuh): products of bf16
//   values are exact in fp32, so this is the reference's upcast product up
//   to summation order; each 16-wide slice of d is summed from zero and
//   added to S in fp32, as above. The scale (times log2e) multiplies the
//   fp32 scores, not the bf16 q.
// - Fragments by ldmatrix from shared-memory rows padded to d + 8 elements
//   (16 bytes): Q and K (key rows as the column operand) as they lie, V
//   transposed (.trans). Q is read from shared memory every block.
// - P is fp32 in the reference. It enters the P V mma as two bf16 parts,
//   hi = bf16(P) and lo = bf16(P - hi), two mmas per fragment: P is then
//   carried to about 16 bits (|P - hi - lo| <= 2^-16 P), where one part
//   alone would round it to 8. The mma A layout takes the S accumulator's
//   key order as it is (keys 2t, 2t + 1 and 2t + 8, 2t + 9 of a 16-key
//   step are the two 8-key tiles' c0, c1), so P needs no reordering.
// - The output is normalised in fp32 and stored as bf16 pairs.
// Shared memory: (BQ + 2 BKV) (d + 8) * 2 bytes, 52,224 B at (64, 64, 128),
// 69,632 B at (128, 64, 128). ops.cta_tile takes BKV = 64 at every d for
// this kernel: with no tf32 halves in registers, 64 keys a step at d = 128
// ran faster than 32 despite a few spilled bytes (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using rt::bf::bf16;

using rt::tc::ceil_div;
using rt::tc::cp_async16;
using rt::tc::cp_async_commit;
using rt::tc::cp_async_wait;
using rt::tc::mma_tf32;
using rt::tc::split_tf32;

constexpr float NEG_INF = -1e30f;   // the reference's mask value, not -inf
constexpr float LOG2E = 1.4426950408889634f;

template <int BQ, int BKV, int D>
struct FaTile {
  static constexpr int kWarps = BQ / 16;        // 16 query rows a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int LD = D + 4;              // stage row stride, floats
  static constexpr int kSChunk = 16;            // d per fresh Q K^T partial
  static constexpr int kSmemBytes = (2 * BQ + 2 * BKV) * LD * 4;
  static_assert(BQ % 16 == 0 && BKV % 8 == 0 && D % 32 == 0, "mma granularity");
  static_assert(kSmemBytes <= 232448, "tile exceeds the 227 KB a block may use");
};

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scores s of one BKV-key block (the mma C fragments of a warp's 16 rows:
// s[n][e] is row row0 (e < 2) or row1 = row0 + 8, key k0 + 8 n + 2 t +
// (e & 1)), already in the log2 domain, become P = exp2(s - m): keys past
// Sk, and with `causal` keys past the row, are masked to NEG_INF first
// (only in a block that crosses the diagonal or Sk; w0 is the warp's first
// row); the running maxima m0, m1 move to the block's, corr0, corr1 =
// exp2(m_old - m_new) rescale what was summed before, and l0, l1 take this
// lane's share of the row sums (the quad adds them up at the end). A row's
// 4 lanes form a quad.
template <int BKV>
__device__ __forceinline__ void softmax_block(
    float (&s)[BKV / 8][4], int k0, int Sk, int causal, int w0, int row0,
    int row1, int t, float& m0, float& m1, float& l0, float& l1,
    float& corr0, float& corr1) {
  constexpr int NS = BKV / 8;
  if (k0 + BKV > Sk || (causal && k0 + BKV - 1 > w0)) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + n * 8 + 2 * t + (e & 1);
        if (c >= Sk || (causal && c > (e < 2 ? row0 : row1)))
          s[n][e] = NEG_INF;
      }
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
    mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
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
    s[n][0] = exp2_approx(s[n][0] - mn0);
    s[n][1] = exp2_approx(s[n][1] - mn0);
    s[n][2] = exp2_approx(s[n][2] - mn1);
    s[n][3] = exp2_approx(s[n][3] - mn1);
    sum0 += s[n][0] + s[n][1];
    sum1 += s[n][2] + s[n][3];
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
}

// The quads' row sums, floored at 1e-30 as the reference's finish is.
__device__ __forceinline__ void row_sums(float& l0, float& l1) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
}

// Issue the 16-byte copies of rows [r0, r0 + ROWS) of a row-major (S, D)
// matrix into a stage of row stride D + 4, zero past row S.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int S) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int i = 0; i < ceil_div(ROWS * CH, THREADS); ++i) {
    const int c = threadIdx.x + i * THREADS;
    if (c >= ROWS * CH) break;
    const int r = c / CH, j = (c % CH) * 4;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * (D + 4) + j, ok ? src + (long long)(r0 + r) * D + j : src,
               ok ? 16 : 0);
  }
}

template <int BQ, int BKV, int D>
__global__ void __launch_bounds__(FaTile<BQ, BKV, D>::kThreads, BQ == 64 ? 2 : 1)
flash_kernel(const float* __restrict__ Q, const float* __restrict__ K,
             const float* __restrict__ V, float* __restrict__ O, int Sq,
             int Sk, int rep, float qscale, int causal) {
  using T = FaTile<BQ, BKV, D>;
  // G: output columns of 8 whose P V partials are summed at a time
  constexpr int LD = T::LD, NS = BKV / 8, ND = D / 8, G = 4, SC = T::kSChunk;
  extern __shared__ __align__(16) float smem[];
  float* Qb = smem;                   // [BQ][LD]  Q rows: copied, then big
  float* Qs = Qb + BQ * LD;           // [BQ][LD]  their small halves
  float* Ks = Qs + BQ * LD;           // [BKV][LD] K rows of the current block
  float* Vs = Ks + BKV * LD;          // [BKV][LD] V rows of the current block

  // the heaviest causal Q blocks (the last ones) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const long long bh = blockIdx.y;
  // the query head's KV head, by a 32-bit division: a 64-bit one made
  // the fp32 kernel 5-6% slower at d = 128 on an H100 (PERF.md section 6)
  const long long kvh = (int)blockIdx.y / rep;
  Q += bh * Sq * D;
  O += bh * Sq * D;
  K += kvh * Sk * D;
  V += kvh * Sk * D;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = threadIdx.x / 32 * 16;           // warp's first tile row
  const int row0 = q0 + wr + g, row1 = row0 + 8;  // this lane's two rows

  // keys at or past kv_end are masked for every query row of this block
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int blocks = (kv_end + BKV - 1) / BKV;

  load_rows<BQ, D, T::kThreads>(Qb, Q, q0, Sq);
  load_rows<BKV, D, T::kThreads>(Ks, K, 0, Sk);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  // Q, once: each thread scales and splits the chunks it copied, big in
  // place and small beside; the loop's first barrier shows them to all
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < ceil_div(BQ * D / 4, T::kThreads); ++i) {
    const int c = threadIdx.x + i * T::kThreads;
    if (c >= BQ * D / 4) break;
    const int at = c / (D / 4) * LD + c % (D / 4) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t big, small;
      split_tf32(Qb[at + e] * qscale, big, small);
      Qb[at + e] = __uint_as_float(big);
      Qs[at + e] = __uint_as_float(small);
    }
  }

  for (int j = 0; j < blocks; ++j) {
    const int k0 = j * BKV;
    cp_async_wait<0>();       // this thread's copies of K_j (and Q)
    __syncthreads();          // everyone's; every warp is done with V_{j-1}
    load_rows<BKV, D, T::kThreads>(Vs, V, k0, Sk);
    cp_async_commit();        // V_j in flight during Q K_j^T

    // does any of this warp's rows see a key of this block?
    const bool live = q0 + wr < Sq && (!causal || k0 <= q0 + wr + 15);
    float s[NS][4];
    float corr0 = 1.f, corr1 = 1.f;
    if (live) {
      // S = (qscale Q) K_j^T, 3xTF32, each SC-wide slice of d summed from
      // zero in a fresh fragment and added to S with an fp32 add
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += SC) {
        float part[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int kk = c0; kk < c0 + SC; kk += 8) {
          const int qa = (wr + g) * LD + kk + t;
          const uint32_t qb[4] = {
              __float_as_uint(Qb[qa]), __float_as_uint(Qb[qa + 8 * LD]),
              __float_as_uint(Qb[qa + 4]), __float_as_uint(Qb[qa + 8 * LD + 4])};
          const uint32_t qs[4] = {
              __float_as_uint(Qs[qa]), __float_as_uint(Qs[qa + 8 * LD]),
              __float_as_uint(Qs[qa + 4]), __float_as_uint(Qs[qa + 8 * LD + 4])};
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const float* kp = Ks + (n * 8 + g) * LD + kk + t;
            uint32_t kb[2], ks[2];
            split_tf32(kp[0], kb[0], ks[0]);
            split_tf32(kp[4], kb[1], ks[1]);
            mma_tf32(part[n], qs, kb);
            mma_tf32(part[n], qb, ks);
            mma_tf32(part[n], qb, kb);
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = c0 == 0 ? part[n][e] : s[n][e] + part[n][e];
      }
      softmax_block<BKV>(s, k0, Sk, causal, q0 + wr, row0, row1, t, m0, m1,
                         l0, l1, corr0, corr1);
    }

    cp_async_wait<0>();       // this thread's copies of V_j
    __syncthreads();          // everyone's; every warp is done with K_j
    if (j + 1 < blocks) load_rows<BKV, D, T::kThreads>(Ks, K, k0 + BKV, Sk);
    cp_async_commit();        // K_{j+1} in flight during P V_j

    if (live) {
      // P as the A operand, keys in the order 0 2 4 6 1 3 5 7 of each k-step
      uint32_t pb[NS][4], ps[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        split_tf32(s[n][0], pb[n][0], ps[n][0]);
        split_tf32(s[n][2], pb[n][1], ps[n][1]);
        split_tf32(s[n][1], pb[n][2], ps[n][2]);
        split_tf32(s[n][3], pb[n][3], ps[n][3]);
      }
      // acc = acc * corr + P V_j, G output columns of 8 at a time, each
      // block's products summed from zero
#pragma unroll
      for (int n0 = 0; n0 < ND; n0 += G) {
        float part[G][4];
#pragma unroll
        for (int i = 0; i < G; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {
          const float* vp = Vs + (kk * 8 + 2 * t) * LD + n0 * 8 + g;
#pragma unroll
          for (int i = 0; i < G; ++i) {
            uint32_t vb[2], vs[2];
            split_tf32(vp[i * 8], vb[0], vs[0]);
            split_tf32(vp[LD + i * 8], vb[1], vs[1]);
            mma_tf32(part[i], ps[kk], vb);
            mma_tf32(part[i], pb[kk], vs);
            mma_tf32(part[i], pb[kk], vb);
          }
        }
#pragma unroll
        for (int i = 0; i < G; ++i) {
          acc[n0 + i][0] = fmaf(acc[n0 + i][0], corr0, part[i][0]);
          acc[n0 + i][1] = fmaf(acc[n0 + i][1], corr0, part[i][1]);
          acc[n0 + i][2] = fmaf(acc[n0 + i][2], corr1, part[i][2]);
          acc[n0 + i][3] = fmaf(acc[n0 + i][3], corr1, part[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();         // only an empty group remains

  row_sums(l0, l1);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(O + (long long)row0 * D + c) =
          make_float2(acc[n][0] / l0, acc[n][1] / l0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(O + (long long)row1 * D + c) =
          make_float2(acc[n][2] / l1, acc[n][3] / l1);
  }
}

template <int BQ, int BKV, int D>
int launch_tile(const float* q, const float* k, const float* v, float* o,
                int BH, int Sq, int Sk, int rep, float scale, int causal,
                cudaStream_t stream) {
  using T = FaTile<BQ, BKV, D>;
  // raise the dynamic shared memory cap above 48 KB once per instantiation,
  // at its first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<BQ, BKV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel<BQ, BKV, D><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      q, k, v, o, Sq, Sk, rep, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

template <int BQ, int BKV, int D>
struct FaTileBf16 {
  static constexpr int kWarps = BQ / 16;        // 16 query rows a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int LD = D + 8;              // stage row stride, bf16
  static constexpr int kSmemBytes = (BQ + 2 * BKV) * LD * 2;
  static_assert(BQ % 16 == 0 && BKV % 16 == 0 && D % 32 == 0, "mma granularity");
  static_assert(kSmemBytes <= 232448, "tile exceeds the 227 KB a block may use");
};

// The bf16 kernel (see the top of the file): flash_kernel's CTA, loop and
// softmax on bf16 operands, fp32 inside.
template <int BQ, int BKV, int D>
__global__ void __launch_bounds__(FaTileBf16<BQ, BKV, D>::kThreads, BQ == 64 ? 2 : 1)
flash_kernel_bf16(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                  const bf16* __restrict__ V, bf16* __restrict__ O, int Sq,
                  int Sk, int rep, float qscale, int causal) {
  using T = FaTileBf16<BQ, BKV, D>;
  using rt::bf::ldsm_x4;
  using rt::bf::ldsm_x4_t;
  using rt::bf::load_block;
  using rt::bf::mma_bf16;
  using rt::bf::split_bf16;
  constexpr int LD = T::LD, NS = BKV / 8, ND = D / 8;
  extern __shared__ float4 fa_smem16[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem16);   // [BQ][LD]  Q rows
  bf16* Ks = Qs + BQ * LD;                         // [BKV][LD] K rows of the block
  bf16* Vs = Ks + BKV * LD;                        // [BKV][LD] V rows of the block

  // the heaviest causal Q blocks (the last ones) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const long long bh = blockIdx.y;
  // the query head's KV head, by a 32-bit division: a 64-bit one made
  // the fp32 kernel 5-6% slower at d = 128 on an H100 (PERF.md section 6)
  const long long kvh = (int)blockIdx.y / rep;
  Q += bh * Sq * D;
  O += bh * Sq * D;
  K += kvh * Sk * D;
  V += kvh * Sk * D;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = threadIdx.x / 32 * 16;           // warp's first tile row
  const int row0 = q0 + wr + g, row1 = row0 + 8;  // this lane's two rows
  // this lane's ldmatrix row addresses: Q rows wr + lane % 16 at column
  // lane / 16 * 8 (the A fragment); K key rows lane % 8 + lane / 16 * 8 at
  // column lane / 8 % 2 * 8 (two 8-key column tiles); V key rows lane % 16
  // at column lane / 16 * 8 (transposed: two 8-wide d tiles)
  const int q_off = (wr + lane % 16) * LD + lane / 16 * 8;
  const int k_off = (lane % 8 + lane / 16 * 8) * LD + lane / 8 % 2 * 8;
  const int v_off = (lane % 16) * LD + lane / 16 * 8;

  // keys at or past kv_end are masked for every query row of this block
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int blocks = (kv_end + BKV - 1) / BKV;

  load_block<BQ, D, LD, T::kThreads>(Qs, Q, Sq, D, q0, 0, true);
  load_block<BKV, D, LD, T::kThreads>(Ks, K, Sk, D, 0, 0, true);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < blocks; ++j) {
    const int k0 = j * BKV;
    cp_async_wait<0>();       // this thread's copies of K_j (and Q)
    __syncthreads();          // everyone's; every warp is done with V_{j-1}
    load_block<BKV, D, LD, T::kThreads>(Vs, V, Sk, D, k0, 0, true);
    cp_async_commit();        // V_j in flight during Q K_j^T

    const bool live = q0 + wr < Sq && (!causal || k0 <= q0 + wr + 15);
    float s[NS][4];
    float corr0 = 1.f, corr1 = 1.f;
    if (live) {
      // S = Q K_j^T: each 16-wide slice of d summed from zero, added in fp32
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t qa[4];
        ldsm_x4(qa, Qs + q_off + kk);
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t kb[4];
          ldsm_x4(kb, Ks + k_off + n * 8 * LD + kk);
          const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(p0, qa, b0);
          mma_bf16(p1, qa, b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] += p0[e];
            s[n + 1][e] += p1[e];
          }
        }
      }
      // the scale (times log2e) on the fp32 scores
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= qscale;
      softmax_block<BKV>(s, k0, Sk, causal, q0 + wr, row0, row1, t, m0, m1,
                         l0, l1, corr0, corr1);
    }

    cp_async_wait<0>();       // this thread's copies of V_j
    __syncthreads();          // everyone's; every warp is done with K_j
    if (j + 1 < blocks)
      load_block<BKV, D, LD, T::kThreads>(Ks, K, Sk, D, k0 + BKV, 0, true);
    cp_async_commit();        // K_{j+1} in flight during P V_j

    if (live) {
      // P as the A operand of each 16-key step, in two bf16 parts
      uint32_t ph[NS / 2][4], pl[NS / 2][4];
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
      }
      // acc = acc * corr + P V_j, two output columns of 8 at a time, each
      // block's products summed from zero
#pragma unroll
      for (int n0 = 0; n0 < ND; n0 += 2) {
        float part[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          uint32_t vb[4];
          ldsm_x4_t(vb, Vs + v_off + kk * 16 * LD + n0 * 8);
          const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
          mma_bf16(part[0], ph[kk], b0);
          mma_bf16(part[0], pl[kk], b0);
          mma_bf16(part[1], ph[kk], b1);
          mma_bf16(part[1], pl[kk], b1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[n0 + i][0] = fmaf(acc[n0 + i][0], corr0, part[i][0]);
          acc[n0 + i][1] = fmaf(acc[n0 + i][1], corr0, part[i][1]);
          acc[n0 + i][2] = fmaf(acc[n0 + i][2], corr1, part[i][2]);
          acc[n0 + i][3] = fmaf(acc[n0 + i][3], corr1, part[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();         // only an empty group remains

  row_sums(l0, l1);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(O + (long long)row0 * D + c) =
          __floats2bfloat162_rn(acc[n][0] / l0, acc[n][1] / l0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(O + (long long)row1 * D + c) =
          __floats2bfloat162_rn(acc[n][2] / l1, acc[n][3] / l1);
  }
}

template <int BQ, int BKV, int D>
int launch_tile_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                     int BH, int Sq, int Sk, int rep, float scale, int causal,
                     cudaStream_t stream) {
  using T = FaTileBf16<BQ, BKV, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel_bf16<BQ, BKV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel_bf16<BQ, BKV, D><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      q, k, v, o, Sq, Sk, rep, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Every (BQ, BKV) CTA tile the wrapper's TILES names, at head dims 32, 64, 128.
#define RT_FOR_EACH_FA_TILE(X, D) X(64, 32, D) X(64, 64, D) X(128, 32, D) X(128, 64, D)

// Built twice (kernels/common.LIBRARIES): -DRT_FP32 gives the fp32 entry
// point, -DRT_BF16 the bf16 one, so each build instantiates one kernel's
// tiles and the two compile in parallel.
#if defined(RT_FP32) == defined(RT_BF16)
#error "build flash_attention.cu with exactly one of -DRT_FP32 and -DRT_BF16"
#endif
#if defined(RT_FP32)

// q (BH, Sq, d), k and v (BH / rep, Sk, d) -> o (BH, Sq, d), fp32
// contiguous and 16-byte aligned; query row bh reads KV row bh / rep; q is
// multiplied by `scale` before Q K^T. Returns cudaGetLastError() after the
// launch; an unknown tile or head dim, or a rep that does not divide BH,
// returns cudaErrorInvalidValue.
extern "C" int rt_flash_attention_f32(const float* q, const float* k,
                                      const float* v, float* o, int BH, int Sq,
                                      int Sk, int d, int causal, int bq,
                                      int bkv, int rep, float scale,
                                      cudaStream_t stream) {
  if (rep < 1 || BH % rep != 0) return (int)cudaErrorInvalidValue;
#define RT_LAUNCH(BQ_, BKV_, D_)                                            \
  if (bq == BQ_ && bkv == BKV_ && d == D_)                                 \
    return launch_tile<BQ_, BKV_, D_>(q, k, v, o, BH, Sq, Sk, rep, scale,  \
                                      causal, stream);
  RT_FOR_EACH_FA_TILE(RT_LAUNCH, 32)
  RT_FOR_EACH_FA_TILE(RT_LAUNCH, 64)
  RT_FOR_EACH_FA_TILE(RT_LAUNCH, 128)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
#endif

#if defined(RT_BF16)
// The same over bf16 q, k, v -> bf16 o; `scale` (times log2e) multiplies
// the fp32 scores.
extern "C" int rt_flash_attention_bf16(const bf16* q, const bf16* k,
                                       const bf16* v, bf16* o, int BH,
                                       int Sq, int Sk, int d, int causal,
                                       int bq, int bkv, int rep, float scale,
                                       cudaStream_t stream) {
  if (rep < 1 || BH % rep != 0) return (int)cudaErrorInvalidValue;
#define RT_LAUNCH(BQ_, BKV_, D_)                                              \
  if (bq == BQ_ && bkv == BKV_ && d == D_)                                   \
    return launch_tile_bf16<BQ_, BKV_, D_>(q, k, v, o, BH, Sq, Sk, rep,      \
                                           scale, causal, stream);
  RT_FOR_EACH_FA_TILE(RT_LAUNCH, 32)
  RT_FOR_EACH_FA_TILE(RT_LAUNCH, 64)
  RT_FOR_EACH_FA_TILE(RT_LAUNCH, 128)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
#endif
