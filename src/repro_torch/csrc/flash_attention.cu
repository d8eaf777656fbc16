// Flash attention, fp32: O = softmax(scale * Q K^T [causal mask]) V over
// (BH, S, d) tensors, one online-softmax pass over the keys per query block.
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
// a loop inside the CTA: one CTA of 256 threads per (bh, Q block), m, l and
// the accumulator in registers for the whole loop, and a causal loop that
// stops at the diagonal (the TPU kernel's `qi*bq + bq - 1 >= ki*bkv`) instead
// of visiting the blocks past it. Per KV block the CTA
//   1. stages K transposed in shared memory and computes the BQ x BKV score
//      tile S = (scale Q) K^T, Q having been staged, pre-scaled, once;
//   2. masks it (causal: query position >= key position, top-left aligned
//      when Sq != Sk, as in the reference), takes the row max across the 16
//      threads that share a row (warp shuffles), and rescales l and the
//      accumulator by exp(m_old - m_new);
//   3. writes P = exp(S - m_new) to shared memory, stages V in the buffer K
//      used, and accumulates P V.
// A masked score is NEG_INF, not -inf, so exp(NEG_INF - m) is exactly 0 once
// m is finite; a row's first visited block always holds its key 0, so a row
// that is fully masked inside a later block adds exactly 0. Keys past Sk
// (a ragged last block) get p = 0 explicitly, and queries past Sq are never
// stored: shapes need not divide the tile.
//
// Thread layout: thread (ty, tx) of a 16 x 16 grid owns
// rows ty + 16 i of the tile and key columns (or head-dim columns of the
// output) tx + 16 j. Shared memory rows are padded by one word so that the
// transposing K store and the row reads hit distinct banks. The tile needs
// (BQ (d+1) + max(d (BKV+1), BKV d) + BQ (BKV+1)) * 4 bytes of dynamic shared
// memory: 83 KB at (64, 64, d=128), 198 KB at (128, 128, 128), under the
// 227 KB a block may take.
//
// Bound: fp32 FMA outside the tensor cores (67 TFLOP/s at 700 W): a causal
// pass over S keys does about 2 S^2 d FLOPs per head against 16 S d bytes of
// q, k, v and o. This first version is plain shared-memory tiling with
// scalar FMAs: no tensor cores (wgmma), no TMA / cp.async double buffering,
// no split of the KV loop across CTAs. Those are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float NEG_INF = -1e30f;   // the reference's mask value, not -inf

__host__ __device__ constexpr int smem_floats(int BQ, int BKV, int D) {
  return BQ * (D + 1) + (D * (BKV + 1) > BKV * D ? D * (BKV + 1) : BKV * D) +
         BQ * (BKV + 1);
}

template <int BQ, int BKV, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ Q, const float* __restrict__ K,
             const float* __restrict__ V, float* __restrict__ O, int Sq,
             int Sk, float scale, int causal) {
  constexpr int TM = BQ / 16, TN = BKV / 16, TD = D / 16;
  constexpr int QLD = D + 1, KLD = BKV + 1, PLD = BKV + 1;
  constexpr int KV_FLOATS = D * KLD > BKV * D ? D * KLD : BKV * D;
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][QLD]   Q rows, pre-scaled
  float* KVs = Qs + BQ * QLD;         // [D][KLD] K transposed, then [BKV][D] V
  float* Ps = KVs + KV_FLOATS;        // [BQ][PLD]   probabilities

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // the heaviest causal Q blocks (the last ones) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const long long bh = blockIdx.y;
  Q += bh * Sq * D;
  O += bh * Sq * D;
  K += bh * Sk * D;
  V += bh * Sk * D;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D, q = q0 + r;
    Qs[r * QLD + d] = q < Sq ? Q[(long long)q * D + d] * scale : 0.f;
  }

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  // keys at or past kv_end are masked for every query row of this block
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();          // Q is staged; the last P V read KVs and Ps
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D, k = k0 + c;
      KVs[d * KLD + c] = k < Sk ? K[(long long)k * D + d] : 0.f;
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Qs[(ty + 16 * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = KVs[d * KLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c >= Sk || (causal && r < c)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p = c < Sk ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();          // every score is read: KVs may take V
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D, k = k0 + c;
      KVs[c * D + d] = k < Sk ? V[(long long)k * D + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float a[TM], b[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) b[j] = KVs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      O[(long long)r * D + tx + 16 * j] = acc[i][j] / den;
  }
}

template <int BQ, int BKV, int D>
int launch_tile(const float* q, const float* k, const float* v, float* o,
                int BH, int Sq, int Sk, float scale, int causal,
                cudaStream_t stream) {
  constexpr int bytes = smem_floats(BQ, BKV, D) * (int)sizeof(float);
  static_assert(bytes <= 232448, "tile exceeds the 227 KB a block may use");
  // raise the dynamic shared memory cap above 48 KB once per instantiation,
  // at its first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<BQ, BKV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel<BQ, BKV, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Every (BQ, BKV) CTA tile ops.CTA_TILES names, at head dims 32, 64, 128.
#define RT_FOR_EACH_FA_TILE(X, D) X(64, 64, D) X(64, 128, D) X(128, 64, D) X(128, 128, D)

// q (BH, Sq, d), k and v (BH, Sk, d) -> o (BH, Sq, d), fp32 contiguous; q is
// multiplied by `scale` before Q K^T. Returns cudaGetLastError() after the
// launch; an unknown tile or head dim returns cudaErrorInvalidValue.
extern "C" int rt_flash_attention_f32(const float* q, const float* k,
                                      const float* v, float* o, int BH, int Sq,
                                      int Sk, int d, int causal, int bq,
                                      int bkv, float scale,
                                      cudaStream_t stream) {
#define RT_LAUNCH(BQ_, BKV_, D_)                                            \
  if (bq == BQ_ && bkv == BKV_ && d == D_)                                 \
    return launch_tile<BQ_, BKV_, D_>(q, k, v, o, BH, Sq, Sk, scale, causal, \
                                      stream);
  RT_FOR_EACH_FA_TILE(RT_LAUNCH, 32)
  RT_FOR_EACH_FA_TILE(RT_LAUNCH, 64)
  RT_FOR_EACH_FA_TILE(RT_LAUNCH, 128)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
