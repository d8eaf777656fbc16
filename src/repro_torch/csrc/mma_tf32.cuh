// fp32 GEMM tile loop on Hopper's tensor cores at fp32 accuracy (3xTF32),
// fed by a cp.async ring. Used by matmul.cu, im2col_gemm.cu and the
// Winograd point-GEMM of winograd.cu; its bf16 counterpart, for matmul.cu's
// bf16 operands, is mma_bf16.cuh.
//
// One CTA computes a BM x BN tile of C[m, n] = sum_k A[m, k] * B[k, n] over
// a K range [kbeg, kend). The caller's stage loader fills the shared-memory
// stages: matmul.cu's copies A (M, K) and B (K, N), both row-major in device
// memory (RowMajorStages, load_stage); im2col_gemm.cu's copies A the same
// way (load_a) and gathers B, the patch matrix, straight from the conv's
// input.
//
// - Tensor cores at fp32 accuracy. Each operand element x is split into
//   big = x rounded to tf32 and small = x - big, and every 16x8x8 step
//   accumulates small_a*big_b + big_a*small_b + big_a*big_b in fp32
//   registers with mma.sync.m16n8k8.tf32 (small*small, below fp32's
//   precision, is dropped). Both halves are made in registers from the one
//   shared-memory copy of each tile, by full-rate integer and fp32 ALU work
//   (split_tf32) rather than cvt.rna.tf32.f32, which runs on the
//   conversion unit at 16 results a clock per SM.
// - The tensor cores add in fp32 but round toward zero, so over a long K
//   the error of one accumulator drifts one way (up to ~1e-4 against an
//   fp64 product at K = 2,304-4,608 with unit-scale operands). Each
//   stage's products are therefore summed from zero in a fresh mma
//   accumulator and then added to the running sum with an fp32 FADD, which
//   rounds to nearest: the truncation is confined to one stage's partial.
// - A ring of kStages shared-memory stages filled with cp.async: while the
//   warps multiply stage i, the copies of stages i+1 .. i+kStages-1 are in
//   flight. In load_stage B, the operand that streams, always takes
//   16-byte copies: a row that does not start on a 16-byte boundary (odd
//   N) is copied as an aligned window one chunk wider, and the fragment
//   reads skip its head. A (load_a) takes 16-byte copies where its rows
//   are aligned (K % 4 == 0) and 4-byte copies elsewhere. Past a ragged
//   edge the copy's source-size operand zero-fills, so no operand is ever
//   padded or sliced in device memory.
// - Warps tile the CTA tile in warp tiles of up to 32 x 32 (MT x NT mma
//   tiles of 16 x 8): 1 to 16 warps a CTA, each holding 32 running sums and
//   32 stage sums at most; A's stage rows are padded by 4 words and B's by 8
//   (16 for an 8-wide tile) so the fragment reads of a warp hit 32 distinct
//   banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {
namespace tc {

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Shape of one instantiated CTA tile.
template <int BM, int BN, int BK>
struct Tile {
  static constexpr int kStages = 3;
  static constexpr int WTM = BM < 32 ? BM : 32;    // warp tile rows
  static constexpr int WTN = BN < 32 ? BN : 32;    // warp tile columns
  static constexpr int WM = BM / WTM, WN = BN / WTN;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = WTM / 16, NT = WTN / 8;  // mma tiles per warp
  static constexpr int LDA = BK + 4;                 // A stage: BM rows of BK
  static constexpr int LDB = BN + (BN % 32 == 8 ? 16 : 8);  // B: BK rows of BN
  static constexpr int kStageFloats = BM * LDA + BK * LDB;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;
  static_assert(BM % 16 == 0 && BN % 8 == 0 && BK % 8 == 0, "mma granularity");
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

// Copy 16 bytes, of which the first `bytes` come from gmem and the rest
// are zero; both addresses 16-byte aligned. Also the bf16 loaders' copy
// (mma_bf16.cuh).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small + O(2^-21 |x|) as tf32 operands. big is x rounded to
// tf32's 10 mantissa bits, to nearest with ties away from zero as
// cvt.rna.tf32.f32 rounds: half a tf32 ulp added to the magnitude's bit
// pattern, then the 13 low bits cleared. small is x - big (exact) cut to
// tf32 toward zero, by clearing the same bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// c += a (16x8, row) @ b (8x8, col), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// First row and column of this thread's warp tile within the CTA tile.
template <int BM, int BN, int BK>
__device__ __forceinline__ int warp_row() {
  using T = Tile<BM, BN, BK>;
  return (threadIdx.x / 32 % T::WM) * T::WTM;
}
template <int BM, int BN, int BK>
__device__ __forceinline__ int warp_col() {
  using T = Tile<BM, BN, BK>;
  return (threadIdx.x / 32 / T::WM) * T::WTN;
}

// Issue the copies of A[m0:m0+BM, k0:k0+BK] into a stage, zero past M and
// K: 16-byte copies where a16 (K % 4 == 0, A 16-byte aligned), else 4-byte.
template <int BM, int BN, int BK>
__device__ __forceinline__ void load_a(float* As, const float* A, int M,
                                       int K, int m0, int k0, bool a16) {
  using T = Tile<BM, BN, BK>;
  const int tid = threadIdx.x;
  if (a16) {
    constexpr int CH = BK / 4;
#pragma unroll
    for (int i = 0; i < ceil_div(BM * CH, T::kThreads); ++i) {
      const int c = tid + i * T::kThreads;
      if (c >= BM * CH) break;
      const int r = c / CH, kc = (c % CH) * 4;
      const int m = m0 + r, k = k0 + kc;
      const bool ok = m < M && k < K;
      cp_async16(As + r * T::LDA + kc, ok ? A + (long long)m * K + k : A,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ceil_div(BM * BK, T::kThreads); ++i) {
      const int e = tid + i * T::kThreads;
      if (e >= BM * BK) break;
      const int r = e / BK, kc = e % BK;
      const int m = m0 + r, k = k0 + kc;
      const bool ok = m < M && k < K;
      cp_async4(As + r * T::LDA + kc, ok ? A + (long long)m * K + k : A, ok);
    }
  }
}

// Issue the copies of one stage: A[m0:m0+BM, k0:k0+BK], zero past M and
// K, and B[k0:k0+BK, n0:n0+BN].
//
// A row of B is copied as the BN/4 + 1 aligned 16-byte chunks from the one
// holding B[k][n0], whatever N is: stage row r then holds B[k0+r][n0 + c]
// at column c + (bmis + (k0 + r) * N) % 4, with bmis = (address of B / 4)
// % 4. The first chunk may start up to 3 floats before B[k][n0], at worst
// before the matrix, but in the same 16-byte block, so inside B's
// allocation; those floats are never read back. Floats past row k's end
// feed only output columns >= N, which are never stored. Chunks are
// clipped at the matrix's end, and rows past K are zero. As k0 is a
// multiple of BK, every stage row a thread reads in mma_tile (kk + t,
// kk + t + 4, t = lane % 4) has k = t mod 4 and the same shift,
// RowMajorStages::boff(t).
template <int BM, int BN, int BK>
__device__ __forceinline__ void load_stage(float* As, float* Bs,
                                           const float* A, const float* B,
                                           int M, int N, int K, int m0, int n0,
                                           int k0, bool a16, int bmis) {
  using T = Tile<BM, BN, BK>;
  const int tid = threadIdx.x;
  load_a<BM, BN, BK>(As, A, M, K, m0, k0, a16);
  constexpr int CH = BN / 4 + 1;
  const float* B16 = B - bmis;                      // 16-byte aligned
  const long long end = bmis + (long long)K * N;    // floats from B16
#pragma unroll
  for (int i = 0; i < ceil_div(BK * CH, T::kThreads); ++i) {
    const int c = tid + i * T::kThreads;
    if (c >= BK * CH) break;
    const int r = c / CH, j = c % CH;
    const int k = k0 + r;
    const long long at = ((bmis + (long long)k * N + n0) & ~3LL) + 4 * j;
    const long long left = k < K ? end - at : 0;
    const int bytes = left >= 4 ? 16 : left > 0 ? (int)left * 4 : 0;
    cp_async16(Bs + r * T::LDB + 4 * j, bytes ? B16 + at : B16, bytes);
  }
}

// matmul's stage loader: load_stage over row-major A (M, K) and B (K, N).
template <int BM, int BN, int BK>
struct RowMajorStages {
  const float* A;
  const float* B;
  int M, N, K, m0, n0;
  bool a16;
  int bmis;
  __device__ __forceinline__ void operator()(float* As, float* Bs,
                                             int k0) const {
    load_stage<BM, BN, BK>(As, Bs, A, B, M, N, K, m0, n0, k0, a16, bmis);
  }
  __device__ __forceinline__ int boff(int t) const {
    return (bmis + t * (N & 3)) & 3;               // see load_stage
  }
};

// acc += A[m0:m0+BM, kbeg:kend] @ B[kbeg:kend, n0:n0+BN], kbeg a multiple
// of BK. The loader's load(As, Bs, k0) issues the cp.async copies of the
// stage at k0: A's BM rows of BK into As (row stride Tile::LDA), B's BK
// rows of BN into Bs (row stride Tile::LDB), zero past the operands' ends.
// Every B element a thread with lane % 4 == t reads sits load.boff(t)
// floats right of its place in that layout (0 unless the loader shifts
// rows, as load_stage does). acc[mt][nt] is the mma C fragment of mma tile
// (mt, nt) of this thread's warp tile: it holds tile element (warp_row +
// 16 mt + g + 8 h, warp_col + 8 nt + 2 t + e) in [2 h + e], with g =
// lane / 4 and t = lane % 4. `smem` holds Tile::kSmemBytes, 16-byte
// aligned.
template <int BM, int BN, int BK, class Load>
__device__ __forceinline__ void mma_tile(
    const Load& load, int kbeg, int kend, float* smem,
    float (&acc)[Tile<BM, BN, BK>::MT][Tile<BM, BN, BK>::NT][4]) {
  using T = Tile<BM, BN, BK>;
  constexpr int S = T::kStages;
  const int steps = (kend - kbeg + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {      // prologue: stages 0 .. S-2
    if (s < steps) {
      float* As = smem + s * T::kStageFloats;
      load(As, As + BM * T::LDA, kbeg + s * BK);
    }
    cp_async_commit();                   // empty groups keep the count even
  }
  const int wr = warp_row<BM, BN, BK>(), wc = warp_col<BM, BN, BK>();
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int boff = load.boff(t);

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<S - 2>();              // this thread's copies of step i
    __syncthreads();                     // everyone's; step i-1 is consumed
    const int j = i + S - 1;             // refill the slot step i-1 used
    if (j < steps) {
      float* As = smem + (j % S) * T::kStageFloats;
      load(As, As + BM * T::LDA, kbeg + j * BK);
    }
    cp_async_commit();
    const float* As = smem + (i % S) * T::kStageFloats + wr * T::LDA;
    const float* Bs = smem + (i % S) * T::kStageFloats + BM * T::LDA + wc;
    float part[T::MT][T::NT][4] = {};    // this stage's products, from zero
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ab[T::MT][4], as[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const float* p = As + (mt * 16 + g) * T::LDA + kk + t;
        split_tf32(p[0], ab[mt][0], as[mt][0]);
        split_tf32(p[8 * T::LDA], ab[mt][1], as[mt][1]);
        split_tf32(p[4], ab[mt][2], as[mt][2]);
        split_tf32(p[8 * T::LDA + 4], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const float* q = Bs + (kk + t) * T::LDB + boff + nt * 8 + g;
        uint32_t bb[2], bs[2];
        split_tf32(q[0], bb[0], bs[0]);
        split_tf32(q[4 * T::LDB], bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          mma_tf32(part[mt][nt], as[mt], bb);
          mma_tf32(part[mt][nt], ab[mt], bs);
          mma_tf32(part[mt][nt], ab[mt], bb);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  cp_async_wait<0>();                    // only empty groups remain
}

}  // namespace tc
}  // namespace rt
