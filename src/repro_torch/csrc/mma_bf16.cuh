// bf16 GEMM tile loop on Hopper's tensor cores, f32 accumulation, fed by a
// cp.async ring: the bf16 counterpart of mma_tf32.cuh, used by matmul.cu for
// bf16 operands (rt_matmul_bf16, rt_matmul_batch_bf16), and its fragment
// helpers (ldmatrix, mma_bf16, pack_bf16, split_bf16, load_block), which
// flash_attention.cu's bf16 kernel shares.
//
// - mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: the product of two
//   bf16 values is exact in fp32, so with fp32 accumulation a tile computes
//   the reference's jnp.dot(bf16, bf16, preferred_element_type=f32) up to the
//   order of the sums. As in mma_tf32.cuh, each stage's products are summed
//   from zero in a fresh accumulator and added to the running sum with an
//   fp32 FADD, which rounds to nearest: the tensor cores' own adds round
//   toward zero, and the truncation stays confined to one stage's partial.
// - Shared memory holds the bf16 values as they are in device memory: a
//   stage is BM rows of BK for A and BK rows of BN for B, rows padded by 8
//   elements (16 bytes), so every row starts on a 16-byte boundary and the 8
//   row addresses of one ldmatrix phase fall in 8 distinct 16-byte bank
//   groups. BK is a multiple of 16, one mma step.
// - Fragments come from ldmatrix: A's 16x16 step as one .x4 (matrices rows
//   0-7 / 8-15 by columns 0-7 / 8-15, in the order of the mma's a0..a3), B's
//   16x8 column operand by .trans from B's row-major stage rows, two 8-wide
//   column tiles per .x4 (one per .x2 for an 8-wide warp tile).
// - The loader copies 16-byte chunks with cp.async (zero-filled past the
//   ragged edge) where an operand's rows are 16-byte aligned: K % 8 == 0 for
//   A, N % 8 == 0 for B, base addresses and batch strides to match. An
//   operand with unaligned rows (K = C * f * f = 147, N = oh * ow = 11,881)
//   is copied element by element with plain loads into the same layout
//   instead: its stage is written before the barrier that publishes it, so
//   the fragment reads need not know which loader ran. No operand is ever
//   padded or copied in device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace rt {
namespace bf {

using bf16 = __nv_bfloat16;
using rt::tc::ceil_div;
using rt::tc::cp_async16;
using rt::tc::cp_async_commit;
using rt::tc::cp_async_wait;

// Shape of one instantiated CTA tile: the warp tiling of mma_tf32.cuh's
// Tile (warp tiles of up to 32 x 32, MT x NT mma tiles of 16 x 8), bf16
// stages.
template <int BM, int BN, int BK>
struct Tile {
  static constexpr int kStages = 3;
  static constexpr int WTM = BM < 32 ? BM : 32;    // warp tile rows
  static constexpr int WTN = BN < 32 ? BN : 32;    // warp tile columns
  static constexpr int WM = BM / WTM, WN = BN / WTN;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = WTM / 16, NT = WTN / 8;  // mma tiles per warp
  static constexpr int LDA = BK + 8;                 // A stage: BM rows of BK
  static constexpr int LDB = BN + 8;                 // B stage: BK rows of BN
  static constexpr int kStageElems = BM * LDA + BK * LDB;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
  static_assert(BM % 16 == 0 && BN % 8 == 0 && BK % 16 == 0, "mma granularity");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load two column tiles");
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, in r[i], elements (l / 4, 2 (l % 4)) and (l / 4,
// 2 (l % 4) + 1) of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The same, each matrix transposed: r[i] holds elements (2 (l % 4), l / 4)
// and (2 (l % 4) + 1, l / 4) of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// Two transposed matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16x16, row) @ b (16x8, col), bf16 operands, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values rounded to nearest bf16 in one register, lo in the low
// half (the lower-indexed element of an mma fragment register).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The pair (a, b) as two bf16 pairs: hi rounded to nearest, lo the rest
// (a - hi, exact in fp32) rounded to nearest, so hi + lo carries about 16
// bits of each (flash_attention.cu's P).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// Issue the copies of rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a
// row-major (R, C) bf16 matrix into a stage of row stride LD, zero past R
// and C. `v16`: rows 16-byte aligned (C % 8 == 0 and the matrix 16-byte
// aligned), so 16-byte cp.async chunks each lie wholly inside or outside
// the matrix; else every element is loaded and stored by itself.
template <int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_block(bf16* dst, const bf16* src, int R,
                                           int C, int r0, int c0, bool v16) {
  const int tid = threadIdx.x;
  if (v16) {
    constexpr int CH = COLS / 8;
#pragma unroll
    for (int i = 0; i < ceil_div(ROWS * CH, THREADS); ++i) {
      const int c = tid + i * THREADS;
      if (c >= ROWS * CH) break;
      const int r = c / CH, j = (c % CH) * 8;
      const bool ok = r0 + r < R && c0 + j < C;
      cp_async16(dst + r * LD + j,
                 ok ? src + (long long)(r0 + r) * C + c0 + j : src, ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll 4
    for (int i = 0; i < ceil_div(ROWS * COLS, THREADS); ++i) {
      const int e = tid + i * THREADS;
      if (e >= ROWS * COLS) break;
      const int r = e / COLS, j = e % COLS;
      const bool ok = r0 + r < R && c0 + j < C;
      dst[r * LD + j] = ok ? src[(long long)(r0 + r) * C + c0 + j] : zero;
    }
  }
}

// matmul's stage loader over row-major A (M, K) and B (K, N): A's BM rows
// of BK from (m0, k0), B's BK rows of BN from (k0, n0).
template <int BM, int BN, int BK>
struct RowMajorStages {
  const bf16* A;
  const bf16* B;
  int M, N, K, m0, n0;
  bool a16, b16;
  __device__ __forceinline__ void operator()(bf16* As, bf16* Bs, int k0) const {
    using T = Tile<BM, BN, BK>;
    load_block<BM, BK, T::LDA, T::kThreads>(As, A, M, K, m0, k0, a16);
    load_block<BK, BN, T::LDB, T::kThreads>(Bs, B, K, N, k0, n0, b16);
  }
};

// acc += A[m0:m0+BM, kbeg:kend] @ B[kbeg:kend, n0:n0+BN], kbeg a multiple of
// BK. The loader's load(As, Bs, k0) fills the stage at k0 (A's BM rows of
// BK at row stride Tile::LDA, B's BK rows of BN at Tile::LDB, zero past the
// operands' ends) by cp.async or by plain stores. acc[mt][nt] is the mma C
// fragment of mma tile (mt, nt) of this thread's warp tile: tile element
// (warp_row + 16 mt + g + 8 h, warp_col + 8 nt + 2 t + e) in [2 h + e], g =
// lane / 4, t = lane % 4. `smem` holds Tile::kSmemBytes, 16-byte aligned.
template <int BM, int BN, int BK, class Load>
__device__ __forceinline__ void mma_tile(
    const Load& load, int kbeg, int kend, bf16* smem,
    float (&acc)[Tile<BM, BN, BK>::MT][Tile<BM, BN, BK>::NT][4]) {
  using T = Tile<BM, BN, BK>;
  constexpr int S = T::kStages;
  const int steps = (kend - kbeg + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {      // prologue: stages 0 .. S-2
    if (s < steps) {
      bf16* As = smem + s * T::kStageElems;
      load(As, As + BM * T::LDA, kbeg + s * BK);
    }
    cp_async_commit();                   // empty groups keep the count even
  }
  const int lane = threadIdx.x % 32;
  const int wr = warp_row<BM, BN, BK>(), wc = warp_col<BM, BN, BK>();
  // this lane's ldmatrix row: A rows wr + 16 mt + lane % 16 at column
  // lane / 16 * 8; B (stage) rows lane % 16 at column wc + lane / 16 * 8
  const int a_off = (wr + lane % 16) * T::LDA + lane / 16 * 8;
  const int b_off = (lane % 16) * T::LDB + wc + (T::NT == 1 ? 0 : lane / 16 * 8);

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<S - 2>();              // this thread's copies of step i
    __syncthreads();                     // everyone's; step i-1 is consumed
    const int j = i + S - 1;             // refill the slot step i-1 used
    if (j < steps) {
      bf16* As = smem + (j % S) * T::kStageElems;
      load(As, As + BM * T::LDA, kbeg + j * BK);
    }
    cp_async_commit();
    const bf16* As = smem + (i % S) * T::kStageElems;
    const bf16* Bs = As + BM * T::LDA;
    float part[T::MT][T::NT][4] = {};    // this stage's products, from zero
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[T::MT][4], b[T::NT][2];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldsm_x4(a[mt], As + a_off + mt * 16 * T::LDA + kk);
      if constexpr (T::NT == 1) {
        ldsm_x2_t(b[0], Bs + b_off + kk * T::LDB);
      } else {
#pragma unroll
        for (int nt = 0; nt < T::NT; nt += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, Bs + b_off + kk * T::LDB + nt * 8);
          b[nt][0] = r[0];
          b[nt][1] = r[1];
          b[nt + 1][0] = r[2];
          b[nt + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) mma_bf16(part[mt][nt], a[mt], b[nt]);
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

}  // namespace bf
}  // namespace rt
