// Winograd point-GEMM: M[n, p] = U[p] @ V[n, p] for every image n and
// transform point p, with U (P, K, C) shared across the batch; batched
// (rt_winograd_point_gemm_batch_f32) and single-image
// (rt_winograd_point_gemm_f32).
//
// Replaces two TPU kernels:
// - `winograd_point_gemm_batch` (src/repro/kernels/winograd/winograd.py:77,
//   body `_point_gemm_batch_kernel` :64): grid (N, P, K tiles, T tiles,
//   C tiles) with the C reduction innermost on the sequential grid into an
//   f32 VMEM accumulator, inputs zero-padded to block multiples;
// - `winograd_point_gemm` (winograd.py:36, body `_point_gemm_kernel` :23):
//   the same for one image, grid (P, K tiles, T tiles, C tiles), under the
//   single-image `winograd_conv`.
// P = 16 for F(2x2, 3x3), 36 for F(4x4, 3x3); no epilogue — the bias /
// residual / ReLU run after the inverse transform (ops.winograd_conv*). The
// single-image entry point is the batched kernel at N = 1: a (P, C, T) V is
// the N = 1 layout.
//
// On the H100 each (n, p) pair is one blockIdx.z of a batched GEMM whose C
// walk is a loop inside the CTA (gemm_tile.cuh). U is addressed with batch
// stride 0 — every image's CTAs read U[p] in place, it is never copied per
// image — and ragged K / C / T edges are masked in the tile loads instead of
// padding U or V in device memory.
//
// Bound: the point-GEMMs are small (K, C up to 512, T = tiles per image), so
// at serving batch sizes they sit near the memory bound (3.35 TB/s) more
// than the fp32 FMA bound (67 TFLOP/s at 700 W). Later work: fuse the input
// and inverse transforms into the GEMM so V and M never reach device memory.
#include "gemm_tile.cuh"

namespace {

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(rt::kThreads)
point_gemm_kernel(const float* __restrict__ U, const float* __restrict__ V,
                  float* __restrict__ O, int P, int K, int C, int T) {
  const int z = blockIdx.z;                 // z = n * P + p
  const float* A = U + (long long)(z % P) * K * C;   // batch stride 0
  const float* B = V + (long long)z * C * T;
  float* out = O + (long long)z * K * T;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[BM / 16][BN / 16] = {};
  rt::gemm_tile<BM, BN, BK>(K, T, C, m0, n0, rt::RowMajor{A, C},
                            rt::RowMajor{B, T}, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= K) continue;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int t = n0 + tx + 16 * j;
      if (t < T) out[(long long)m * T + t] = acc[i][j];
    }
  }
}

int launch(const float* U, const float* V, float* O, int N, int P, int K,
           int C, int T, int bm, int bn, int bk, cudaStream_t stream) {
#define RT_LAUNCH(BM_, BN_, BK_)                                              \
  if (bm == BM_ && bn == BN_ && bk == BK_) {                                 \
    dim3 grid((T + BN_ - 1) / BN_, (K + BM_ - 1) / BM_, N * P);              \
    point_gemm_kernel<BM_, BN_, BK_><<<grid, rt::kThreads, 0, stream>>>(     \
        U, V, O, P, K, C, T);                                                \
    return (int)cudaGetLastError();                                          \
  }
  RT_FOR_EACH_TILE(RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// U (P, K, C), V (N, P, C, T) -> O (N, P, K, T), fp32 contiguous. Returns
// cudaGetLastError() after the launch; an unknown tile returns
// cudaErrorInvalidValue.
extern "C" int rt_winograd_point_gemm_batch_f32(const float* U, const float* V,
                                                float* O, int N, int P, int K,
                                                int C, int T, int bm, int bn,
                                                int bk, cudaStream_t stream) {
  return launch(U, V, O, N, P, K, C, T, bm, bn, bk, stream);
}

// U (P, K, C), V (P, C, T) -> O (P, K, T), fp32 contiguous: the batched
// kernel at N = 1.
extern "C" int rt_winograd_point_gemm_f32(const float* U, const float* V,
                                          float* O, int P, int K, int C, int T,
                                          int bm, int bn, int bk,
                                          cudaStream_t stream) {
  return launch(U, V, O, 1, P, K, C, T, bm, bn, bk, stream);
}
