// Shared fp32 GEMM tile loop for the port's three hand-written kernels
// (matmul.cu, im2col_gemm.cu, winograd.cu). Each kernel keeps its own entry
// point, operand loaders and epilogue; only the CTA tile walk lives here.
//
// One CTA of 256 threads (16 x 16) computes a BM x BN tile of
//     C[m, n] = sum_k A(m, k) * B(k, n)
// walking K in steps of BK: every step stages a BK x BM slice of A and a
// BK x BN slice of B in shared memory (zero-filled past the ragged edges, so
// no operand is ever padded in device memory), then each thread accumulates
// its (BM/16) x (BN/16) sub-tile in registers with fp32 FMA. Thread (ty, tx)
// owns rows ty + 16*i and columns tx + 16*j: consecutive threads read
// consecutive shared-memory words (no bank conflicts) and store consecutive
// output columns (coalesced).
//
// What bounds it on the H100: fp32 FMA outside the tensor cores (67 TFLOP/s
// dense at 700 W) for the large layers, device memory (3.35 TB/s) for the
// small ones. This first version is a plain shared-memory tiling: no
// double buffering, no cp.async/TMA, no wgmma, and no TF32 (the reference
// holds fp32 to 1e-4). Those are later work.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int kThreads = 256;

// Every (BM, BN, BK) CTA tile the launchers instantiate; ops.py maps each
// TPU block variant onto one of these.
#define RT_FOR_EACH_TILE(X) \
  X(64, 64, 8) X(64, 64, 16) X(64, 128, 8) X(64, 128, 16) \
  X(128, 64, 8) X(128, 64, 16) X(128, 128, 8) X(128, 128, 16)

// Row-major matrix operand: element (r, c) at p[r * ld + c].
struct RowMajor {
  const float* p;
  long long ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return p[r * ld + c];
  }
};

// acc += A[m0:m0+BM, :K] @ B[:K, n0:n0+BN]. la(m, k) and lb(k, n) are only
// called in range (m < M, k < K, n < N); outside it the tile holds zeros.
template <int BM, int BN, int BK, class LoadA, class LoadB>
__device__ __forceinline__ void gemm_tile(int M, int N, int K, int m0, int n0,
                                          const LoadA& la, const LoadB& lb,
                                          float (&acc)[BM / 16][BN / 16]) {
  constexpr int TM = BM / 16, TN = BN / 16;
  static_assert((BM * BK) % kThreads == 0 && (BK * BN) % kThreads == 0,
                "tile must split evenly over the CTA");
  static_assert(kThreads % BN == 0, "a thread keeps one B column per tile");
  // +4 pads A's rows: the transposing store As[kk][mm] is conflict-free
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nn = tid % BN;         // this thread's B column in every step
  const int n = n0 + nn;
  const bool n_ok = n < N;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int mm = idx / BK, kk = idx % BK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? la(m, k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / kThreads; ++i) {
      const int kk = tid / BN + i * (kThreads / BN);
      const int k = k0 + kk;
      Bs[kk][nn] = (n_ok && k < K) ? lb(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The fused epilogue, in the reference's order: bias -> residual -> ReLU.
__device__ __forceinline__ float finish(float v, const float* bias,
                                        const float* res, int m, long long idx,
                                        int relu) {
  if (bias) v += bias[m];
  if (res) v += res[idx];
  if (relu) v = fmaxf(v, 0.f);
  return v;
}

}  // namespace rt
