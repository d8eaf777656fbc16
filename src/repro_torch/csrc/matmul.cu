// Tiled fp32 matmul with a fused epilogue: C = relu?(A @ B + bias + residual),
// single (rt_matmul_f32) and batched (rt_matmul_batch_f32).
//
// Replaces two TPU kernels:
// - `matmul` (src/repro/kernels/matmul/matmul.py:140, body `_matmul_kernel`
//   :44, epilogue `_finish` :33): a (bm, bk, bn) blocked MXU matmul with an
//   f32 VMEM accumulator, K innermost on the sequential grid, edges
//   zero-padded to block multiples, and bias (M,) -> residual (M, N) -> ReLU
//   applied to the finished tile before its single HBM store;
// - `matmul_batch` (matmul.py:87, body `_matmul_batch_kernel` :65): the same
//   walk with the batch as the leading grid axis, bias (M,) shared and
//   residual (B, M, N).
//
// Both entry points launch one template: the batched one puts the batch on
// blockIdx.z and offsets A and B by their own batch strides, so an operand
// broadcast over the batch (stride 0) is read in place and never copied per
// image; the single one is the same kernel at B = 1.
//
// On the H100 the grid's blocks run in parallel, so the K walk becomes a
// loop inside each CTA (gemm_tile.cuh) and the f32 accumulator lives in
// registers. Ragged edges are masked while staging tiles, so nothing is
// padded or sliced in device memory. The epilogue is fused before the one
// store of each output element, as in the TPU kernel: the activation is
// written once and never read back for a separate bias/residual/ReLU pass.
//
// Bound: on the plan's shapes (M = output channels, K = C*f*f, N = batch *
// output pixels) fp32 FMA at 67 TFLOP/s for wide layers, device memory at
// 3.35 TB/s for narrow ones. The design answers the FMA bound only with
// register blocking ((BM/16) x (BN/16) outputs per thread); tensor-core
// paths (3xTF32 to keep fp32 accuracy, wgmma, TMA) are later work.
#include "gemm_tile.cuh"

namespace {

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(rt::kThreads)
matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ bias, const float* __restrict__ res,
              float* __restrict__ C, int M, int N, int K, int relu,
              long long sA, long long sB) {
  const long long z = blockIdx.z;           // batch index; 0 when unbatched
  A += z * sA;
  B += z * sB;
  C += z * M * N;
  if (res) res += z * M * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[BM / 16][BN / 16] = {};
  rt::gemm_tile<BM, BN, BK>(M, N, K, m0, n0, rt::RowMajor{A, K},
                            rt::RowMajor{B, N}, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const long long idx = (long long)m * N + n;
      C[idx] = rt::finish(acc[i][j], bias, res, m, idx, relu);
    }
  }
}

int launch(const float* A, const float* B, const float* bias,
           const float* res, float* C, int Bn, int M, int N, int K, int relu,
           long long sA, long long sB, int bm, int bn, int bk,
           cudaStream_t stream) {
#define RT_LAUNCH(BM_, BN_, BK_)                                              \
  if (bm == BM_ && bn == BN_ && bk == BK_) {                                 \
    dim3 grid((N + BN_ - 1) / BN_, (M + BM_ - 1) / BM_, Bn);                 \
    matmul_kernel<BM_, BN_, BK_><<<grid, rt::kThreads, 0, stream>>>(         \
        A, B, bias, res, C, M, N, K, relu, sA, sB);                          \
    return (int)cudaGetLastError();                                          \
  }
  RT_FOR_EACH_TILE(RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A (M, K), B (K, N), bias (M,) or null, res (M, N) or null -> C (M, N), all
// fp32 row-major. Returns cudaGetLastError() after the launch; an unknown
// tile returns cudaErrorInvalidValue without launching.
extern "C" int rt_matmul_f32(const float* A, const float* B, const float* bias,
                             const float* res, float* C, int M, int N, int K,
                             int relu, int bm, int bn, int bk,
                             cudaStream_t stream) {
  return launch(A, B, bias, res, C, 1, M, N, K, relu, 0, 0, bm, bn, bk, stream);
}

// A (Bn, M, K) with batch stride sA, B (Bn, K, N) with batch stride sB (each
// matrix row-major; a stride of 0 broadcasts one matrix over the batch),
// bias (M,) or null, res (Bn, M, N) or null -> C (Bn, M, N) contiguous.
extern "C" int rt_matmul_batch_f32(const float* A, const float* B,
                                   const float* bias, const float* res,
                                   float* C, int Bn, int M, int N, int K,
                                   int relu, int sA, int sB, int bm, int bn,
                                   int bk, cudaStream_t stream) {
  return launch(A, B, bias, res, C, Bn, M, N, K, relu, sA, sB, bm, bn, bk,
                stream);
}
