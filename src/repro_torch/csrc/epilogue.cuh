// The fused epilogue and the deterministic split-K reduction shared by the
// tensor-core kernels (matmul.cu, im2col_gemm.cu, winograd.cu).
//
// Each writes an output laid out as (batch, M, N) row-major per batch
// entry: matmul's (Bn, M, N), the conv's (N images, K channels, oh * ow
// pixels), the Winograd point-GEMM's (N images * P points, K, T tiles). A
// split call stores each K slice's raw partial sum to a
// workspace (split, batch, M, N); splitk_reduce then adds the slices in
// split order and applies the epilogue once, to the full sum. No atomics:
// two calls on the same inputs give bit-identical outputs.
#pragma once

#include <cuda_runtime.h>

namespace rt {
namespace tc {

// The fused epilogue, in the reference's order: bias -> residual -> ReLU.
__device__ __forceinline__ float finish(float v, const float* bias,
                                        const float* res, int m, long long idx,
                                        int relu) {
  if (bias) v += bias[m];
  if (res) v += res[idx];
  if (relu) v = fmaxf(v, 0.f);
  return v;
}

// C[i] = epilogue(ws[0][i] + ws[1][i] + ... + ws[split-1][i]), in that
// order, over the `total` = batch * M * N outputs; bias is indexed by the
// row m of element i.
static __global__ void splitk_reduce(const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ res,
                                     float* __restrict__ C, int M, int N,
                                     int split, long long total, int relu) {
  const long long MN = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < split; ++s) v += ws[s * total + i];
    C[i] = finish(v, bias, res, (int)(i % MN / N), i, relu);
  }
}

// Launch splitk_reduce over the `total` outputs on `stream`; returns
// cudaGetLastError().
static inline int launch_splitk_reduce(const float* ws, const float* bias,
                                       const float* res, float* C, int M,
                                       int N, int split, long long total,
                                       int relu, cudaStream_t stream) {
  const long long blocks = (total + 255) / 256;
  splitk_reduce<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      ws, bias, res, C, M, N, split, total, relu);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace rt
