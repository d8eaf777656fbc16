// The fused epilogue and the deterministic split-K reduction shared by the
// tensor-core kernels (matmul.cu, im2col_gemm.cu, winograd.cu).
//
// Each writes an output laid out as (batch, M, N) row-major per batch
// entry: matmul's (Bn, M, N), the conv's (N images, K channels, oh * ow
// pixels), the Winograd point-GEMM's (N images * P points, K, T tiles). A
// split call stores each K slice's raw partial sum to an fp32
// workspace (split, batch, M, N); splitk_reduce then adds the slices in
// split order and applies the epilogue once, to the full sum. No atomics:
// two calls on the same inputs give bit-identical outputs.
//
// The epilogue runs in fp32 on the fp32 accumulator, as the reference's
// `_finish` does (src/repro/kernels/matmul/matmul.py:33-41): bias and
// residual are read as fp32 pointers (the conv kernels) or as `Ep`, whose
// type, fp32 or bf16, is known only at run time (matmul.cu: either, whatever
// the operands' type), and widened to fp32; the result is stored once, as
// fp32 or rounded to nearest bf16 (`store`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {
namespace tc {

// An epilogue operand, bias or residual, of fp32 or (`bf16`) bf16
// elements; `p` is null where the call has none.
struct Ep {
  const void* p;
  int bf16;
  __device__ __forceinline__ explicit operator bool() const {
    return p != nullptr;
  }
  __device__ __forceinline__ float operator[](long long i) const {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
  }
  // the operand `i` elements further on
  __device__ __forceinline__ Ep offset(long long i) const {
    return {p ? static_cast<const char*>(p) + i * (bf16 ? 2 : 4) : nullptr,
            bf16};
  }
};

// The fused epilogue, in the reference's order: bias -> residual -> ReLU.
// P is `const float*` or `Ep`.
template <class P>
__device__ __forceinline__ float finish(float v, P bias, P res, int m,
                                        long long idx, int relu) {
  if (bias) v += bias[m];
  if (res) v += res[idx];
  if (relu) v = fmaxf(v, 0.f);
  return v;
}

// C[idx] = v, C fp32, or bf16 rounded to nearest where out_bf16.
__device__ __forceinline__ void store(void* C, long long idx, float v,
                                      int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(C)[idx] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(C)[idx] = v;
}

// C[i] = epilogue(ws[0][i] + ws[1][i] + ... + ws[split-1][i]), in that
// order, over the `total` = batch * M * N outputs; bias is indexed by the
// row m of element i.
template <class P>
static __global__ void splitk_reduce(const float* __restrict__ ws, P bias,
                                     P res, void* __restrict__ C, int M, int N,
                                     int split, long long total, int relu,
                                     int out_bf16) {
  const long long MN = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < split; ++s) v += ws[s * total + i];
    store(C, i, finish(v, bias, res, (int)(i % MN / N), i, relu), out_bf16);
  }
}

// Launch splitk_reduce over the `total` outputs on `stream`; returns
// cudaGetLastError().
template <class P>
static inline int launch_splitk_reduce(const float* ws, P bias, P res,
                                       void* C, int M, int N,
                                       int split, long long total, int relu,
                                       cudaStream_t stream, int out_bf16 = 0) {
  const long long blocks = (total + 255) / 256;
  splitk_reduce<P><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      ws, bias, res, C, M, N, split, total, relu, out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace rt
