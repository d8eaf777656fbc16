// Implicit-GEMM valid convolution with a fused epilogue:
//     out[n, k, oy, ox] = relu?(sum_{c,a,b} w[k, c, a, b] * x[n, c, oy*s + a, ox*s + b]
//                               + bias[k] + residual[n, k, oy, ox])
// batched (rt_conv_im2col_batch_f32) and single-image (rt_conv_im2col_f32).
//
// Replaces two TPU kernels:
// - `conv_im2col_batch` (src/repro/kernels/im2col_gemm/im2col_gemm.py:155,
//   body `_conv_batch_kernel` :129): fused im2col + GEMM whose (C*f*f, ow)
//   patch block of each output row is built in VMEM and fed to the MXU, so
//   the patch matrix is never written to HBM; grid (N, K blocks, output
//   rows), bias / residual / ReLU finished on chip before the store;
// - `conv_im2col` (im2col_gemm.py:76, body `_conv_kernel` :50): the same for
//   one (C, H, W) image, grid (K blocks, output rows), its residual
//   transposed to (oh, K, ow) for the row grid (im2col_gemm.py:108).
//
// The single-image entry point launches the same template at N = 1: a
// (C, H, W) image, a (K, oh, ow) residual and output are the N = 1 layouts,
// so the residual is read in place, without the TPU kernel's transpose.
//
// On the H100 the same idea is an implicit GEMM: M = output channels (the
// `conv-bk*` K-block is the CTA's M tile), N = batch * output pixels, K =
// C*f*f in the reference's (c, a, b) order. Each CTA stages its slice of the
// patch matrix — BK patch rows by BN output pixels — in shared memory
// straight from x with stride s (PatchLoader below), so the patch matrix
// never exists in device memory. Folding the batch into N keeps CTAs full on
// the small late layers (a 4x4 output is 16 pixels per image). The residual
// is read in its (N, K, oh, ow) layout; no transpose as the TPU kernel
// needed. f = 1 is the same kernel (conv-1x1 columns route here).
//
// Bound: fp32 FMA (67 TFLOP/s at 700 W) on the wide layers, device memory
// (3.35 TB/s) on the narrow ones. The gather costs integer index math per
// staged element; a later version would precompute the (c, a, b) offsets and
// use cp.async/TMA im2col mode.
#include "gemm_tile.cuh"

namespace {

// Patch-matrix element (k, j): k = (c, a, b), j = (image, oy, ox).
struct PatchLoader {
  const float* x;
  int C, H, W, f, s, ow, ohw;
  __device__ __forceinline__ float operator()(int k, int j) const {
    const int img = j / ohw, p = j - img * ohw;
    const int oy = p / ow, ox = p - oy * ow;
    const int ff = f * f;
    const int c = k / ff, r = k - c * ff;
    const int a = r / f, b = r - a * f;
    return x[(((long long)img * C + c) * H + oy * s + a) * W + ox * s + b];
  }
};

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(rt::kThreads)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, const float* __restrict__ res,
            float* __restrict__ out, int Nimg, int C, int H, int W, int K,
            int f, int s, int oh, int ow, int relu) {
  const int ohw = oh * ow;
  const int M = K, N = Nimg * ohw, R = C * f * f;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[BM / 16][BN / 16] = {};
  rt::gemm_tile<BM, BN, BK>(M, N, R, m0, n0, rt::RowMajor{w, R},
                            PatchLoader{x, C, H, W, f, s, ow, ohw}, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const int img = n / ohw, p = n - img * ohw;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= M) continue;
      const long long idx = ((long long)img * K + m) * ohw + p;
      out[idx] = rt::finish(acc[i][j], bias, res, m, idx, relu);
    }
  }
}

int launch(const float* x, const float* w, const float* bias,
           const float* res, float* out, int N, int C, int H, int W, int K,
           int f, int s, int oh, int ow, int relu, int bm, int bn, int bk,
           cudaStream_t stream) {
#define RT_LAUNCH(BM_, BN_, BK_)                                              \
  if (bm == BM_ && bn == BN_ && bk == BK_) {                                 \
    dim3 grid((N * oh * ow + BN_ - 1) / BN_, (K + BM_ - 1) / BM_);           \
    conv_kernel<BM_, BN_, BK_><<<grid, rt::kThreads, 0, stream>>>(           \
        x, w, bias, res, out, N, C, H, W, K, f, s, oh, ow, relu);            \
    return (int)cudaGetLastError();                                          \
  }
  RT_FOR_EACH_TILE(RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (N, C, H, W), w (K, C, f, f), bias (K,) or null, res (N, K, oh, ow) or
// null -> out (N, K, oh, ow), fp32 contiguous. Returns cudaGetLastError()
// after the launch; an unknown tile returns cudaErrorInvalidValue.
extern "C" int rt_conv_im2col_batch_f32(const float* x, const float* w,
                                        const float* bias, const float* res,
                                        float* out, int N, int C, int H, int W,
                                        int K, int f, int s, int oh, int ow,
                                        int relu, int bm, int bn, int bk,
                                        cudaStream_t stream) {
  return launch(x, w, bias, res, out, N, C, H, W, K, f, s, oh, ow, relu, bm,
                bn, bk, stream);
}

// x (C, H, W), w (K, C, f, f), bias (K,) or null, res (K, oh, ow) or null ->
// out (K, oh, ow), fp32 contiguous: the batched kernel at N = 1.
extern "C" int rt_conv_im2col_f32(const float* x, const float* w,
                                  const float* bias, const float* res,
                                  float* out, int C, int H, int W, int K,
                                  int f, int s, int oh, int ow, int relu,
                                  int bm, int bn, int bk, cudaStream_t stream) {
  return launch(x, w, bias, res, out, 1, C, H, W, K, f, s, oh, ow, relu, bm,
                bn, bk, stream);
}
