// Implicit-GEMM valid convolution with a fused epilogue:
//     out[n, k, oy, ox] = relu?(sum_{c,a,b} w[k, c, a, b] * x[n, c, oy*s + a, ox*s + b]
//                               + bias[k] + residual[n, k, oy, ox])
// batched (rt_conv_im2col_batch_*) and single-image (rt_conv_im2col_*), on
// Hopper's tensor cores: fp32 x and w at fp32 accuracy (3xTF32, *_f32) and
// bf16 x and w with fp32 accumulation (*_bf16), the output in x's type.
//
// Replaces two TPU kernels:
// - `conv_im2col_batch` (src/repro/kernels/im2col_gemm/im2col_gemm.py:155,
//   body `_conv_batch_kernel` :129, epilogue `_finish` :38): fused im2col +
//   GEMM whose (C*f*f, ow) patch block of each output row is built in VMEM
//   and fed to the MXU, so the patch matrix is never written to HBM; grid
//   (N, K blocks, output rows), bias / residual / ReLU finished on chip
//   before the store;
// - `conv_im2col` (im2col_gemm.py:76, body `_conv_kernel` :50): the same for
//   one (C, H, W) image, its residual transposed to (oh, K, ow) for the row
//   grid (im2col_gemm.py:108).
// Both are dtype-generic: on bf16 x and w they accumulate in fp32
// (`jnp.dot(..., preferred_element_type=f32)`, :66, :145), widen bias and
// residual to fp32 (:67-72, :146-151) and store x's dtype (:120, :202).
// The single-image entry point launches the batched kernel at N = 1: a
// (C, H, W) image and a (K, oh, ow) residual and output are the N = 1
// layouts, so the residual is read in place, without the transpose.
//
// The GEMM: M = output channels K, N = batch * output pixels P, reduction
// R = C*f*f in the reference's (c, a, b) order. A is the (K, R) weight
// matrix; B, the (R, P) patch matrix, is gathered stage by stage from x and
// never exists in device memory.
//
// What bounds it on the H100 (FLOPs and bytes as chip_smoke.py counts them,
// each operand read once): the served resnet18 / mix pass at b=8 (7 convs,
// 8.8 GFLOP) is bound by operations, 0.131 ms at the fp32 rate outside the
// tensor cores (67 TFLOP/s), ~0.06 ms at 3xTF32 (494.7 / 3 TFLOP/s); so is
// resnet18's 20 convs on one image (7.8 GFLOP, 0.117 and ~0.055 ms); at
// bf16 (989 TFLOP/s) both are bound by bytes. The edge_cnn / mix pass (5
// small convs) is bound by bytes, ~1.3 us, and in practice by launch and
// pipeline latency. The first version of this file (a 256-thread fp32 SIMT
// tile, fixed 128 x 64 tiles, no split) ran at 5-10% of those bounds:
// resnet18's late layers (512 -> 512, 3x3, on 7x7 to 3x3 inputs) gave 4
// CTAs a 4,608-long reduction each (~1 ms per layer), a 128-row tile
// computed half zeros on 64-channel layers, and every staged element cost
// four integer divisions.
//
// What the design does (the plan of each call comes from ops.cta_plan):
// 1. Tensor cores: fp32 at fp32 accuracy through the tile loop of
//    mma_tf32.cuh (3xTF32 mma.sync.m16n8k8), bf16 through mma_bf16.cuh's
//    (mma.sync.m16n8k16 bf16, fragments by ldmatrix), each stage's products
//    summed from zero and promoted to the running sum with a
//    round-to-nearest fp32 add, with this file's stage loader in place of
//    matmul's. A bf16 stage is twice as deep (BK 32 against 16): the same
//    bytes.
// 2. An implicit-GEMM patch loader (PatchStages). The threads stage 16
//    patch rows a pass (one pass of a fp32 stage, two of a bf16 one), each
//    thread one row of the pass for NC fixed output pixels. The x offset of
//    each pixel's patch origin, img*C*H*W + oy*s*W + ox*s, is computed once
//    per CTA and kept in registers; the offset of the row, c*H*W + a*W + b,
//    once per row and stage. fp32: each element is a 4-byte cp.async whose
//    source size zero-fills past R or past P. bf16: cp.async moves 4 bytes
//    at least, so each element is loaded and stored by plain instructions
//    (zero past R or P), before the barrier that publishes the stage, in
//    the layout the fragment reads expect. Nothing is padded. A, the
//    weights, takes matmul's A loader: 16-byte copies where its rows are
//    16-byte aligned (R % 4 == 0 fp32, R % 8 == 0 bf16), else 4-byte
//    copies (fp32) or element loads (bf16): R = 27 and 147 are on the
//    served paths.
// 3. Tiles fitted to the shape: BM the smallest instantiated size covering
//    K under the variant's ceiling, BN the same for P, so a 64-channel
//    layer runs a 64-row tile.
// 4. Deterministic split-K where the output tiles cannot give every SM a
//    CTA and 8 warps (resnet18's late layers, its 256 -> 512 stride-2
//    conv): blockIdx.z is the slice of R, each a whole number of BK steps;
//    fp32 partials go to a (split, N, K, oh*ow) workspace, and
//    splitk_reduce (epilogue.cuh, shared with matmul.cu) adds them in split
//    order and applies bias -> residual -> ReLU once, to the full sum,
//    rounding a bf16 output once, as the reference's fused store does. No
//    atomics.
// 5. No split where the grid fills the card: the epilogue is then fused
//    into the single store of each output element. A bf16 call reads its
//    bias and residual as bf16 or fp32 (epilogue.cuh's Ep) and widens them
//    to fp32.
//
// The Hopper route: bf16 calls with at least 64 output channels run
// conv_wgmma.cu (TMA weights, patches gathered by a producer warpgroup into
// a swizzled ring, warp-specialised wgmma; kernels/im2col_gemm/ops.route
// decides). TMA's own im2col mode describes a padded NHWC convolution
// window, not this NCHW layout with the reference's (c, a, b) patch order
// and valid padding; wgmma's 64-row warpgroup tile does not fit edge_cnn's
// 16-48 output channels, and it reads B from shared memory, where the
// 3xTF32 split needs two copies, so fp32 and narrow bf16 calls stay here.
#include <type_traits>

#include "epilogue.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using rt::bf::bf16;
using rt::tc::Ep;

template <class In>
constexpr bool kBf16 = std::is_same_v<In, bf16>;

// The CTA tile of operand type In: mma_tf32.cuh's for fp32, mma_bf16.cuh's
// for bf16 (the same warp tiling).
template <class In, int BM, int BN, int BK>
using TileOf = std::conditional_t<kBf16<In>, rt::bf::Tile<BM, BN, BK>,
                                  rt::tc::Tile<BM, BN, BK>>;

// Bias and residual as the kernel reads them: restricted fp32 pointers
// beside fp32 operands, Ep (bf16 or fp32) beside bf16 ones.
template <class In>
struct EpArg {
  using type = Ep;
};
template <>
struct EpArg<float> {
  typedef const float* __restrict__ type;
};
template <class In>
using EpOf = typename EpArg<In>::type;

// The stage loader of one thread (mma_tile's Load): the weights through the
// A loader; of the patch matrix, rows r, r + 16, ... of every stage for the
// NC output pixels n0 + (tid % TPR) + i * TPR of its CTA, i < NC, unshifted
// (boff 0).
template <class In, int BM, int BN, int BK>
struct PatchStages {
  using T = TileOf<In, BM, BN, BK>;
  static constexpr int ROWS = 16;                // patch rows a pass stages
  static constexpr int TPR = T::kThreads / ROWS; // threads per stage row
  static constexpr int NC = BN / TPR;            // pixels per thread
  static_assert(BK % ROWS == 0 && T::kThreads % ROWS == 0 && BN % TPR == 0,
                "patch stage layout");

  const In* x;
  const In* w;
  int K, m0, HW, W, f, ff, R, r;
  bool a16;
  int col[NC];       // x offset of each pixel's patch origin; -1 past P

  __device__ __forceinline__ PatchStages(const In* x_, const In* w_, int K_,
                                         int m0_, bool a16_, int C, int H,
                                         int W_, int f_, int s, int ow,
                                         int ohw, int P, int n0)
      : x(x_), w(w_), K(K_), m0(m0_), HW(H * W_), W(W_), f(f_), ff(f_ * f_),
        R(C * f_ * f_), r(threadIdx.x / TPR), a16(a16_) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int j = n0 + threadIdx.x % TPR + i * TPR;
      const int img = j / ohw, p = j - img * ohw;
      const int oy = p / ow, ox = p - oy * ow;
      col[i] = j < P ? img * C * HW + oy * s * W + ox * s : -1;
    }
  }

  // Fill the stage at k0: w[m0:m0+BM, k0:k0+BK] into As, patch rows k0 ..
  // k0 + BK into Bs (fp32: cp.async copies issued; bf16: stores done).
  __device__ __forceinline__ void operator()(In* As, In* Bs, int k0) const {
    if constexpr (kBf16<In>)
      rt::bf::load_block<BM, BK, T::LDA, T::kThreads>(As, w, K, R, m0, k0, a16);
    else
      rt::tc::load_a<BM, BN, BK>(As, w, K, R, m0, k0, a16);
#pragma unroll
    for (int pass = 0; pass < BK / ROWS; ++pass) {
      const int rr = r + pass * ROWS;
      const int k = k0 + rr;
      const int c = k / ff, rem = k - c * ff;
      const int a = rem / f, b = rem - a * f;
      const int off = c * HW + a * W + b;
      In* dst = Bs + rr * T::LDB + threadIdx.x % TPR;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const bool ok = k < R && col[i] >= 0;
        if constexpr (kBf16<In>)
          dst[i * TPR] = ok ? x[col[i] + off] : __float2bfloat16(0.f);
        else
          rt::tc::cp_async4(dst + i * TPR, ok ? x + col[i] + off : x, ok);
      }
    }
  }
  __device__ __forceinline__ int boff(int) const { return 0; }
};

// grid (P tiles, K tiles, split). Slice z walks BK steps [z * per,
// (z + 1) * per) of R; with split == 1 it stores the finished output, else
// its raw fp32 partial sum into ws[z]. Offsets into x, w and out fit in
// int32 (the wrapper refuses larger tensors); the workspace's are 64-bit.
//
// Occupancy: left to itself, ptxas holds the 256-thread 128 x 64 tile (the
// wide layers' tile) to one CTA, 8 warps, per SM. The launch bound asks for
// two CTAs and at least 12 warps an SM, which caps that tile at 128
// registers a thread and the others at 170, with no spills. (Capping every
// tile at 128 registers spills on the 32-wide tiles and makes them slower
// on an H100.)
__host__ __device__ constexpr int conv_min_blocks(int threads) {
  return 12 * 32 / threads > 2 ? 12 * 32 / threads : 2;
}

template <class In, int BM, int BN, int BK>
__global__ void __launch_bounds__(
    TileOf<In, BM, BN, BK>::kThreads,
    conv_min_blocks(TileOf<In, BM, BN, BK>::kThreads))
conv_kernel(const In* __restrict__ x, const In* __restrict__ w,
            EpOf<In> bias, EpOf<In> res, In* __restrict__ out,
            float* __restrict__ ws, int C, int H, int W, int K, int f, int s,
            int ow, int ohw, int P, int relu, int split, int a16) {
  using T = TileOf<In, BM, BN, BK>;
  extern __shared__ float4 smem4[];
  const int R = C * f * f;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int per = ((R + BK - 1) / BK + split - 1) / split;
  const int kbeg = z * per * BK, kend = min(R, kbeg + per * BK);
  const PatchStages<In, BM, BN, BK> load(x, w, K, m0, a16 != 0, C, H, W, f,
                                         s, ow, ohw, P, n0);
  float acc[T::MT][T::NT][4] = {};
  if constexpr (kBf16<In>)
    rt::bf::mma_tile<BM, BN, BK>(load, kbeg, kend,
                                 reinterpret_cast<bf16*>(smem4), acc);
  else
    rt::tc::mma_tile<BM, BN, BK>(load, kbeg, kend,
                                 reinterpret_cast<float*>(smem4), acc);

  // fp32 writes the output or its slice's workspace through one pointer
  // (the form ptxas allocated the fp32 tiles' registers for before bf16)
  float* dst = nullptr;
  if constexpr (!kBf16<In>) dst = split == 1 ? out : ws + z * (long long)K * P;
  // the warp tiling is the same for both tiles
  const int r0 = m0 + (threadIdx.x / 32 % T::WM) * T::WTM + threadIdx.x % 32 / 4;
  const int c0 = n0 + (threadIdx.x / 32 / T::WM) * T::WTN + threadIdx.x % 4 * 2;
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = c0 + nt * 8 + e;
      if (n >= P) continue;
      const int img = n / ohw, p = n - img * ohw;
      const int base = img * K * ohw + p;      // out[img, 0, p]
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r0 + mt * 16 + h * 8;
          if (m >= K) continue;
          const int idx = base + m * ohw;
          const float v = acc[mt][nt][2 * h + e];
          if constexpr (kBf16<In>) {
            if (split == 1)
              out[idx] = __float2bfloat16_rn(
                  rt::tc::finish(v, bias, res, m, idx, relu));
            else
              ws[z * (long long)K * P + idx] = v;
          } else {
            dst[idx] = split == 1 ? rt::tc::finish(v, bias, res, m, idx, relu)
                                  : v;
          }
        }
    }
}

template <class In, int BM, int BN, int BK>
int launch_tile(const In* x, const In* w, EpOf<In> bias, EpOf<In> res,
                In* out, float* ws, int N, int C, int H, int W, int K, int f,
                int s, int oh, int ow, int relu, int split,
                cudaStream_t stream) {
  using T = TileOf<In, BM, BN, BK>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_kernel<In, BM, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int R = C * f * f, ohw = oh * ow, P = N * ohw;
  const int mt = (K + BM - 1) / BM;
  if (mt > 65535 || split > 65535) return (int)cudaErrorInvalidValue;
  // A's 16-byte copies need 16-byte aligned weight rows: 4 fp32 or 8 bf16
  constexpr int V = 16 / sizeof(In);
  const bool a16 = R % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid((P + BN - 1) / BN, mt, split);
  conv_kernel<In, BM, BN, BK><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      x, w, bias, res, out, ws, C, H, W, K, f, s, ow, ohw, P, relu, split,
      a16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  return rt::tc::launch_splitk_reduce(ws, bias, res, out, K, ohw, split,
                                      (long long)K * P, relu, stream,
                                      kBf16<In>);
}

// Every (BM, BN, BK) CTA tile ops.cta_plan may choose (im2col_gemm.TILE_M,
// TILE_N, TILE_K / TILE_K_BF16): BM in 16..128, BN in 8..64, BK 16 for fp32
// and 32 for bf16 (a stage of the same bytes).
#define RT_CONV_BN(X, BM) X(BM, 8, 16) X(BM, 32, 16) X(BM, 64, 16)
#define RT_FOR_EACH_CONV_TILE(X) \
  RT_CONV_BN(X, 16) RT_CONV_BN(X, 32) RT_CONV_BN(X, 64) RT_CONV_BN(X, 128)
#define RT_CONV_BF16_BN(X, BM) X(BM, 8, 32) X(BM, 32, 32) X(BM, 64, 32)
#define RT_FOR_EACH_CONV_BF16_TILE(X)                                   \
  RT_CONV_BF16_BN(X, 16) RT_CONV_BF16_BN(X, 32) RT_CONV_BF16_BN(X, 64) \
      RT_CONV_BF16_BN(X, 128)

template <class In>
int launch(const In* x, const In* w, EpOf<In> bias, EpOf<In> res, In* out,
           float* ws, int N, int C, int H, int W, int K, int f, int s, int oh,
           int ow, int relu, int bm, int bn, int bk, int split,
           cudaStream_t stream) {
  // every split must own at least one BK step, and a split needs a workspace
  if (split < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  const int steps = (C * f * f + bk - 1) / bk;
  const int per = (steps + split - 1) / split;
  if (split > 1 && (ws == nullptr || (split - 1) * per >= steps))
    return (int)cudaErrorInvalidValue;
#define RT_LAUNCH(BM_, BN_, BK_)                                            \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                 \
    return launch_tile<In, BM_, BN_, BK_>(x, w, bias, res, out, ws, N, C, \
                                          H, W, K, f, s, oh, ow, relu,     \
                                          split, stream);
  if constexpr (kBf16<In>) {
    RT_FOR_EACH_CONV_BF16_TILE(RT_LAUNCH)
  } else {
    RT_FOR_EACH_CONV_TILE(RT_LAUNCH)
  }
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// bias or residual as the kernel of operand type In reads it; `is_bf16`
// says whether its elements are bf16 (never beside fp32 operands)
template <class In>
EpOf<In> ep_of(const void* p, int is_bf16) {
  if constexpr (kBf16<In>)
    return Ep{p, is_bf16};
  else
    return static_cast<const float*>(p);
}

}  // namespace

// Built twice (kernels/common.LIBRARIES): -DRT_FP32 gives the fp32 entry
// points, -DRT_BF16 the bf16 ones, so each build instantiates one dtype's
// tiles and the two compile in parallel.
#if defined(RT_FP32) == defined(RT_BF16)
#error "build im2col_gemm.cu with exactly one of -DRT_FP32 and -DRT_BF16"
#endif

// x (N, C, H, W), w (K, C, f, f) of the entry point's operand type, bias
// (K,) or null, res (N, K, oh, ow) or null, each fp32 or (bias_bf16,
// res_bf16; bf16 entry points only) bf16 -> out (N, K, oh, ow) in the
// operand type, all contiguous; ws (split, N, K, oh, ow) fp32 scratch when
// split > 1, else null. Returns cudaGetLastError() after the launches; an
// unknown tile, an illegal split or a bf16 epilogue tensor beside fp32
// operands returns cudaErrorInvalidValue without launching.
//
// The single-image entry points: x (C, H, W), res (K, oh, ow) -> out (K,
// oh, ow), ws (split, K, oh, ow): the batched kernel at N = 1.
#define RT_ENTRY_POINTS(In, SUFFIX)                                          \
  extern "C" int rt_conv_im2col_batch_##SUFFIX(                              \
      const In* x, const In* w, const void* bias, const void* res, In* out, \
      float* ws, int N, int C, int H, int W, int K, int f, int s, int oh,   \
      int ow, int relu, int bm, int bn, int bk, int split, int bias_bf16,   \
      int res_bf16, cudaStream_t stream) {                                  \
    if (!kBf16<In> && (bias_bf16 || res_bf16))                               \
      return (int)cudaErrorInvalidValue;                                    \
    return launch<In>(x, w, ep_of<In>(bias, bias_bf16),                     \
                      ep_of<In>(res, res_bf16), out, ws, N, C, H, W, K, f,  \
                      s, oh, ow, relu, bm, bn, bk, split, stream);          \
  }                                                                         \
  extern "C" int rt_conv_im2col_##SUFFIX(                                    \
      const In* x, const In* w, const void* bias, const void* res, In* out, \
      float* ws, int C, int H, int W, int K, int f, int s, int oh, int ow,  \
      int relu, int bm, int bn, int bk, int split, int bias_bf16,           \
      int res_bf16, cudaStream_t stream) {                                  \
    return rt_conv_im2col_batch_##SUFFIX(x, w, bias, res, out, ws, 1, C, H, \
                                         W, K, f, s, oh, ow, relu, bm, bn,  \
                                         bk, split, bias_bf16, res_bf16,    \
                                         stream);                           \
  }

#if defined(RT_FP32)
RT_ENTRY_POINTS(float, f32)
#else
RT_ENTRY_POINTS(bf16, bf16)
#endif
