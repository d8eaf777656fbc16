// Matmul with a fused epilogue, C = relu?(A @ B + bias + residual), on
// Hopper's tensor cores: fp32 operands at fp32 accuracy (3xTF32,
// rt_matmul_f32, rt_matmul_batch_f32) and bf16 operands with fp32
// accumulation (rt_matmul_bf16, rt_matmul_batch_bf16); in either case
// bias and residual are each read as fp32 or bf16 (matmul.py passes the
// operands' type or fp32) and the output is stored as fp32 or bf16
// (`out_bf16`).
//
// Two routes share the bf16 entry points' contract (kernels/matmul/ops.route
// picks one per call before anything launches, and neither falls back to
// the other). bf16 operands TMA can address (M >= 64, K and N multiples of
// 8, 16-byte aligned bases and batch strides: every LM GEMM site of the
// matmul-site autotune, 3 of resnet18's 20 convs as GEMMs) take
// matmul_wgmma.cu: TMA, warpgroup MMA, clusters sharing B, persistent.
// This file's bf16 tiles take the rest (K or N off a multiple of 8, such
// as resnet18's K = 147 and N = oh ow = 11,881, M < 64, unaligned views)
// and every call that names the
// mma.sync route; fp32 operands always run here. What bounds the mma.sync
// bf16 tiles: mma.sync from ldmatrix fragments reaches at most a quarter of
// the bf16 tensor-core rate (1.47-5.57x bf16 torch.matmul's time at the LM
// sites), which is why the aligned calls moved to wgmma.
//
// Replaces two TPU kernels:
// - `matmul` (src/repro/kernels/matmul/matmul.py:140, body `_matmul_kernel`
//   :44, epilogue `_finish` :33): a (bm, bk, bn) blocked MXU matmul with an
//   f32 VMEM accumulator, K innermost on the sequential grid, edges
//   zero-padded to block multiples, and bias (M,) -> residual (M, N) -> ReLU
//   applied to the finished tile before its single HBM store in `out_dtype`
//   (the operands' dtype by default; the reference's own test sweeps it at
//   bf16);
// - `matmul_batch` (matmul.py:87, body `_matmul_batch_kernel` :65): the same
//   walk with the batch as the leading grid axis, bias (M,) shared and
//   residual (B, M, N).
//
// What bounds it on the H100. The served edge_cnn plan (fp32; M = 16-96
// output channels, K = C*f*f = 27-1,152, N = batch * output pixels =
// 32-7,200) is bound by bytes: its 14 GEMMs at b=8 move 30.4 MB for 0.38
// GFLOP (9.1 us at 3.35 TB/s against 5.6 us of fp32 operations), so what
// counts is that the card is filled and no tile computes on zeros.
// resnet18's 20 convs as per-image GEMMs at b=8 (M = 64-512, K up to 4,608,
// N = 1-11,881 per image; 58.7 GFLOP) are bound by operations at the fp32
// rate outside the tensor cores (0.886 ms at 67 TFLOP/s), by bytes once
// 3xTF32 runs them at 494.7 / 3 = 164.9 TFLOP/s (0.526 ms of traffic,
// mostly the unfolded patches B, against 0.356 ms of operations), and by
// bytes at bf16 (989 TFLOP/s: 0.059 ms of operations against 0.263 ms of
// 2-byte traffic). Its late layers (N = 25, 9, 1 per image) give few output
// tiles for a long reduction.
//
// What the design does (the plan of each call comes from ops.cta_plan):
// 1. fp32 operands: tensor cores at fp32 accuracy, 3xTF32 mma.sync.m16n8k8
//    (mma_tf32.cuh), both halves of both operands split in registers from
//    one shared-memory tile each. bf16 operands: one mma.sync.m16n8k16 bf16
//    step per fragment (mma_bf16.cuh), fragments by ldmatrix, the stage's K
//    depth twice fp32's so a stage holds the same bytes. Either way each
//    stage's products are summed from zero before an fp32 add into the
//    running sum (the tensor cores' own adds round toward zero). wgmma's
//    64-row warpgroup tile does not fit M = 16-96, and at fp32 it reads B
//    from shared memory, where the split would need two copies.
// 2. A 3-stage cp.async ring for the A and B tiles. fp32: B, which streams,
//    always moves in 16-byte copies (a row of odd N as an aligned window one
//    chunk wider); A in 16-byte copies where K % 4 == 0, else 4-byte ones (K
//    = 27). bf16: 16-byte copies of an operand whose rows are 16-byte
//    aligned (K % 8 == 0 for A, N % 8 == 0 for B), plain element loads into
//    the same stage layout otherwise. Ragged edges zero-filled by the copy
//    itself; nothing is padded.
// 3. Tiles fitted to the shape: BM and BN are the smallest instantiated
//    sizes covering M and N under the variant's ceiling, so an M = 16 layer
//    runs a 16-row tile instead of a 128-row tile that is 87% zeros.
// 4. Deterministic split-K where the output tiles cannot fill the 132 SMs:
//    blockIdx.z carries (batch, split); each split covers a whole number of
//    BK steps and stores its raw fp32 partial tile to a workspace the
//    wrapper allocates; splitk_reduce (epilogue.cuh) then adds the partials
//    in split order and applies bias -> residual -> ReLU once, to the full
//    sum, storing in the output's type. No atomics: two calls on the same
//    inputs give bit-identical outputs.
// 5. No split where the grid already fills the card: the epilogue is then
//    fused into the single store of each output element, as in the TPU
//    kernel, and the output is written once and never read back.
//
// The batch is on blockIdx.z; A and B are offset by their own batch strides,
// so an operand broadcast over the batch (stride 0) is read in place.
#include <type_traits>

#include "epilogue.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using rt::bf::bf16;
using rt::tc::Ep;
using rt::tc::finish;

// The CTA tile of operand type In: mma_tf32.cuh's for fp32, mma_bf16.cuh's
// for bf16 (the same warp tiling).
template <class In, int BM, int BN, int BK>
using TileOf = std::conditional_t<std::is_same_v<In, float>,
                                  rt::tc::Tile<BM, BN, BK>,
                                  rt::bf::Tile<BM, BN, BK>>;

// grid (N tiles, M tiles, Bn * split). Split s of batch entry z walks BK
// steps [s * per, (s + 1) * per) of K; with split == 1 it stores the
// finished output (fp32, or bf16 where out_bf16), else its raw partial sum
// into ws[s][z]. a16 / b16: A's / B's rows are 16-byte aligned in every
// batch entry (the bf16 loader's choice; fp32 takes B's alignment per row).
template <class In, int BM, int BN, int BK>
__global__ void __launch_bounds__(TileOf<In, BM, BN, BK>::kThreads)
matmul_kernel(const In* __restrict__ A, const In* __restrict__ B,
              Ep bias, Ep res, void* __restrict__ C, float* __restrict__ ws,
              int M, int N, int K, int relu, int split, int a16, int b16,
              long long sA, long long sB, int out_bf16) {
  using T = TileOf<In, BM, BN, BK>;
  extern __shared__ float4 smem4[];
  const int Bn = gridDim.z / split;
  const int z = blockIdx.z % Bn, s = blockIdx.z / Bn;
  const long long MN = (long long)M * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int per = ((K + BK - 1) / BK + split - 1) / split;
  const int kbeg = s * per * BK, kend = min(K, kbeg + per * BK);
  const In* Az = A + z * sA;
  const In* Bz = B + z * sB;
  float acc[T::MT][T::NT][4] = {};
  if constexpr (std::is_same_v<In, float>) {
    const int bmis = (int)(reinterpret_cast<uintptr_t>(Bz) / 4 % 4);
    const rt::tc::RowMajorStages<BM, BN, BK> load{Az, Bz, M, N, K, m0,
                                                 n0, a16 != 0, bmis};
    rt::tc::mma_tile<BM, BN, BK>(load, kbeg, kend,
                                 reinterpret_cast<float*>(smem4), acc);
  } else {
    const rt::bf::RowMajorStages<BM, BN, BK> load{Az, Bz, M, N, K, m0,
                                                 n0, a16 != 0, b16 != 0};
    rt::bf::mma_tile<BM, BN, BK>(load, kbeg, kend,
                                 reinterpret_cast<bf16*>(smem4), acc);
  }

  const long long base = split == 1 ? z * MN : (s * (long long)Bn + z) * MN;
  res = res.offset(z * MN);
  // the warp tiling is the same for both tiles
  const int r0 = m0 + (threadIdx.x / 32 % T::WM) * T::WTM + threadIdx.x % 32 / 4;
  const int c0 = n0 + (threadIdx.x / 32 / T::WM) * T::WTN + threadIdx.x % 4 * 2;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + mt * 16 + h * 8;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = c0 + nt * 8 + e;
          if (n >= N) continue;
          const long long idx = (long long)m * N + n;
          const float v = acc[mt][nt][2 * h + e];
          if (split == 1)
            rt::tc::store(C, base + idx, finish(v, bias, res, m, idx, relu),
                          out_bf16);
          else
            ws[base + idx] = v;
        }
      }
}

template <class In, int BM, int BN, int BK>
int launch_tile(const In* A, const In* B, Ep bias, Ep res, void* C,
                float* ws, int Bn, int M, int N, int K, int relu,
                long long sA, long long sB, int split, int out_bf16,
                cudaStream_t stream) {
  using T = TileOf<In, BM, BN, BK>;
  // raise the dynamic shared memory cap above 48 KB once per instantiation,
  // at its first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_kernel<In, BM, BN, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const long long mt = (M + BM - 1) / BM, zt = (long long)Bn * split;
  if (mt > 65535 || zt > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte aligned rows in every batch entry: 4 fp32
  // or 8 bf16 elements
  constexpr int V = 16 / sizeof(In);
  const bool a16 = K % V == 0 && sA % V == 0 &&
                   reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool b16 = N % V == 0 && sB % V == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (unsigned)mt, (unsigned)zt);
  matmul_kernel<In, BM, BN, BK><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      A, B, bias, res, C, ws, M, N, K, relu, split, a16, b16, sA, sB,
      out_bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  return rt::tc::launch_splitk_reduce(ws, bias, res, C, M, N, split,
                                      (long long)Bn * M * N, relu, stream,
                                      out_bf16);
}

// Every (BM, BN, BK) CTA tile ops.cta_plan may choose (matmul.TILE_M,
// TILE_N, TILE_K): BM in 16..128, BN in 8..128, BK 16 or 32 for fp32 and
// 32 or 64 for bf16 (matmul.TILE_K_BF16).
#define RT_MMA_BN(X, BM, BK) \
  X(BM, 8, BK) X(BM, 32, BK) X(BM, 64, BK) X(BM, 128, BK)
#define RT_MMA_BM(X, BK)                                            \
  RT_MMA_BN(X, 16, BK) RT_MMA_BN(X, 32, BK) RT_MMA_BN(X, 64, BK) \
      RT_MMA_BN(X, 128, BK)
#define RT_FOR_EACH_MMA_TILE(X) RT_MMA_BM(X, 16) RT_MMA_BM(X, 32)
#define RT_FOR_EACH_BF16_TILE(X) RT_MMA_BM(X, 32) RT_MMA_BM(X, 64)

template <class In>
int launch(const In* A, const In* B, Ep bias, Ep res, void* C, float* ws,
           int Bn, int M, int N, int K, int relu, long long sA,
           long long sB, int bm, int bn, int bk, int split, int out_bf16,
           cudaStream_t stream) {
  const int steps = (K + bk - 1) / bk;
  // every split must own at least one BK step, and a split needs a workspace
  if (split < 1) return (int)cudaErrorInvalidValue;
  const int per = (steps + split - 1) / split;
  if (split > 1 && (ws == nullptr || (split - 1) * per >= steps))
    return (int)cudaErrorInvalidValue;
#define RT_LAUNCH(BM_, BN_, BK_)                                             \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                  \
    return launch_tile<In, BM_, BN_, BK_>(A, B, bias, res, C, ws, Bn, M, N, \
                                          K, relu, sA, sB, split, out_bf16, \
                                          stream);
  if constexpr (std::is_same_v<In, float>) {
    RT_FOR_EACH_MMA_TILE(RT_LAUNCH)
  } else {
    RT_FOR_EACH_BF16_TILE(RT_LAUNCH)
  }
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Built twice (kernels/common.LIBRARIES): -DRT_FP32 gives the fp32 entry
// points, -DRT_BF16 the bf16 ones, so each build instantiates one dtype's
// tiles and the two compile in parallel.
#if defined(RT_FP32) == defined(RT_BF16)
#error "build matmul.cu with exactly one of -DRT_FP32 and -DRT_BF16"
#endif

// A (M, K), B (K, N), bias (M,) or null, res (M, N) or null -> C (M, N),
// all row-major; A and B of the entry point's operand type, bias, res and C
// each fp32 or bf16 (bias_bf16, res_bf16, out_bf16); ws (split, M, N) fp32
// scratch when split > 1, else null. Returns cudaGetLastError() after the
// launches; an unknown tile or an illegal split returns
// cudaErrorInvalidValue without launching.
//
// The batched entry points: A (Bn, M, K) with batch stride sA, B (Bn, K, N)
// with batch stride sB (each matrix row-major; a stride of 0 broadcasts one
// matrix over the batch), bias (M,) or null, res (Bn, M, N) or null -> C
// (Bn, M, N) contiguous; ws (split, Bn, M, N) when split > 1. The strides
// are 64-bit, in elements.
#define RT_ENTRY_POINTS(In, SUFFIX)                                          \
  extern "C" int rt_matmul_##SUFFIX(                                         \
      const In* A, const In* B, const void* bias, const void* res, void* C, \
      float* ws, int M, int N, int K, int relu, int bm, int bn, int bk,     \
      int split, int out_bf16, int bias_bf16, int res_bf16,                 \
      cudaStream_t stream) {                                                \
    return launch<In>(A, B, Ep{bias, bias_bf16}, Ep{res, res_bf16}, C, ws,  \
                      1, M, N, K, relu, 0, 0, bm, bn, bk, split, out_bf16,  \
                      stream);                                              \
  }                                                                         \
  extern "C" int rt_matmul_batch_##SUFFIX(                                   \
      const In* A, const In* B, const void* bias, const void* res, void* C, \
      float* ws, int Bn, int M, int N, int K, int relu, int bm, int bn,     \
      int bk, int split, int out_bf16, int bias_bf16, int res_bf16,         \
      long long sA, long long sB, cudaStream_t stream) {                    \
    return launch<In>(A, B, Ep{bias, bias_bf16}, Ep{res, res_bf16}, C, ws,  \
                      Bn, M, N, K, relu, sA, sB, bm, bn, bk, split,         \
                      out_bf16, stream);                                    \
  }

#if defined(RT_FP32)
RT_ENTRY_POINTS(float, f32)
#else
RT_ENTRY_POINTS(bf16, bf16)
#endif
