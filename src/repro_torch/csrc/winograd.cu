// Winograd convolution F(m x m, 3 x 3), m = 2 or 4, on Hopper, as three
// kernels around the weight transform U = G w G^T (left to torch, as the
// reference leaves it to XLA):
// - the input transform (rt_winograd_input_transform_f32):
//   x (N, C, H, W) -> V (N, n^2, C, T), V[., a n + b, c, t] = (B^T d B)[a, b]
//   for the n x n window d of tile t, n = m + 2;
// - the point-GEMM, M[n, p] = U[p] @ V[n, p] for every image n and point p,
//   batched (rt_winograd_point_gemm_batch_*) and single-image
//   (rt_winograd_point_gemm_*), on fp32 U and V at fp32 accuracy (*_f32) or
//   bf16 U and V with fp32 accumulation (*_bf16), M in the operands' type;
// - the inverse transform (rt_winograd_inverse_transform_f32):
//   M (N, n^2, K, T) -> y (N, K, oh, ow), the m x m block A^T M A of each
//   tile, with the bias -> residual -> ReLU epilogue.
//
// The point-GEMM replaces two TPU kernels:
// - `winograd_point_gemm_batch` (src/repro/kernels/winograd/winograd.py:77,
//   body `_point_gemm_batch_kernel` :64): grid (N, P, K tiles, T tiles,
//   C tiles) with the C reduction innermost on the sequential grid into an
//   f32 VMEM accumulator, inputs zero-padded to block multiples;
// - `winograd_point_gemm` (winograd.py:36, body `_point_gemm_kernel` :23):
//   the same for one image, under the single-image `winograd_conv`.
// Both are dtype-generic: on bf16 u and v they accumulate in an fp32 VMEM
// scratch and store u's dtype (winograd.py:23-33, :57, :63-74, :99). The
// reference's `winograd_conv` never reaches them in bf16 (it transforms in
// fp32 whatever x's dtype, ops.py:60, :97), so neither does the port's.
// The single-image entry point is the batched kernel at N = 1. The two
// transforms have no TPU kernel: the reference computes them as XLA
// einsums around the Pallas call (src/repro/kernels/winograd/ops.py:76-109).
// Here each is one pass over device memory, where torch's einsums
// materialised, permuted and copied tensors as large as V.
//
// What bounds it on the H100. The point-GEMMs are K x C by C x T with
// K, C = 16-512 and T = tiles per image (1-2,916 on resnet18): at b=8 the
// stage-1 layers (K = C = 64, T = 2,916 at F(2x2)) move V and M, 95.6 MB
// each, for little arithmetic and are bound by bytes (3.35 TB/s); the
// 512-channel layers (T = 1-9) read U[p], 1 MB a point, for 8 images and
// are bound by operations at 3xTF32 (494.7 / 3 TFLOP/s); at bf16 (989
// TFLOP/s, 2-byte operands) every layer is bound by bytes. The transforms
// are bound by bytes: x and V, M and y each cross device memory once.
//
// What the point-GEMM's design does (the plan of each call comes from
// ops.cta_plan, the matmul kernel's rule):
// 1. fp32: the tile loop of mma_tf32.cuh, 3xTF32 mma.sync.m16n8k8 at fp32
//    accuracy, a 3-stage cp.async ring, RowMajorStages as the loader. A =
//    U[p] (K, C) takes 16-byte copies where C % 4 == 0, else 4-byte ones;
//    B = V[n, p] (C, T) always 16-byte ones, each z's own misalignment
//    (bmis) and odd T handled by the loader. bf16: the tile loop of
//    mma_bf16.cuh (mma.sync.m16n8k16 bf16, ldmatrix fragments, f32
//    accumulation, stages twice as deep) with its RowMajorStages: 16-byte
//    cp.async where C % 8 == 0 (A) or T % 8 == 0 (B), plain element loads
//    where not (resnet18's T = 27^2 = 729). Nothing is padded.
// 2. Tiles fitted to the shape (BM over K, BN over T), and a deterministic
//    split of C where the output tiles cannot fill the 132 SMs: partials
//    to a (split, N, P, K, T) fp32 workspace, then splitk_reduce
//    (epilogue.cuh) adds them in split order, rounding a bf16 M once, from
//    the full sum. No epilogue here: M lives in the transform
//    domain, so bias / residual / ReLU follow the inverse transform.
// 3. blockIdx.z carries (image n, point p, split s), n fastest: the CTAs
//    that read one U[p] run next to each other, so U[p] is read from the
//    50 MB L2 by all N images. U is shared over the batch and read in
//    place, never copied per image.
//
// The transforms: one thread per (image, channel, tile). The input
// transform reads its n x n window once (zero past H and W, the
// reference's pad) and writes the n^2 points, each store coalesced along
// t; the inverse reads its n^2 points (coalesced along t) and stores the
// m x m block cropped at oh and ow, the epilogue applied before the single
// store. B^T and A^T are compile-time constants, so the products by their
// zeros are not emitted.
#include <type_traits>

#include "epilogue.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using rt::bf::bf16;

template <class In>
constexpr bool kBf16 = std::is_same_v<In, bf16>;

// The CTA tile of operand type In: mma_tf32.cuh's for fp32, mma_bf16.cuh's
// for bf16 (the same warp tiling).
template <class In, int BM, int BN, int BK>
using TileOf = std::conditional_t<kBf16<In>, rt::bf::Tile<BM, BN, BK>,
                                  rt::tc::Tile<BM, BN, BK>>;

// ---------------------------------------------------------------------------
// Point-GEMM
// ---------------------------------------------------------------------------

// grid (T tiles, K tiles, N * P * split), z = (s * P + p) * N + n. Split s
// walks BK steps [s * per, (s + 1) * per) of C; with split == 1 it stores
// M[n, p], else its raw partial sum into ws[s][n][p]. (fp32. The bf16
// kernel below is a kernel of its own: one template over both types
// compiled the fp32 tiles to other register counts, the 64 x 64 x 16 tile
// from 125 to 163, and the resnet18 / mix pass of this kernel ran 3.5%
// slower on an H100.)
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(rt::tc::Tile<BM, BN, BK>::kThreads)
point_gemm_kernel(const float* __restrict__ U, const float* __restrict__ V,
                  float* __restrict__ O, float* __restrict__ ws, int N, int P,
                  int K, int C, int T, int split, int a16) {
  using TL = rt::tc::Tile<BM, BN, BK>;
  extern __shared__ float4 smem4[];
  const int n = blockIdx.z % N, p = blockIdx.z / N % P, s = blockIdx.z / N / P;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int per = ((C + BK - 1) / BK + split - 1) / split;
  const int kbeg = s * per * BK, kend = min(C, kbeg + per * BK);
  const long long np = (long long)n * P + p, KT = (long long)K * T;
  const float* Vz = V + np * C * T;
  const int bmis = (int)(reinterpret_cast<uintptr_t>(Vz) / 4 % 4);
  const rt::tc::RowMajorStages<BM, BN, BK> load{
      U + (long long)p * K * C, Vz, K, T, C, m0, n0, a16 != 0, bmis};
  float acc[TL::MT][TL::NT][4] = {};
  rt::tc::mma_tile<BM, BN, BK>(load, kbeg, kend,
                               reinterpret_cast<float*>(smem4), acc);

  float* out = (split == 1 ? O : ws + s * N * P * KT) + np * KT;
  const int r0 = m0 + rt::tc::warp_row<BM, BN, BK>() + threadIdx.x % 32 / 4;
  const int c0 = n0 + rt::tc::warp_col<BM, BN, BK>() + threadIdx.x % 4 * 2;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + mt * 16 + h * 8;
        if (m >= K) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = c0 + nt * 8 + e;
          if (t < T) out[(long long)m * T + t] = acc[mt][nt][2 * h + e];
        }
      }
}

// The bf16 point-GEMM, on the grid of point_gemm_kernel: mma_bf16.cuh's
// tile loop and RowMajorStages (a16 / b16: U's / V's rows 16-byte aligned
// at every point and image), M[n, p] rounded once to bf16 where split ==
// 1, else the raw fp32 partial sum into ws[s][n][p].
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(rt::bf::Tile<BM, BN, BK>::kThreads)
point_gemm_kernel_bf16(const bf16* __restrict__ U, const bf16* __restrict__ V,
                       bf16* __restrict__ O, float* __restrict__ ws, int N,
                       int P, int K, int C, int T, int split, int a16,
                       int b16) {
  using TL = rt::bf::Tile<BM, BN, BK>;
  extern __shared__ float4 smem4[];
  const int n = blockIdx.z % N, p = blockIdx.z / N % P, s = blockIdx.z / N / P;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int per = ((C + BK - 1) / BK + split - 1) / split;
  const int kbeg = s * per * BK, kend = min(C, kbeg + per * BK);
  const long long np = (long long)n * P + p, KT = (long long)K * T;
  const rt::bf::RowMajorStages<BM, BN, BK> load{
      U + (long long)p * K * C, V + np * C * T, K, T, C, m0, n0, a16 != 0,
      b16 != 0};
  float acc[TL::MT][TL::NT][4] = {};
  rt::bf::mma_tile<BM, BN, BK>(load, kbeg, kend, reinterpret_cast<bf16*>(smem4),
                               acc);

  const long long base = np * KT, part = (s * N * P + np) * KT;
  const int r0 = m0 + rt::bf::warp_row<BM, BN, BK>() + threadIdx.x % 32 / 4;
  const int c0 = n0 + rt::bf::warp_col<BM, BN, BK>() + threadIdx.x % 4 * 2;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + mt * 16 + h * 8;
        if (m >= K) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = c0 + nt * 8 + e;
          if (t >= T) continue;
          const long long o = (long long)m * T + t;
          const float v = acc[mt][nt][2 * h + e];
          if (split == 1)
            O[base + o] = __float2bfloat16_rn(v);
          else
            ws[part + o] = v;
        }
      }
}

// cudaFuncSetAttribute of the point-GEMM kernel of operand type In: its
// dynamic shared memory cap raised to `bytes`
template <class In, int BM, int BN, int BK>
cudaError_t max_smem(int bytes) {
  constexpr auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if constexpr (kBf16<In>)
    return cudaFuncSetAttribute(point_gemm_kernel_bf16<BM, BN, BK>, attr, bytes);
  else
    return cudaFuncSetAttribute(point_gemm_kernel<BM, BN, BK>, attr, bytes);
}

template <class In, int BM, int BN, int BK>
int launch_tile(const In* U, const In* V, In* O, float* ws, int N, int P,
                int K, int C, int T, int split, cudaStream_t stream) {
  using TL = TileOf<In, BM, BN, BK>;
  // raise the dynamic shared memory cap above 48 KB once per instantiation,
  // at its first launch
  static const cudaError_t attr = max_smem<In, BM, BN, BK>(TL::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const long long mt = (K + BM - 1) / BM, zt = (long long)N * P * split;
  if (mt > 65535 || zt > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte aligned rows at every point p and image n:
  // 4 fp32 or 8 bf16 elements
  constexpr int VEC = 16 / sizeof(In);
  const bool a16 = C % VEC == 0 && reinterpret_cast<uintptr_t>(U) % 16 == 0;
  const bool b16 = T % VEC == 0 && reinterpret_cast<uintptr_t>(V) % 16 == 0;
  dim3 grid((T + BN - 1) / BN, (unsigned)mt, (unsigned)zt);
  if constexpr (kBf16<In>)
    point_gemm_kernel_bf16<BM, BN, BK>
        <<<grid, TL::kThreads, TL::kSmemBytes, stream>>>(
            U, V, O, ws, N, P, K, C, T, split, a16, b16);
  else
    point_gemm_kernel<BM, BN, BK>
        <<<grid, TL::kThreads, TL::kSmemBytes, stream>>>(
            U, V, O, ws, N, P, K, C, T, split, a16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  return rt::tc::launch_splitk_reduce<const float*>(ws, nullptr, nullptr, O, K,
                                                    T, split,
                                                    (long long)N * P * K * T,
                                                    0, stream, kBf16<In>);
}

// Every (BM, BN, BK) CTA tile ops.cta_plan may choose (winograd.TILE_M,
// TILE_N, TILE_K / TILE_K_BF16): BM in 16..128, BN in 8..128, BK 16 or 32
// for fp32 and 32 or 64 for bf16 (a stage of the same bytes).
#define RT_WINO_BN(X, BM, BK) \
  X(BM, 8, BK) X(BM, 32, BK) X(BM, 64, BK) X(BM, 128, BK)
#define RT_WINO_BM(X, BK)                                              \
  RT_WINO_BN(X, 16, BK) RT_WINO_BN(X, 32, BK) RT_WINO_BN(X, 64, BK) \
      RT_WINO_BN(X, 128, BK)
#define RT_FOR_EACH_WINO_TILE(X) RT_WINO_BM(X, 16) RT_WINO_BM(X, 32)
#define RT_FOR_EACH_WINO_BF16_TILE(X) RT_WINO_BM(X, 32) RT_WINO_BM(X, 64)

template <class In>
int launch(const In* U, const In* V, In* O, float* ws, int N, int P, int K,
           int C, int T, int bm, int bn, int bk, int split,
           cudaStream_t stream) {
  // every split must own at least one BK step, and a split needs a workspace
  if (split < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  const int steps = (C + bk - 1) / bk;
  const int per = (steps + split - 1) / split;
  if (split > 1 && (ws == nullptr || (split - 1) * per >= steps))
    return (int)cudaErrorInvalidValue;
#define RT_LAUNCH(BM_, BN_, BK_)                                          \
  if (bm == BM_ && bn == BN_ && bk == BK_)                               \
    return launch_tile<In, BM_, BN_, BK_>(U, V, O, ws, N, P, K, C, T,   \
                                          split, stream);
  if constexpr (kBf16<In>) {
    RT_FOR_EACH_WINO_BF16_TILE(RT_LAUNCH)
  } else {
    RT_FOR_EACH_WINO_TILE(RT_LAUNCH)
  }
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Input and inverse transforms
// ---------------------------------------------------------------------------

// B^T and A^T of F(m x m, 3 x 3), as repro_torch.primitives.conv._WINO_SETS
// holds them: F(2x2) on the points {0, 1, -1, inf} (_BT_4, _AT_2_3), F(4x4)
// on {0, 1, -1, 2, -2, inf} (_BT_6, _AT_4_3).
template <int M>
struct WinoSet;

template <>
struct WinoSet<2> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ float bt(int a, int p) {
    constexpr float v[4][4] = {
        {1, 0, -1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, 1, 0, -1}};
    return v[a][p];
  }
  static __device__ __forceinline__ float at(int a, int p) {
    constexpr float v[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};
    return v[a][p];
  }
};

template <>
struct WinoSet<4> {
  static constexpr int kN = 6;
  static __device__ __forceinline__ float bt(int a, int p) {
    constexpr float v[6][6] = {
        {4, 0, -5, 0, 1, 0},   {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},
        {0, -2, -1, 2, 1, 0},  {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}};
    return v[a][p];
  }
  static __device__ __forceinline__ float at(int a, int p) {
    constexpr float v[4][6] = {{1, 1, 1, 1, 1, 0},
                               {0, 1, -1, 2, -2, 0},
                               {0, 1, 1, 4, 4, 0},
                               {0, 1, -1, 8, -8, 1}};
    return v[a][p];
  }
};

// One thread per (image, channel c, tile t): V[img, a n + b, c, t] =
// (B^T d B)[a, b] for the n x n window d of x[img, c] at (i m, j m),
// t = i tw + j, zero past H and W. total = N * C * T threads.
template <int M>
__global__ void __launch_bounds__(256)
input_transform_kernel(const float* __restrict__ x, float* __restrict__ V,
                       int C, int H, int W, int tw, int T, int total) {
  using S = WinoSet<M>;
  constexpr int n = S::kN;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int t = idx % T, nc = idx / T;         // nc = img * C + c
  const int i = t / tw, j = t - i * tw;
  const float* src = x + (long long)nc * H * W;
  float d[n][n];
#pragma unroll
  for (int a = 0; a < n; ++a)
#pragma unroll
    for (int b = 0; b < n; ++b) {
      const int y = i * M + a, z = j * M + b;
      d[a][b] = y < H && z < W ? src[y * W + z] : 0.f;
    }
  float e[n][n];                               // B^T d
#pragma unroll
  for (int a = 0; a < n; ++a)
#pragma unroll
    for (int q = 0; q < n; ++q) {
      float v = 0.f;
#pragma unroll
      for (int p = 0; p < n; ++p)
        if (S::bt(a, p) != 0.f) v += S::bt(a, p) * d[p][q];
      e[a][q] = v;
    }
  const int img = nc / C, c = nc - img * C;
  const long long CT = (long long)C * T;
  float* dst = V + (long long)img * n * n * CT + (long long)c * T + t;
#pragma unroll
  for (int a = 0; a < n; ++a)
#pragma unroll
    for (int b = 0; b < n; ++b) {
      float v = 0.f;                           // (B^T d) B
#pragma unroll
      for (int q = 0; q < n; ++q)
        if (S::bt(b, q) != 0.f) v += S::bt(b, q) * e[a][q];
      dst[(a * n + b) * CT] = v;
    }
}

// One thread per (image, output channel k, tile t): the m x m block
// (A^T M A) of M[img, :, k, t], cropped at oh and ow, each element
// finished by bias -> residual -> ReLU before its store. total = N * K * T.
template <int M>
__global__ void __launch_bounds__(256)
inverse_transform_kernel(const float* __restrict__ Mt,
                         const float* __restrict__ bias,
                         const float* __restrict__ res, float* __restrict__ y,
                         int K, int tw, int T, int oh, int ow, int relu,
                         int total) {
  using S = WinoSet<M>;
  constexpr int n = S::kN;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int t = idx % T, nk = idx / T;         // nk = img * K + k
  const int img = nk / K, k = nk - img * K;
  const long long KT = (long long)K * T;
  const float* src = Mt + (long long)img * n * n * KT + (long long)k * T + t;
  float mv[n][n];
#pragma unroll
  for (int p = 0; p < n; ++p)
#pragma unroll
    for (int q = 0; q < n; ++q) mv[p][q] = src[(p * n + q) * KT];
  float e[M][n];                               // A^T M
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int q = 0; q < n; ++q) {
      float v = 0.f;
#pragma unroll
      for (int p = 0; p < n; ++p)
        if (S::at(a, p) != 0.f) v += S::at(a, p) * mv[p][q];
      e[a][q] = v;
    }
  const int i = t / tw, j = t - i * tw;
  const int base = nk * oh * ow;               // y[img, k, 0, 0]
#pragma unroll
  for (int a = 0; a < M; ++a) {
    const int yy = i * M + a;
    if (yy >= oh) break;
#pragma unroll
    for (int b = 0; b < M; ++b) {
      const int xx = j * M + b;
      if (xx >= ow) break;
      float v = 0.f;                           // (A^T M) A
#pragma unroll
      for (int q = 0; q < n; ++q)
        if (S::at(b, q) != 0.f) v += S::at(b, q) * e[a][q];
      const int o = base + yy * ow + xx;
      y[o] = rt::tc::finish(v, bias, res, k, o, relu);
    }
  }
}

inline unsigned blocks_of(int total) { return (unsigned)((total + 255) / 256); }

}  // namespace

// Built twice (kernels/common.LIBRARIES): -DRT_FP32 gives the fp32
// point-GEMM and the two transforms, -DRT_BF16 the bf16 point-GEMM (the
// transforms run in fp32 whatever the conv's dtype, as the reference's
// einsums do), so each build instantiates one dtype's tiles and the two
// compile in parallel.
#if defined(RT_FP32) == defined(RT_BF16)
#error "build winograd.cu with exactly one of -DRT_FP32 and -DRT_BF16"
#endif

// U (P, K, C), V (N, P, C, T) of the entry point's operand type -> O (N, P,
// K, T) in that type, all contiguous; ws (split, N, P, K, T) fp32 scratch
// when split > 1, else null. Returns cudaGetLastError() after the
// launches; an unknown tile or an illegal split returns
// cudaErrorInvalidValue without launching.
//
// The single-image entry points: V (P, C, T) -> O (P, K, T), ws (split, P,
// K, T): the batched kernel at N = 1.
#define RT_ENTRY_POINTS(In, SUFFIX)                                           \
  extern "C" int rt_winograd_point_gemm_batch_##SUFFIX(                       \
      const In* U, const In* V, In* O, float* ws, int N, int P, int K, int C, \
      int T, int bm, int bn, int bk, int split, cudaStream_t stream) {        \
    return launch<In>(U, V, O, ws, N, P, K, C, T, bm, bn, bk, split,         \
                      stream);                                               \
  }                                                                          \
  extern "C" int rt_winograd_point_gemm_##SUFFIX(                             \
      const In* U, const In* V, In* O, float* ws, int P, int K, int C, int T, \
      int bm, int bn, int bk, int split, cudaStream_t stream) {               \
    return launch<In>(U, V, O, ws, 1, P, K, C, T, bm, bn, bk, split,         \
                      stream);                                               \
  }

#if defined(RT_BF16)
RT_ENTRY_POINTS(bf16, bf16)
#else
RT_ENTRY_POINTS(float, f32)

// x (N, C, H, W) -> V (N, (m+2)^2, C, th * tw), fp32 contiguous, th =
// ceil((H - 2) / m), tw = ceil((W - 2) / m); m is 2 or 4, else
// cudaErrorInvalidValue without launching. N * C * T must fit an int.
extern "C" int rt_winograd_input_transform_f32(const float* x, float* V,
                                               int N, int C, int H, int W,
                                               int m, cudaStream_t stream) {
  if ((m != 2 && m != 4) || H < 3 || W < 3) return (int)cudaErrorInvalidValue;
  const int th = (H - 2 + m - 1) / m, tw = (W - 2 + m - 1) / m;
  const int T = th * tw, total = N * C * T;
  if (total == 0) return (int)cudaSuccess;
  if (m == 2)
    input_transform_kernel<2><<<blocks_of(total), 256, 0, stream>>>(
        x, V, C, H, W, tw, T, total);
  else
    input_transform_kernel<4><<<blocks_of(total), 256, 0, stream>>>(
        x, V, C, H, W, tw, T, total);
  return (int)cudaGetLastError();
}

// M (N, (m+2)^2, K, th * tw), bias (K,) or null, res (N, K, oh, ow) or null
// -> y (N, K, oh, ow), fp32 contiguous, th = ceil(oh / m), tw = ceil(ow /
// m); m is 2 or 4. N * K * T and N * K * oh * ow must fit an int.
extern "C" int rt_winograd_inverse_transform_f32(const float* Mt,
                                                 const float* bias,
                                                 const float* res, float* y,
                                                 int N, int K, int oh, int ow,
                                                 int m, int relu,
                                                 cudaStream_t stream) {
  if (m != 2 && m != 4) return (int)cudaErrorInvalidValue;
  const int th = (oh + m - 1) / m, tw = (ow + m - 1) / m;
  const int T = th * tw, total = N * K * T;
  if (total == 0) return (int)cudaSuccess;
  if (m == 2)
    inverse_transform_kernel<2><<<blocks_of(total), 256, 0, stream>>>(
        Mt, bias, res, y, K, tw, T, oh, ow, relu, total);
  else
    inverse_transform_kernel<4><<<blocks_of(total), 256, 0, stream>>>(
        Mt, bias, res, y, K, tw, T, oh, ow, relu, total);
  return (int)cudaGetLastError();
}

#endif  // RT_FP32
