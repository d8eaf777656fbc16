"""Winograd F(mxm, 3x3) kernels: the point-GEMM ``M[n, p] = U[p] @ V[n, p]``,
the port of the Pallas kernels
``repro.kernels.winograd.winograd.winograd_point_gemm_batch`` and
``winograd_point_gemm`` (one image), on the tensor cores, with their dtype
contract: fp32 u and v at fp32 accuracy (3xTF32), or bf16 u and v (bf16
tensor-core products, fp32 sums), M stored once in u's dtype, as the
reference's kernels store it from their fp32 VMEM accumulator; and the
input and inverse transforms around it, which the reference leaves to XLA
and computes in fp32 (they take fp32 only).

For CUDA tensors each wrapper launches its kernel in ``csrc/winograd.cu``
(the point-GEMM's wgmma route in ``csrc/winograd_wgmma.cu``);
for CPU tensors it computes its plain version (``*_plain``), the same
function in plain torch.

- ``winograd_point_gemm_batch`` / ``winograd_point_gemm``: U is shared
  across the batch and read in place, never copied per image. The caller
  names the launch plan, a CTA tile ``(bm, bk, bn)`` the source
  instantiates (``TILE_M`` x ``TILE_K`` x ``TILE_N``, ``TILE_K_BF16`` deep
  for bf16) and ``split_k``, the number of slices of the C reduction
  (``ops.cta_plan`` chooses both per shape and dtype). With ``split_k > 1``
  each slice writes its fp32 partial sum to a workspace allocated here and
  a second kernel adds the slices in a fixed order; the launch still counts
  once. The caller also names the kernel, ``route`` (``ROUTES``):
  ``"mma.sync"`` (``csrc/winograd.cu``, either dtype, any shape) or, for the
  operands ``takes_wgmma`` accepts (bf16, K >= 64, C % 8 == 0, u 16-byte
  aligned; any T and any offset of v), ``"wgmma"``
  (``csrc/winograd_wgmma.cu``: U by TMA, V gathered and realigned by a
  producer warpgroup, Hopper's warpgroup MMA), whose tiles are the
  ``(bm, bn)`` of ``WGMMA_TILES``, ``WGMMA_BK`` deep, and which never
  splits C (``split_k`` 1). ``ops.route`` is the rule the entry points
  use. A call that names ``"wgmma"`` on operands it
  cannot take raises ``ValueError``; it is never run on the other route. The
  launch signature ends with the route, then the operands' dtype.
- ``winograd_input_transform``: x (N, C, H, W) -> V (N, n², C, T), one
  pass over x, zero past its edges.
- ``winograd_inverse_transform``: M (N, n², K, T) -> y (N, K, oh, ow), with
  bias -> residual -> ReLU applied before the single store.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import (bind, check_int32, check_launch,
                                        check_plan, count_launch, dtype_name,
                                        epilogue, on_cpu, ptr, stream_of)
from repro_torch.primitives.conv import _WINO_SETS

# CTA tile sizes csrc/winograd.cu instantiates (RT_FOR_EACH_WINO_TILE,
# RT_FOR_EACH_WINO_BF16_TILE): every BM of TILE_M with every BN of TILE_N
# and every BK of TILE_K (fp32) or TILE_K_BF16 (bf16: a stage of the same
# bytes)
TILE_M = (16, 32, 64, 128)
TILE_N = (8, 32, 64, 128)
TILE_K = (16, 32)
TILE_K_BF16 = (32, 64)
# the kernels a call may name: csrc/winograd.cu, csrc/winograd_wgmma.cu
ROUTES = ("mma.sync", "wgmma")
# (BM, BN) tiles csrc/winograd_wgmma.cu instantiates
# (RT_FOR_EACH_WINO_WGMMA_BM by kBN), each WGMMA_BK deep: one or two
# consumer warpgroups on 64 t-values
WGMMA_TILE_M = (64, 128)              # one or two consumer warpgroups
WGMMA_BN = 64                         # t-values: one 128-byte row of V
WGMMA_TILES = tuple((bm, WGMMA_BN) for bm in WGMMA_TILE_M)
WGMMA_BK = 64                         # one 128-byte swizzle row of U
WGMMA_MIN_K = 64                      # output channels: one warpgroup's rows
# calls with fewer output columns (t-values, packed across images) than
# mma.sync's narrowest tile go to mma.sync (ops.route): a 64-wide wgmma
# tile would compute 8 times the useful columns
WGMMA_MIN_COLS = TILE_N[0]
# rows of V shorter than this (one 64-wide box), in a batch of more than
# one image, are packed: a wgmma tile's columns run over (image, t) pairs
WGMMA_PACK_T = 64
# operand dtype -> (library, suffix of its C entry points)
_LIB = {torch.float32: ("winograd", "f32"),
        torch.bfloat16: ("winograd_bf16", "bf16")}
TILE_SIZES = (2, 4)             # the output tile m of the F(mxm, 3x3) kernels


# ---------------------------------------------------------------------------
# Point-GEMM
# ---------------------------------------------------------------------------

def tile_k(dtype: torch.dtype) -> tuple:
    """The K (channel) depths instantiated for operands of ``dtype``."""
    return TILE_K_BF16 if dtype == torch.bfloat16 else TILE_K


def winograd_point_gemm_batch_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u (P, K, C), v (N, P, C, T) -> (N, P, K, T), contiguous as the
    kernel's output: in fp32 on the operands' values, one cast to u's
    dtype."""
    y = torch.einsum("pkc,npct->npkt", u.float(), v.float())
    return y.to(u.dtype).contiguous()


def winograd_point_gemm_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u (P, K, C), v (P, C, T) -> (P, K, T), contiguous as the kernel's
    output: in fp32 on the operands' values, one cast to u's dtype."""
    y = torch.einsum("pkc,pct->pkt", u.float(), v.float())
    return y.to(u.dtype).contiguous()


def takes_wgmma(u: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the wgmma route can take the point-GEMMs of ``u`` (P, K, C)
    and ``v``: bf16 operands, K >= ``WGMMA_MIN_K`` output channels (one
    consumer warpgroup's 64 rows), and U's rows where TMA can address them
    (C % 8 == 0, u 16-byte aligned). Any T and any alignment of v: the
    kernel's producers gather and realign V's rows themselves."""
    return (u.dtype == torch.bfloat16 and v.dtype == torch.bfloat16
            and u.shape[1] >= WGMMA_MIN_K and u.shape[2] % 8 == 0
            and u.data_ptr() % 16 == 0)


def _route_depth(name: str, u, v, C: int, plan: tuple, route: str) -> int:
    """Check the launch plan ``(bm, bk, bn, split_k)`` on ``route`` and
    return its depth ``bk`` (default: the route's at the dtype): the tile
    must be instantiated for the route and dtype, each mma.sync split slice
    own a step, and a wgmma call name operands ``takes_wgmma`` accepts and
    no split."""
    bm, bk, bn, split_k = plan
    if route == "mma.sync":
        bk = tile_k(u.dtype)[0] if bk is None else bk
        check_plan(name, C, bm, bk, bn, split_k, TILE_M, tile_k(u.dtype),
                   TILE_N)
        return bk
    if route != "wgmma":
        raise ValueError(f"{name}: route must be one of {ROUTES}, got {route!r}")
    if not takes_wgmma(u, v):
        raise ValueError(f"{name}: the wgmma route takes bf16 operands with at "
                         f"least {WGMMA_MIN_K} output channels, C % 8 == 0 and "
                         f"a 16-byte aligned u; got {u.dtype} u "
                         f"{tuple(u.shape)} at {u.data_ptr() % 16} bytes off "
                         f"16, {v.dtype} v")
    if split_k != 1:
        raise ValueError(f"{name}: the wgmma route does not split C; got "
                         f"split_k={split_k}")
    bk = WGMMA_BK if bk is None else bk
    check_plan(name, C, bm, bk, bn, split_k, WGMMA_TILE_M, (WGMMA_BK,),
               (WGMMA_BN,))
    return bk


def _point_gemm(name: str, u: torch.Tensor, v: torch.Tensor, plan: tuple,
                route: str, plain) -> torch.Tensor:
    """The body both wrappers share. ``v`` is (N, P, C, T), or (P, C, T) for
    one image, whose output then drops the N axis too; the one image runs
    the single-image entry point (the wgmma route's batched one at N = 1),
    and ``plain`` is the wrapper's plain version."""
    one = v.dim() == 3
    P, K, C = u.shape
    N, P2, C2, T = (1, *v.shape) if one else v.shape
    if (P, C) != (P2, C2):
        raise ValueError(f"{name}: u {tuple(u.shape)} v {tuple(v.shape)}")
    bm, _, bn, split_k = plan
    bk = _route_depth(name, u, v, C, plan, route)
    check_int32(name, N=N, P=P, K=K, C=C, T=T)
    if on_cpu(name, u, v):
        return plain(u, v)
    shape = (P, K, T) if one else (N, P, K, T)
    out = torch.empty(shape, dtype=u.dtype, device=u.device)
    ws = (torch.empty((split_k, *shape), dtype=torch.float32, device=u.device)
          if split_k > 1 else None)
    sizes = (P, K, C, T) if one else (N, P, K, C, T)
    if route == "wgmma":                  # one image as N = 1
        fn = bind("winograd_wgmma", "rt_winograd_wgmma_bf16", 3, 6)
        err = fn(ptr(u), ptr(v), ptr(out), N, P, K, C, T, bm, stream_of(u))
    else:
        lib, suffix = _LIB[u.dtype]
        fn = bind(lib, f"rt_winograd_point_gemm_{suffix}" if one
                  else f"rt_winograd_point_gemm_batch_{suffix}", 4, len(sizes) + 4)
        err = fn(ptr(u), ptr(v), ptr(out), ptr(ws), *sizes, bm, bn, bk,
                 split_k, stream_of(u))
    check_launch(name, err)
    count_launch(name, (*sizes, bm, bk, bn, split_k, route,
                        dtype_name(u.dtype)))
    return out


def winograd_point_gemm_batch(u: torch.Tensor, v: torch.Tensor, *,
                              bm: int = 64, bk: Optional[int] = None,
                              bn: int = 64, split_k: int = 1,
                              route: str = "mma.sync") -> torch.Tensor:
    """u (P, K, C) shared weights, v (N, P, C, T) batched input transform ->
    (N, P, K, T) in u's dtype. The CTA tile covers ``bm`` of K by ``bn`` of
    T with a reduction depth of ``bk`` channels (default: the route's depth
    at the dtype); on mma.sync one CTA column per (n, p, slice), the images
    of one point p next to each other on the grid; on wgmma a persistent
    grid walks the same tiles. ``route`` names the kernel (``ROUTES``)."""
    if v.dim() != 4:
        raise ValueError(f"winograd_point_gemm_batch: v {tuple(v.shape)} is "
                         f"not 4-D")
    return _point_gemm("winograd_point_gemm_batch", u, v,
                       (bm, bk, bn, split_k), route,
                       winograd_point_gemm_batch_plain)


def winograd_point_gemm(u: torch.Tensor, v: torch.Tensor, *, bm: int = 64,
                        bk: Optional[int] = None, bn: int = 64,
                        split_k: int = 1,
                        route: str = "mma.sync") -> torch.Tensor:
    """u (P, K, C), v (P, C, T) -> (P, K, T) in u's dtype: one image's P
    point-GEMMs. The CTA tile covers ``bm`` of K by ``bn`` of T with a
    reduction depth of ``bk`` channels (default: the route's depth at the
    dtype). ``route`` as in ``winograd_point_gemm_batch``."""
    if v.dim() != 3:
        raise ValueError(f"winograd_point_gemm: v {tuple(v.shape)} is not 3-D")
    return _point_gemm("winograd_point_gemm", u, v, (bm, bk, bn, split_k),
                       route, winograd_point_gemm_plain)


# ---------------------------------------------------------------------------
# Input and inverse transforms
# ---------------------------------------------------------------------------

def tiles_of(oh: int, ow: int, m: int):
    """(th, tw): the m x m output tiles covering an oh x ow output."""
    return -(-oh // m), -(-ow // m)


@functools.lru_cache(maxsize=None)
def transform_matrices(m: int, dtype: torch.dtype, device: torch.device):
    """(A^T, G, B^T) of F(mxm, 3x3) as tensors of ``dtype`` on ``device``,
    copied there once: no host-to-device copy per call, so a plain version
    can also be captured in a CUDA graph."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in _WINO_SETS[(m, 3)])


def winograd_input_transform_plain(x: torch.Tensor, m: int) -> torch.Tensor:
    """x (N, C, H, W) -> V (N, n², C, T), n = m + 2, T = th * tw: B^T d B of
    every n x n window d at stride m, x zero-padded past its edges."""
    BT = transform_matrices(m, x.dtype, x.device)[2]
    N, C, H, W = x.shape
    n = m + 2
    th, tw = tiles_of(H - 2, W - 2, m)
    ph, pw = (th - 1) * m + n, (tw - 1) * m + n
    xp = F.pad(x, (0, pw - W, 0, ph - H))
    rows = [torch.stack([xp[:, :, a:a + (th - 1) * m + 1:m, b:b + (tw - 1) * m + 1:m]
                         for b in range(n)], -1) for a in range(n)]
    tiles = torch.stack(rows, -2)                              # (N, C, th, tw, n, n)
    V = torch.einsum("ap,ncijpq,qb->nabcij", BT, tiles, BT.T)
    return V.reshape(N, n * n, C, th * tw).contiguous()


def _check_m(name: str, m: int) -> None:
    if m not in TILE_SIZES:
        raise ValueError(f"{name}: no F({m}x{m}, 3x3) kernel (m in {TILE_SIZES})")


def winograd_input_transform(x: torch.Tensor, m: int) -> torch.Tensor:
    """x (N, C, H, W) fp32 -> V (N, (m+2)², C, th * tw), th = ceil((H-2)/m),
    tw = ceil((W-2)/m); m is 2 or 4."""
    name = "winograd_input_transform"
    _check_m(name, m)
    N, C, H, W = x.shape
    if min(H, W) < 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} is smaller than 3x3")
    th, tw = tiles_of(H - 2, W - 2, m)
    n2, T = (m + 2) ** 2, th * tw
    check_int32(name, N=N, C=C, H=H, W=W, threads=N * C * T)
    if on_cpu(name, x):
        return winograd_input_transform_plain(x, m)
    out = torch.empty((N, n2, C, T), dtype=torch.float32, device=x.device)
    fn = bind("winograd", "rt_winograd_input_transform_f32", 2, 5)
    check_launch(name, fn(ptr(x), ptr(out), N, C, H, W, m, stream_of(x)))
    count_launch(name, (N, C, H, W, m))
    return out


def winograd_inverse_transform_plain(M: torch.Tensor, m: int, oh: int, ow: int, *,
                                     bias: Optional[torch.Tensor] = None,
                                     residual: Optional[torch.Tensor] = None,
                                     relu: bool = False) -> torch.Tensor:
    """M (N, n², K, T) -> y (N, K, oh, ow): A^T M A of every tile, cropped,
    then bias (K,) -> residual (N, K, oh, ow) -> ReLU."""
    AT = transform_matrices(m, M.dtype, M.device)[0]
    N, _, K, _ = M.shape
    n = m + 2
    th, tw = tiles_of(oh, ow, m)
    Mr = M.reshape(N, n, n, K, th, tw)
    Y = torch.einsum("ap,npqkij,qm->nkiajm", AT, Mr, AT.T)    # (N, K, th, m, tw, m)
    y = Y.reshape(N, K, th * m, tw * m)[:, :, :oh, :ow]
    return epilogue(y, bias, residual, relu, channel_axis=1)


def winograd_inverse_transform(M: torch.Tensor, m: int, oh: int, ow: int, *,
                               bias: Optional[torch.Tensor] = None,
                               residual: Optional[torch.Tensor] = None,
                               relu: bool = False) -> torch.Tensor:
    """M (N, (m+2)², K, th * tw) fp32, th = ceil(oh/m), tw = ceil(ow/m) -> y
    (N, K, oh, ow), each element finished by bias (K,) -> residual (N, K,
    oh, ow) -> ReLU before its store; m is 2 or 4."""
    name = "winograd_inverse_transform"
    _check_m(name, m)
    N, n2, K, T = M.shape
    th, tw = tiles_of(oh, ow, m)
    if (n2, T) != ((m + 2) ** 2, th * tw):
        raise ValueError(f"{name}: M {tuple(M.shape)} is not F({m}x{m}) of a "
                         f"{oh}x{ow} output")
    if bias is not None and tuple(bias.shape) != (K,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != ({K},)")
    if residual is not None and tuple(residual.shape) != (N, K, oh, ow):
        raise ValueError(f"{name}: residual {tuple(residual.shape)} != "
                         f"{(N, K, oh, ow)}")
    check_int32(name, N=N, K=K, oh=oh, ow=ow, threads=N * K * T,
                out=N * K * oh * ow)
    if on_cpu(name, M, bias, residual):
        return winograd_inverse_transform_plain(M, m, oh, ow, bias=bias,
                                                residual=residual, relu=relu)
    out = torch.empty((N, K, oh, ow), dtype=torch.float32, device=M.device)
    fn = bind("winograd", "rt_winograd_inverse_transform_f32", 4, 6)
    check_launch(name, fn(ptr(M), ptr(bias), ptr(residual), ptr(out), N, K, oh,
                          ow, m, int(relu), stream_of(M)))
    count_launch(name, (N, K, oh, ow, m, bias is not None,
                        residual is not None, bool(relu)))
    return out
