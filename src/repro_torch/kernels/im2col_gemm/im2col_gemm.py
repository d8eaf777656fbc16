"""Implicit-GEMM valid convolution with a fused bias -> residual -> ReLU
epilogue, on the tensor cores: the port of the Pallas kernels
``repro.kernels.im2col_gemm.im2col_gemm.conv_im2col_batch`` and
``conv_im2col`` (one image), with their dtype contract. ``x`` and ``w`` are
fp32 (run at fp32 accuracy, 3xTF32) or bf16 (bf16 tensor-core products),
both of one dtype; bias and residual each have that dtype or fp32. The sum
is fp32, the epilogue runs on it in fp32, widening bias and residual, and
the output is stored once in x's dtype, as the reference's fused kernel
does.

``conv_im2col_batch`` and ``conv_im2col`` launch ``csrc/im2col_gemm.cu`` for
CUDA tensors — each CTA gathers its slice of the patch matrix into shared
memory straight from ``x``, so the patch matrix never exists in device
memory — and compute ``conv_im2col_batch_plain`` / ``conv_im2col_plain``
(explicit patch matrix + matmul) for CPU tensors. The caller names the
launch plan: a CTA tile ``(bm, bk, bn)`` that the source instantiates
(``TILE_M`` x ``TILE_K`` x ``TILE_N``) and ``split_k``, the number of slices
the C*f*f reduction is cut into (``ops.cta_plan`` chooses both per shape
and dtype: a bf16 tile is ``TILE_K_BF16`` deep). With ``split_k > 1`` each
slice writes its fp32 partial sum to a workspace allocated here, and a
second kernel adds the slices in a fixed order and applies the epilogue
once; the launch still counts once.

The caller also names the kernel, ``route`` (``ROUTES``): ``"mma.sync"``
(``csrc/im2col_gemm.cu``, either dtype, any shape) or, for the operands
``takes_wgmma`` accepts (bf16, at least 64 output channels), ``"wgmma"``
(``csrc/conv_wgmma.cu``: TMA weights, producer-gathered patches, Hopper's
warpgroup MMA), whose tiles are the ``(bm, bn)`` of ``WGMMA_TILES``,
``WGMMA_BK`` deep. Each route has one ring: 3 stages on mma.sync, 4 on
wgmma. ``ops.route`` is the rule the entry points use. A call that names
``"wgmma"`` on operands it cannot take raises ``ValueError``; it is never
run on the other route. The launch signature ends with bias and residual
as their dtype's name (or False), ReLU, the route, then x's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import (as_f32, bind, check_int32,
                                        check_launch, check_plan,
                                        count_launch, dtype_name, ep_name,
                                        epilogue, on_cpu, ptr, stream_of)

# CTA tile sizes csrc/im2col_gemm.cu instantiates (RT_FOR_EACH_CONV_TILE,
# RT_FOR_EACH_CONV_BF16_TILE): every BM of TILE_M with every BN of TILE_N
# and every BK of TILE_K (fp32) or TILE_K_BF16 (bf16: a stage of the same
# bytes)
TILE_M = (16, 32, 64, 128)
TILE_N = (8, 32, 64)
TILE_K = (16,)
TILE_K_BF16 = (32,)
# the kernels a call may name: csrc/im2col_gemm.cu, csrc/conv_wgmma.cu
ROUTES = ("mma.sync", "wgmma")
# (BM, BN) tiles csrc/conv_wgmma.cu instantiates
# (RT_FOR_EACH_CONV_WGMMA_TILE), each WGMMA_BK deep: one consumer
# warpgroup on 64, 128 or 256 pixels, two on 64 (ops.WGMMA_BN)
WGMMA_TILE_M = (64, 128)              # one or two consumer warpgroups
WGMMA_TILE_N = (64, 128, 256)         # pixels
WGMMA_TILES = ((64, 64), (64, 128), (64, 256), (128, 64))
WGMMA_BK = 64                         # one 128-byte swizzle row
WGMMA_MIN_K = 64                      # output channels: one warpgroup's rows
# operand dtype -> (library, suffix of its C entry points)
_LIB = {torch.float32: ("im2col_gemm", "f32"),
        torch.bfloat16: ("im2col_gemm_bf16", "bf16")}


def tile_k(dtype: torch.dtype) -> tuple:
    """The K depths instantiated for operands of ``dtype``."""
    return TILE_K_BF16 if dtype == torch.bfloat16 else TILE_K


def takes_wgmma(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the wgmma route can take a conv of ``x`` under weights ``w``
    (K, C, f, f): bf16 operands and K >= ``WGMMA_MIN_K`` output channels,
    one consumer warpgroup's 64 rows. Any R and any alignment: the kernel
    loads by TMA the weights whose rows TMA can address and gathers the
    rest and the patches itself."""
    return (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and w.shape[0] >= WGMMA_MIN_K)


def _route_depth(name: str, x, w, R: int, plan: tuple, route: str) -> int:
    """Check the launch plan ``(bm, bk, bn, split_k)`` on ``route`` and
    return its depth ``bk`` (default: the route's at the dtype): the tile
    must be instantiated for the route and dtype, each split slice own a
    step, and a wgmma call name operands ``takes_wgmma`` accepts."""
    bm, bk, bn, split_k = plan
    if route == "mma.sync":
        bk = tile_k(x.dtype)[0] if bk is None else bk
        check_plan(name, R, bm, bk, bn, split_k, TILE_M, tile_k(x.dtype),
                   TILE_N)
        return bk
    if route != "wgmma":
        raise ValueError(f"{name}: route must be one of {ROUTES}, got {route!r}")
    if not takes_wgmma(x, w):
        raise ValueError(f"{name}: the wgmma route takes bf16 operands with at "
                         f"least {WGMMA_MIN_K} output channels; got {x.dtype} "
                         f"x under {w.dtype} w {tuple(w.shape)}")
    bk = WGMMA_BK if bk is None else bk
    check_plan(name, R, bm, bk, bn, split_k, WGMMA_TILE_M, (WGMMA_BK,),
               WGMMA_TILE_N)
    if (bm, bn) not in WGMMA_TILES:
        raise ValueError(f"{name}: ({bm}, {bk}, {bn}) is not an instantiated "
                         f"wgmma tile")
    return bk


def _check_sizes(name: str, N: int, C: int, H: int, W: int, K: int, f: int,
                 stride: int, oh: int, ow: int) -> None:
    """Every size the kernel takes as a C ``int``, and the element counts
    its 32-bit offsets span (x, w, the output and its N*oh*ow pixels)."""
    check_int32(name, N=N, C=C, H=H, W=W, K=K, f=f, stride=stride, oh=oh,
                ow=ow, pixels=N * oh * ow, out=N * K * oh * ow,
                x=N * C * H * W, w=K * C * f * f)


def conv_im2col_batch_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                            bias: Optional[torch.Tensor] = None,
                            residual: Optional[torch.Tensor] = None,
                            relu: bool = False) -> torch.Tensor:
    """Explicit (c, a, b)-ordered patch matrix, one matmul, then the
    epilogue, all in fp32 on the operands' values; one cast to x's dtype."""
    N, C, H, W = x.shape
    K, _, f, _ = w.shape
    oh, ow = (H - f) // stride + 1, (W - f) // stride + 1
    cols = F.unfold(x.float(), f, stride=stride)         # (N, C*f*f, oh*ow)
    y = (w.float().reshape(K, -1) @ cols).reshape(N, K, oh, ow)
    y = epilogue(y, as_f32(bias), as_f32(residual), relu, channel_axis=1)
    return y.to(x.dtype)


def _conv(name: str, x: torch.Tensor, w: torch.Tensor, stride: int,
          plan: tuple, bias: Optional[torch.Tensor],
          residual: Optional[torch.Tensor], relu: bool, route: str,
          plain) -> torch.Tensor:
    """The body both wrappers share. ``x`` is (N, C, H, W), or (C, H, W) for
    one image, whose output and ``residual`` then drop the N axis too; the
    one image runs the single-image entry point (the wgmma route's batched
    one at N = 1), and ``plain`` is the wrapper's plain version."""
    one = x.dim() == 3
    N, C, H, W = (1, *x.shape) if one else x.shape
    K, C2, f, f2 = w.shape
    if C != C2 or f != f2 or f > min(H, W):
        raise ValueError(f"{name}: x {tuple(x.shape)} w {tuple(w.shape)}")
    oh, ow = (H - f) // stride + 1, (W - f) // stride + 1
    shape = (K, oh, ow) if one else (N, K, oh, ow)
    if bias is not None and tuple(bias.shape) != (K,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != ({K},)")
    if residual is not None and tuple(residual.shape) != shape:
        raise ValueError(f"{name}: residual {tuple(residual.shape)} != {shape}")
    bm, _, bn, split_k = plan
    bk = _route_depth(name, x, w, C * f * f, plan, route)
    _check_sizes(name, N, C, H, W, K, f, stride, oh, ow)
    if on_cpu(name, x, w, epilogue=(bias, residual)):
        return plain(x, w, stride, bias=bias, residual=residual, relu=relu)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    ws = (torch.empty((split_k, *shape), dtype=torch.float32, device=x.device)
          if split_k > 1 else None)
    sizes = (C, H, W, K, f, stride) if one else (N, C, H, W, K, f, stride)
    eps = tuple(int(ep_name(t) == "bfloat16") for t in (bias, residual))
    args = (ptr(x), ptr(w), ptr(bias), ptr(residual), ptr(out), ptr(ws))
    if route == "wgmma":                  # one image as N = 1
        fn = bind("conv_wgmma", "rt_conv_wgmma_bf16", 6, 15)
        err = fn(*args, N, C, H, W, K, f, stride, oh, ow, int(relu), bm, bn,
                 split_k, *eps, stream_of(x))
    else:
        lib, suffix = _LIB[x.dtype]
        fn = bind(lib, f"rt_conv_im2col_{suffix}" if one
                  else f"rt_conv_im2col_batch_{suffix}", 6, len(sizes) + 9)
        err = fn(*args, *sizes, oh, ow, int(relu), bm, bn, bk, split_k, *eps,
                 stream_of(x))
    check_launch(name, err)
    count_launch(name, (*sizes, bm, bk, bn, split_k, ep_name(bias),
                        ep_name(residual), bool(relu), route,
                        dtype_name(x.dtype)))
    return out


def conv_im2col_batch(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                      bm: int = 128, bk: Optional[int] = None, bn: int = 64,
                      split_k: int = 1, bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      relu: bool = False,
                      route: str = "mma.sync") -> torch.Tensor:
    """x (N, C, H, W), w (K, C, f, f) -> (N, K, oh, ow) in x's dtype, valid
    padding, the epilogue applied once to the full fp32 sum. ``bias`` is
    (K,), ``residual`` is (N, K, oh, ow). The CTA tile covers ``bm`` output
    channels by ``bn`` output pixels (batch folded in), with a reduction
    depth of ``bk`` patch rows (default: the route's depth at the dtype);
    ``split_k`` slices of the C*f*f reduction run side by side. ``route``
    names the kernel (``ROUTES``)."""
    if x.dim() != 4:
        raise ValueError(f"conv_im2col_batch: x {tuple(x.shape)} is not 4-D")
    return _conv("conv_im2col_batch", x, w, stride, (bm, bk, bn, split_k),
                 bias, residual, relu, route, conv_im2col_batch_plain)


def conv_im2col_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      relu: bool = False) -> torch.Tensor:
    """One image: explicit (c, a, b)-ordered (C*f*f, oh*ow) patch matrix, one
    matmul, then the epilogue, all in fp32 on the operands' values; one
    cast to x's dtype."""
    C, H, W = x.shape
    K, _, f, _ = w.shape
    oh, ow = (H - f) // stride + 1, (W - f) // stride + 1
    cols = F.unfold(x.float()[None], f, stride=stride)[0]  # (C*f*f, oh*ow)
    y = (w.float().reshape(K, -1) @ cols).reshape(K, oh, ow)
    y = epilogue(y, as_f32(bias), as_f32(residual), relu, channel_axis=0)
    return y.to(x.dtype)


def conv_im2col(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                bm: int = 128, bk: Optional[int] = None, bn: int = 64,
                split_k: int = 1, bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None,
                relu: bool = False,
                route: str = "mma.sync") -> torch.Tensor:
    """x (C, H, W), w (K, C, f, f) -> (K, oh, ow) in x's dtype, valid
    padding, the epilogue applied once to the full fp32 sum. ``bias`` is
    (K,), ``residual`` is (K, oh, ow), read in place (the TPU kernel
    transposes it to (oh, K, ow) for its row grid). The CTA tile covers
    ``bm`` output channels by ``bn`` output pixels with a reduction depth
    of ``bk`` patch rows (default: the route's depth at the dtype);
    ``split_k`` slices of the C*f*f reduction run side by side. ``route``
    as in ``conv_im2col_batch``."""
    if x.dim() != 3:
        raise ValueError(f"conv_im2col: x {tuple(x.shape)} is not 3-D")
    return _conv("conv_im2col", x, w, stride, (bm, bk, bn, split_k), bias,
                 residual, relu, route, conv_im2col_plain)
