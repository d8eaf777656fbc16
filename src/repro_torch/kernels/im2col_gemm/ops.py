"""Variant registry for the implicit-GEMM conv kernels (``conv_im2col_op``
on one image, ``conv_im2col_batch_op`` on a batch), and the rule that turns
a ``conv-bk*`` variant and a conv's shape into a launch plan for
``csrc/im2col_gemm.cu``, the same for both.

The reference's ``conv-bk*`` value is the kernel's K-block (output channels
per program). Here it sets the ceiling of the CTA's M tile, capped at 128
(``conv-bk256`` runs as its 128-row twin); every ceiling covers 64 output
pixels with a reduction depth of 16 patch rows at fp32 and 32 at bf16 (a
stage of the same bytes, a multiple of the bf16 mma's 16):

    variant      TPU K-block   ceiling (BM, BK, BN)   bf16
    conv-bk64         64        ( 64, 16, 64)        ( 64, 32, 64)
    conv-bk128       128        (128, 16, 64)        (128, 32, 64)
    conv-bk256       256        (128, 16, 64)        (128, 32, 64)   capped

``cta_plan`` fits the ceiling to each call's GEMM — M = output channels,
N = batch * output pixels, K = C*f*f — by the matmul kernel's rule
(``common.fit_plan``). On a shape that fills the card with ceiling tiles
the plan is the ceiling, so the two distinct ceilings stay two distinct
kernels.

**Routes.** ``route`` picks each call's kernel from the call alone, before
anything launches: bf16 operands with at least 64 output channels
(``im2col_gemm.takes_wgmma``) take ``"wgmma"`` (``csrc/conv_wgmma.cu``),
everything else ``"mma.sync"`` (``csrc/im2col_gemm.cu``) under ``cta_plan``,
as before. On the wgmma route ``WGMMA_BM`` gives each key a BM ceiling,
the K-block capped at 128 (one or two consumer warpgroups of
``wgmma.m64nBNk16``), 64 deep a stage, and the tile's BM sets
its widest BN (``WGMMA_BN``): the most pixels whose accumulators fit the
registers ptxas gives a consumer thread, 256 beside one consumer
warpgroup (a 256-thread CTA: up to 255 registers a thread) and 64 beside
two (384 threads: 168 registers; a 128-wide tile's accumulator and its
promotion partial spilled 6 KB, and ran 1.3-1.5x slower than 128 x 64 on
resnet18's 128-channel layers, tools/ab_conv_bf16.py --tiles). So
``conv-bk256`` runs as its 128-row twin, as on the mma.sync route:

    variant      wgmma (BM, BK, BN)   threads   shared memory
    conv-bk64    ( 64, 64, 256)         256     176,192 B
    conv-bk128   (128, 64,  64)         384     120,896 B
    conv-bk256   (128, 64,  64)         384     120,896 B   capped

(1,024 bytes of alignment, 4 stages x (BM + BN) x 128 bytes, 1,024 bytes of
patch-row offset tables, 10,240 bytes of epilogue staging a consumer
warpgroup, 16 bytes of barriers a stage.) ``wgmma_plan`` fits BM to the
output channels and BN to the pixels, narrows BN while the output tiles
would leave half the SMs idle, and splits R only where the tiles still
cannot give every SM a CTA (a wgmma CTA fills an SM by itself), into as
many slices as one wave holds.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import SMS, fit_plan
from repro_torch.kernels.im2col_gemm.im2col_gemm import (TILE_M, TILE_N,
                                                         WGMMA_BK,
                                                         WGMMA_TILE_M,
                                                         WGMMA_TILE_N,
                                                         conv_im2col,
                                                         conv_im2col_batch,
                                                         takes_wgmma)

VARIANTS: Dict[str, int] = {"conv-bk64": 64, "conv-bk128": 128, "conv-bk256": 256}

# (BM, BK, BN) ceiling tile per variant — the table in the docstring
CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "conv-bk64": (64, 16, 64),
    "conv-bk128": (128, 16, 64),
    "conv-bk256": (128, 16, 64),
}


# BM ceiling per variant on the wgmma route, and the widest BN a tile of
# that BM takes — the second table in the docstring
WGMMA_BM: Dict[str, int] = {"conv-bk64": 64, "conv-bk128": 128, "conv-bk256": 128}
WGMMA_BN: Dict[int, int] = {64: 256, 128: 64}


def ceiling(variant: str,
            dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """(BM, BK, BN) ceiling tile of ``variant`` for operands of ``dtype``:
    ``CTA_TILES``' for fp32, its depth doubled for bf16 (the table)."""
    bm, bk, bn = CTA_TILES[variant]
    return (bm, 2 * bk, bn) if dtype == torch.bfloat16 else (bm, bk, bn)


def cta_plan(K_out: int, P: int, R: int, variant: str,
             dtype: torch.dtype = torch.float32) -> Tuple[int, int, int, int]:
    """(BM, BN, BK, split_k) for a conv with ``K_out`` output channels,
    ``P`` = batch * output pixels and ``R`` = C*f*f under ``variant`` on
    operands of ``dtype``: ``common.fit_plan`` on the variant's ceiling at
    that dtype and the tile sizes csrc/im2col_gemm.cu instantiates. BM and
    BN are the smallest instantiated sizes covering K_out and P under the
    ceiling; R is split, in whole BK steps, until the output tiles give
    every SM a CTA and 8 warps (or one step per slice)."""
    return fit_plan(K_out, P, R, 1, ceiling(variant, dtype), TILE_M, TILE_N)


def wgmma_plan(K_out: int, P: int, R: int,
               variant: str) -> Tuple[int, int, int, int]:
    """(BM, BN, BK, split_k) for a conv with ``K_out`` output
    channels, ``P`` = batch * output pixels and ``R`` = C*f*f under
    ``variant`` on the wgmma route: BM the smallest of ``WGMMA_TILE_M``
    covering min(K_out, ``WGMMA_BM[variant]``); BN the smallest of
    ``WGMMA_TILE_N`` covering min(P, ``WGMMA_BN[BM]``), halved while
    narrower tiles exist and the output tiles are fewer than half the
    ``SMS`` streaming multiprocessors (one image of resnet18's 64-channel
    layers: 90 tiles of 128 pixels, not 45 of 256); BK 64. R is
    split only where the output tiles are still fewer than the SMs, into
    as many slices as one wave of CTAs holds, ``want = min(steps, SMS //
    tiles)``, dealt out as whole 64-deep steps: ``per = ceil(steps /
    want)`` a slice, split_k = ceil(steps / per)."""
    bm = next(t for t in WGMMA_TILE_M if t >= min(K_out, WGMMA_BM[variant]))
    bn = next(t for t in WGMMA_TILE_N if t >= min(P, WGMMA_BN[bm]))
    mt = -(-K_out // bm)
    while bn > WGMMA_TILE_N[0] and 2 * mt * -(-P // bn) < SMS:
        bn //= 2
    tiles = mt * -(-P // bn)
    steps = -(-R // WGMMA_BK)
    if tiles == 0 or tiles >= SMS or steps <= 1:
        return bm, bn, WGMMA_BK, 1
    per = -(-steps // min(steps, SMS // tiles))
    return bm, bn, WGMMA_BK, -(-steps // per)


def route(x, w) -> str:
    """The kernel a conv of ``x`` under ``w`` takes: ``"wgmma"`` where
    ``im2col_gemm.takes_wgmma`` accepts the operands (bf16, K >= 64), else
    ``"mma.sync"``. Decided from the call alone; neither route falls back
    to the other."""
    return "wgmma" if takes_wgmma(x, w) else "mma.sync"


def plan(n: int, x, w, stride: int, variant: str) -> dict:
    """The launch arguments of ``n`` images of x's trailing (C, H, W) shape
    and dtype under (K, C, f, f) weights and ``variant``: route, tile and
    split, as ``conv_im2col`` / ``conv_im2col_batch`` take them
    (no pixels where f exceeds the image: the wrapper refuses that
    shape)."""
    H, W = x.shape[-2:]
    K, C, f, _ = w.shape
    oh, ow = max(0, (H - f) // stride + 1), max(0, (W - f) // stride + 1)
    P, R = n * oh * ow, C * f * f
    if route(x, w) == "wgmma":
        bm, bn, bk, split = wgmma_plan(K, P, R, variant)
        return dict(bm=bm, bk=bk, bn=bn, split_k=split, route="wgmma")
    bm, bn, bk, split = cta_plan(K, P, R, variant, x.dtype)
    return dict(bm=bm, bk=bk, bn=bn, split_k=split, route="mma.sync")


def conv_im2col_op(x, w, stride: int = 1, variant: str = "conv-bk128",
                   bias=None, residual=None, relu: bool = False):
    """One (C, H, W) image through the implicit-GEMM conv under
    ``variant``'s plan for this call's route, shape and dtype, epilogue
    applied once to the full fp32 sum, stored in x's dtype."""
    return conv_im2col(x, w, stride, bias=bias, residual=residual, relu=relu,
                       **plan(1, x, w, stride, variant))


def conv_im2col_batch_op(x, w, stride: int = 1, variant: str = "conv-bk128",
                         bias=None, residual=None, relu: bool = False):
    """(N, C, H, W) batch through the implicit-GEMM conv under ``variant``'s
    plan for this call's route, shape and dtype, the batch folded into the
    pixels, epilogue applied once to the full fp32 sum, stored in x's
    dtype."""
    return conv_im2col_batch(x, w, stride, bias=bias, residual=residual,
                             relu=relu, **plan(x.shape[0], x, w, stride, variant))
