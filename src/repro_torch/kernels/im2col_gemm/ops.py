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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import fit_plan
from repro_torch.kernels.im2col_gemm.im2col_gemm import (TILE_M, TILE_N,
                                                         conv_im2col,
                                                         conv_im2col_batch)

VARIANTS: Dict[str, int] = {"conv-bk64": 64, "conv-bk128": 128, "conv-bk256": 256}

# (BM, BK, BN) ceiling tile per variant — the table in the docstring
CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "conv-bk64": (64, 16, 64),
    "conv-bk128": (128, 16, 64),
    "conv-bk256": (128, 16, 64),
}


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


def _plan(n: int, x, w, stride: int,
          variant: str) -> Tuple[int, int, int, int]:
    """The plan of ``n`` images of x's trailing (C, H, W) shape and dtype
    under (K, C, f, f) weights (no pixels where f exceeds the image: the
    wrapper refuses that shape)."""
    H, W = x.shape[-2:]
    K, C, f, _ = w.shape
    oh, ow = max(0, (H - f) // stride + 1), max(0, (W - f) // stride + 1)
    return cta_plan(K, n * oh * ow, C * f * f, variant, x.dtype)


def conv_im2col_op(x, w, stride: int = 1, variant: str = "conv-bk128",
                   bias=None, residual=None, relu: bool = False):
    """One (C, H, W) image through the implicit-GEMM conv under
    ``variant``'s plan for this shape and dtype, epilogue applied once to
    the full fp32 sum, stored in x's dtype."""
    bm, bn, bk, split = _plan(1, x, w, stride, variant)
    return conv_im2col(x, w, stride, bm=bm, bk=bk, bn=bn, split_k=split,
                       bias=bias, residual=residual, relu=relu)


def conv_im2col_batch_op(x, w, stride: int = 1, variant: str = "conv-bk128",
                         bias=None, residual=None, relu: bool = False):
    """(N, C, H, W) batch through the implicit-GEMM conv under ``variant``'s
    plan for this shape and dtype, the batch folded into the pixels,
    epilogue applied once to the full fp32 sum, stored in x's dtype."""
    bm, bn, bk, split = _plan(x.shape[0], x, w, stride, variant)
    return conv_im2col_batch(x, w, stride, bm=bm, bk=bk, bn=bn,
                             split_k=split, bias=bias, residual=residual,
                             relu=relu)
