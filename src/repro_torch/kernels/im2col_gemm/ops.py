"""Variant registry for the implicit-GEMM conv kernels (``conv_im2col_op``
on one image, ``conv_im2col_batch_op`` on a batch), and the map from each
``conv-bk*`` variant onto a Hopper CTA tile, the same for both.

The reference's ``conv-bk*`` value is the kernel's K-block (output
channels per program). Here it is the CTA's M tile, capped at 128 (a 256-row
fp32 tile needs more registers than a 256-thread CTA has for its
accumulators); every tile covers 64 output pixels with a reduction depth of
16 patch rows:

    variant      TPU K-block   Hopper CTA (BM, BK, BN)
    conv-bk64         64        ( 64, 16, 64)
    conv-bk128       128        (128, 16, 64)
    conv-bk256       256        (128, 16, 64)   capped
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.kernels.im2col_gemm.im2col_gemm import (conv_im2col,
                                                         conv_im2col_batch)

VARIANTS: Dict[str, int] = {"conv-bk64": 64, "conv-bk128": 128, "conv-bk256": 256}

CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "conv-bk64": (64, 16, 64),
    "conv-bk128": (128, 16, 64),
    "conv-bk256": (128, 16, 64),
}


def conv_im2col_op(x, w, stride: int = 1, variant: str = "conv-bk128",
                   bias=None, residual=None, relu: bool = False):
    """One (C, H, W) image through the implicit-GEMM conv under ``variant``."""
    bm, bk, bn = CTA_TILES[variant]
    return conv_im2col(x, w, stride, bm=bm, bk=bk, bn=bn, bias=bias,
                       residual=residual, relu=relu)


def conv_im2col_batch_op(x, w, stride: int = 1, variant: str = "conv-bk128",
                         bias=None, residual=None, relu: bool = False):
    """(N, C, H, W) batch through the implicit-GEMM conv under ``variant``."""
    bm, bk, bn = CTA_TILES[variant]
    return conv_im2col_batch(x, w, stride, bm=bm, bk=bk, bn=bn, bias=bias,
                             residual=residual, relu=relu)
