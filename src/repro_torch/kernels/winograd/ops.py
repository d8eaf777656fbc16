"""Full Winograd conv, F(mxm, 3x3) with m = 2 or 4: the port of
``repro.kernels.winograd.ops``. Three hand-written kernels run it — the
input transform, the point-GEMM and the inverse transform, all in
``csrc/winograd.cu`` — around the weight transform U = G w G^T, which stays
a torch einsum (it touches only the weights). The batched
``winograd_conv_batch`` / ``winograd_conv_batch_op`` run the batched
point-GEMM, the single-image ``winograd_conv`` / ``winograd_conv_op`` the
single-image one; both run the same transform kernels. As in the
reference, the bias / residual / ReLU epilogue follows the inverse
transform (here inside its kernel, before the single store): it cannot move
into the point-GEMM, whose output lives in the transform domain.

Launch plans. ``wino-*`` keeps the reference's (bk, bt) TPU blocks (K by T,
channel block 128); its ceiling tile halves each, capped at 128, with a
channel depth of 16. ``mm-*`` on a Winograd base tiles the point-GEMM as
(K, C, T) under the matmul kernel's own ceiling (``kernels/matmul/ops.py``
``CTA_TILES``):

    variant           TPU block         ceiling (BM, BK, BN)
    wino-128x128      (128, 128)        ( 64, 16,  64)
    wino-256x128      (256, 128)        (128, 16,  64)
    wino-128x256      (128, 256)        ( 64, 16, 128)
    mm-*              (bm, bk, bn)      matmul's ceiling

``cta_plan`` fits the ceiling to each call's K x C by C x T point-GEMMs by
the matmul kernel's rule (``common.fit_plan``), with the N images times P
points as the batch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import fit_plan
from repro_torch.kernels.matmul.ops import CTA_TILES as MM_CTA_TILES
from repro_torch.kernels.winograd.winograd import (
    TILE_M, TILE_N, transform_matrices, winograd_input_transform,
    winograd_inverse_transform, winograd_point_gemm, winograd_point_gemm_batch)

VARIANTS: Dict[str, Tuple[int, int]] = {
    "wino-128x128": (128, 128), "wino-256x128": (256, 128),
    "wino-128x256": (128, 256)}

# (BM, BK, BN) ceiling tile per wino-* variant — the table in the docstring
CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "wino-128x128": (64, 16, 64),
    "wino-256x128": (128, 16, 64),
    "wino-128x256": (64, 16, 128),
}


def ceiling(variant: str) -> Tuple[int, int, int]:
    """(BM, BK, BN) ceiling tile of a ``wino-*`` or ``mm-*`` variant."""
    return CTA_TILES[variant] if variant in CTA_TILES else MM_CTA_TILES[variant]


def cta_plan(K: int, T: int, C: int, batch: int,
             variant: str) -> Tuple[int, int, int, int]:
    """(BM, BN, BK, split_k) for ``batch`` = N images x P points
    point-GEMMs (K, C) @ (C, T) under ``variant``: ``common.fit_plan`` on
    the variant's ceiling and the tile sizes csrc/winograd.cu instantiates.
    BM and BN are the smallest instantiated sizes covering K and T under the
    ceiling; C is split, in whole BK steps, until the output tiles give
    every SM a CTA and 8 warps (or one step per slice)."""
    return fit_plan(K, T, C, batch, ceiling(variant), TILE_M, TILE_N)


def _weight_transform(w: torch.Tensor, m: int) -> torch.Tensor:
    """w (K, C, 3, 3) -> U (n², K, C) = G w G^T, float32."""
    w = w.float()
    G = transform_matrices(m, w.dtype, w.device)[1]
    K, C = w.shape[:2]
    U = torch.einsum("ar,kcrs,sb->abkc", G, w, G.T)
    return U.reshape((m + 2) ** 2, K, C).contiguous()


def winograd_conv_batch(x: torch.Tensor, w: torch.Tensor, *, m: int = 2,
                        variant: str = "wino-128x128", bias=None,
                        residual=None, relu: bool = False) -> torch.Tensor:
    """x (N, C, H, W), w (K, C, 3, 3) -> (N, K, H-2, W-2), stride 1,
    F(mxm, 3x3). U is transformed once and shared; only V carries the batch."""
    N, C, H, W = x.shape
    K, oh, ow = w.shape[0], H - 2, W - 2
    V = winograd_input_transform(x.float().contiguous(), m)   # (N, n², C, T)
    U = _weight_transform(w, m)
    bm, bn, bk, split = cta_plan(K, V.shape[-1], C, N * U.shape[0], variant)
    M = winograd_point_gemm_batch(U, V, bm=bm, bk=bk, bn=bn, split_k=split)
    y = winograd_inverse_transform(M, m, oh, ow, bias=bias, residual=residual,
                                   relu=relu)
    return y.to(x.dtype)


def winograd_conv(x: torch.Tensor, w: torch.Tensor, *, m: int = 2,
                  variant: str = "wino-128x128", bias=None, residual=None,
                  relu: bool = False) -> torch.Tensor:
    """x (C, H, W), w (K, C, 3, 3) -> (K, H-2, W-2), stride 1, F(mxm, 3x3),
    through the single-image point-GEMM kernel. ``bias`` is (K,),
    ``residual`` is (K, H-2, W-2)."""
    C, H, W = x.shape
    K, oh, ow = w.shape[0], H - 2, W - 2
    V = winograd_input_transform(x.float().contiguous()[None], m)[0]
    U = _weight_transform(w, m)
    bm, bn, bk, split = cta_plan(K, V.shape[-1], C, U.shape[0], variant)
    M = winograd_point_gemm(U, V, bm=bm, bk=bk, bn=bn, split_k=split)
    y = winograd_inverse_transform(
        M[None], m, oh, ow, bias=bias,
        residual=None if residual is None else residual[None], relu=relu)[0]
    return y.to(x.dtype)


def winograd_conv_op(x: torch.Tensor, w: torch.Tensor,
                     variant: str = "wino-128x128") -> torch.Tensor:
    """x (C, H, W), w (K, C, 3, 3) -> (K, H-2, W-2). Stride 1, F(2x2, 3x3)."""
    return winograd_conv(x, w, m=2, variant=variant)


def winograd_conv_batch_op(x: torch.Tensor, w: torch.Tensor,
                           variant: str = "wino-128x128") -> torch.Tensor:
    """x (N, C, H, W), w (K, C, 3, 3) -> (N, K, H-2, W-2). Stride 1, F(2x2, 3x3)."""
    return winograd_conv_batch(x, w, m=2, variant=variant)
