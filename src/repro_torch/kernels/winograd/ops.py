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

Dtypes, as the reference's ``winograd_conv`` has them: both transforms and
the point-GEMM run in fp32 whatever x's dtype, bias and residual are
widened to fp32 before the epilogue (the reference's ``_epilogue`` adds
them to the fp32 result), and the output is cast once to x's dtype. So a
bf16 conv returns bf16 without running the bf16 point-GEMM, which only a
caller of ``winograd_point_gemm*`` on bf16 u and v reaches (``cta_plan``
plans it at that dtype).

Launch plans. ``wino-*`` keeps the reference's (bk, bt) TPU blocks (K by T,
channel block 128); its ceiling tile halves each, capped at 128, with a
channel depth of 16. ``mm-*`` on a Winograd base tiles the point-GEMM as
(K, C, T) under the matmul kernel's own ceiling (``kernels/matmul/ops.py``
``ceiling``). A bf16 ceiling doubles the depth (a stage of the same bytes):

    variant           TPU block         ceiling (BM, BK, BN)   bf16
    wino-128x128      (128, 128)        ( 64, 16,  64)        ( 64, 32,  64)
    wino-256x128      (256, 128)        (128, 16,  64)        (128, 32,  64)
    wino-128x256      (128, 256)        ( 64, 16, 128)        ( 64, 32, 128)
    mm-*              (bm, bk, bn)      matmul's ceiling      matmul's bf16 ceiling

``cta_plan`` fits the ceiling to each call's K x C by C x T point-GEMMs by
the matmul kernel's rule (``common.fit_plan``), with the N images times P
points as the batch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import as_f32, fit_plan
from repro_torch.kernels.matmul.ops import CTA_TILES as MM_CTA_TILES  # noqa: F401
from repro_torch.kernels.matmul.ops import ceiling as mm_ceiling
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


def ceiling(variant: str,
            dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """(BM, BK, BN) ceiling tile of a ``wino-*`` or ``mm-*`` variant for
    operands of ``dtype``: the fp32 tile's depth doubled for bf16 (the
    table)."""
    if variant not in CTA_TILES:
        return mm_ceiling(variant, dtype)
    bm, bk, bn = CTA_TILES[variant]
    return (bm, 2 * bk, bn) if dtype == torch.bfloat16 else (bm, bk, bn)


def cta_plan(K: int, T: int, C: int, batch: int, variant: str,
             dtype: torch.dtype = torch.float32) -> Tuple[int, int, int, int]:
    """(BM, BN, BK, split_k) for ``batch`` = N images x P points
    point-GEMMs (K, C) @ (C, T) under ``variant`` on operands of ``dtype``:
    ``common.fit_plan`` on the variant's ceiling at that dtype and the tile
    sizes csrc/winograd.cu instantiates. BM and BN are the smallest
    instantiated sizes covering K and T under the ceiling; C is split, in
    whole BK steps, until the output tiles give every SM a CTA and 8 warps
    (or one step per slice)."""
    return fit_plan(K, T, C, batch, ceiling(variant, dtype), TILE_M, TILE_N)


def weight_transform(w: torch.Tensor, m: int) -> torch.Tensor:
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
    F(mxm, 3x3), in x's dtype. U is transformed once and shared; only V
    carries the batch."""
    N, C, H, W = x.shape
    K, oh, ow = w.shape[0], H - 2, W - 2
    V = winograd_input_transform(x.float().contiguous(), m)   # (N, n², C, T)
    U = weight_transform(w, m)
    bm, bn, bk, split = cta_plan(K, V.shape[-1], C, N * U.shape[0], variant)
    M = winograd_point_gemm_batch(U, V, bm=bm, bk=bk, bn=bn, split_k=split)
    y = winograd_inverse_transform(M, m, oh, ow, bias=as_f32(bias),
                                   residual=as_f32(residual), relu=relu)
    return y.to(x.dtype)


def winograd_conv(x: torch.Tensor, w: torch.Tensor, *, m: int = 2,
                  variant: str = "wino-128x128", bias=None, residual=None,
                  relu: bool = False) -> torch.Tensor:
    """x (C, H, W), w (K, C, 3, 3) -> (K, H-2, W-2), stride 1, F(mxm, 3x3),
    through the single-image point-GEMM kernel, in x's dtype. ``bias`` is
    (K,), ``residual`` is (K, H-2, W-2)."""
    C, H, W = x.shape
    K, oh, ow = w.shape[0], H - 2, W - 2
    V = winograd_input_transform(x.float().contiguous()[None], m)[0]
    U = weight_transform(w, m)
    bm, bn, bk, split = cta_plan(K, V.shape[-1], C, U.shape[0], variant)
    M = winograd_point_gemm(U, V, bm=bm, bk=bk, bn=bn, split_k=split)
    y = winograd_inverse_transform(
        M[None], m, oh, ow, bias=as_f32(bias),
        residual=None if residual is None else as_f32(residual)[None],
        relu=relu)[0]
    return y.to(x.dtype)


def winograd_conv_op(x: torch.Tensor, w: torch.Tensor,
                     variant: str = "wino-128x128") -> torch.Tensor:
    """x (C, H, W), w (K, C, 3, 3) -> (K, H-2, W-2). Stride 1, F(2x2, 3x3)."""
    return winograd_conv(x, w, m=2, variant=variant)


def winograd_conv_batch_op(x: torch.Tensor, w: torch.Tensor,
                           variant: str = "wino-128x128") -> torch.Tensor:
    """x (N, C, H, W), w (K, C, 3, 3) -> (N, K, H-2, W-2). Stride 1, F(2x2, 3x3)."""
    return winograd_conv_batch(x, w, m=2, variant=variant)
