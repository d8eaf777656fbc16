"""Full Winograd conv: torch transforms around the hand-written point-GEMM
(the compute stage), generic over F(mxm, 3x3) via the transform sets in
``primitives.conv``. The port of ``repro.kernels.winograd.ops``: the batched
``winograd_conv_batch`` / ``winograd_conv_batch_op`` run the batched
point-GEMM kernel, the single-image ``winograd_conv`` / ``winograd_conv_op``
the single-image one; both take the same CTA tile per variant.

As in the reference, the input, weight and inverse transforms are plain
tensor code (einsums, in float32) and only the point-GEMM is a kernel; the
bias / residual / ReLU epilogue runs right after the inverse transform —
it cannot move into the point-GEMM, whose output lives in the transform
domain.

Tile map. ``wino-*`` keeps the reference's (bk, bt) TPU blocks (K by T,
channel block 128); a Hopper CTA tile halves each, capped at 128, with a
channel depth of 8. ``mm-*`` on a Winograd base tiles the point-GEMM as
(K, C, T) by the same rule — halve the M and N blocks, capped at 128, and a
channel depth of ``bk / 16`` — kept here in ``MM_CTA_TILES`` (the matmul
kernel's own plan rule, ``kernels/matmul/ops.py``, does not move these):

    variant           TPU block         Hopper CTA (BM, BK, BN)
    wino-128x128      (128, 128)        ( 64, 8,  64)
    wino-256x128      (256, 128)        (128, 8,  64)
    wino-128x256      (128, 256)        ( 64, 8, 128)
    mm-128x128x128    (128, 128, 128)   ( 64, 8,  64)
    mm-256x128x128    (256, 128, 128)   (128, 8,  64)
    mm-128x128x256    (128, 128, 256)   ( 64, 8, 128)
    mm-256x128x256    (256, 128, 256)   (128, 8, 128)
    mm-512x128x128    (512, 128, 128)   (128, 8,  64)
    mm-128x256x128    (128, 256, 128)   ( 64, 16, 64)
    mm-256x256x256    (256, 256, 256)   (128, 16, 128)
    mm-512x256x256    (512, 256, 256)   (128, 16, 128)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import epilogue
from repro_torch.kernels.winograd.winograd import (winograd_point_gemm,
                                                   winograd_point_gemm_batch)
from repro_torch.primitives.conv import _WINO_SETS

VARIANTS: Dict[str, Tuple[int, int]] = {
    "wino-128x128": (128, 128), "wino-256x128": (256, 128),
    "wino-128x256": (128, 256)}

CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "wino-128x128": (64, 8, 64),
    "wino-256x128": (128, 8, 64),
    "wino-128x256": (64, 8, 128),
}

# (BM, BK, BN) point-GEMM tile of each ``mm-*`` variant on a Winograd base
MM_CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "mm-128x128x128": (64, 8, 64),
    "mm-256x128x128": (128, 8, 64),
    "mm-128x128x256": (64, 8, 128),
    "mm-256x128x256": (128, 8, 128),
    "mm-512x128x128": (128, 8, 64),
    "mm-128x256x128": (64, 16, 64),
    "mm-256x256x256": (128, 16, 128),
    "mm-512x256x256": (128, 16, 128),
}


def cta_tile(variant: str) -> Tuple[int, int, int]:
    """(BM, BK, BN) point-GEMM tile of a ``wino-*`` or ``mm-*`` variant."""
    return CTA_TILES[variant] if variant in CTA_TILES else MM_CTA_TILES[variant]


def _input_transforms(x: torch.Tensor, w: torch.Tensor, m: int):
    """V (N, n², C, T) of a (N, C, H, W) batch and the shared U (n², K, C)
    of F(mxm, 3x3), with the tile grid (th, tw) and the matrix A^T."""
    AT, G, BT = (torch.as_tensor(a, dtype=torch.float32, device=x.device)
                 for a in _WINO_SETS[(m, 3)])
    N, C, H, W = x.shape
    K = w.shape[0]
    n = m + 2
    th, tw = -(-(H - 2) // m), -(-(W - 2) // m)
    ph, pw = (th - 1) * m + n, (tw - 1) * m + n
    xp = F.pad(x, (0, pw - W, 0, ph - H))
    rows = [torch.stack([xp[:, :, a:a + (th - 1) * m + 1:m, b:b + (tw - 1) * m + 1:m]
                         for b in range(n)], -1) for a in range(n)]
    tiles = torch.stack(rows, -2)                              # (N, C, th, tw, n, n)
    V = torch.einsum("ap,ncijpq,qb->nabcij", BT, tiles.float(), BT.T)
    V = V.reshape(N, n * n, C, th * tw)                        # (N, n², C, T)
    U = torch.einsum("ar,kcrs,sb->abkc", G, w.float(), G.T)
    return V.contiguous(), U.reshape(n * n, K, C).contiguous(), (th, tw), AT


def _inverse_transform(M: torch.Tensor, AT: torch.Tensor, th: int, tw: int,
                       oh: int, ow: int) -> torch.Tensor:
    """(N, n², K, T) point-GEMM output -> (N, K, oh, ow)."""
    N, _, K, _ = M.shape
    n, m = AT.shape[1], AT.shape[0]
    M = M.reshape(N, n, n, K, th, tw)
    Y = torch.einsum("ap,npqkij,qm->nkiajm", AT, M, AT.T)      # (N, K, th, m, tw, m)
    return Y.reshape(N, K, th * m, tw * m)[:, :, :oh, :ow]


def winograd_conv_batch(x: torch.Tensor, w: torch.Tensor, *, m: int = 2,
                        variant: str = "wino-128x128", bias=None,
                        residual=None, relu: bool = False) -> torch.Tensor:
    """x (N, C, H, W), w (K, C, 3, 3) -> (N, K, H-2, W-2), stride 1,
    F(mxm, 3x3). U is transformed once and shared; only V carries the batch."""
    V, U, (th, tw), AT = _input_transforms(x, w, m)
    bm, bk, bn = cta_tile(variant)
    M = winograd_point_gemm_batch(U, V, bm=bm, bk=bk, bn=bn)   # (N, n², K, T)
    y = _inverse_transform(M, AT, th, tw, x.shape[2] - 2, x.shape[3] - 2)
    y = epilogue(y, bias, residual, relu, channel_axis=1)
    return y.to(x.dtype)


def winograd_conv(x: torch.Tensor, w: torch.Tensor, *, m: int = 2,
                  variant: str = "wino-128x128", bias=None, residual=None,
                  relu: bool = False) -> torch.Tensor:
    """x (C, H, W), w (K, C, 3, 3) -> (K, H-2, W-2), stride 1, F(mxm, 3x3),
    through the single-image point-GEMM kernel. ``bias`` is (K,),
    ``residual`` is (K, H-2, W-2)."""
    V, U, (th, tw), AT = _input_transforms(x[None], w, m)
    bm, bk, bn = cta_tile(variant)
    M = winograd_point_gemm(U, V[0], bm=bm, bk=bk, bn=bn)      # (n², K, T)
    y = _inverse_transform(M[None], AT, th, tw, x.shape[1] - 2, x.shape[2] - 2)[0]
    y = epilogue(y, bias, residual, relu, channel_axis=0)
    return y.to(x.dtype)


def winograd_conv_op(x: torch.Tensor, w: torch.Tensor,
                     variant: str = "wino-128x128") -> torch.Tensor:
    """x (C, H, W), w (K, C, 3, 3) -> (K, H-2, W-2). Stride 1, F(2x2, 3x3)."""
    return winograd_conv(x, w, m=2, variant=variant)


def winograd_conv_batch_op(x: torch.Tensor, w: torch.Tensor,
                           variant: str = "wino-128x128") -> torch.Tensor:
    """x (N, C, H, W), w (K, C, 3, 3) -> (N, K, H-2, W-2). Stride 1, F(2x2, 3x3)."""
    return winograd_conv_batch(x, w, m=2, variant=variant)
