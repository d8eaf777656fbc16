"""Full Winograd conv: torch transforms around the hand-written point-GEMM
(the compute stage), generic over F(mxm, 3x3) via the transform sets in
``primitives.conv``. The port of ``repro.kernels.winograd.ops``.

As in the reference, the input, weight and inverse transforms are plain
tensor code (einsums, in float32) and only the point-GEMM is a kernel; the
bias / residual / ReLU epilogue runs right after the inverse transform —
it cannot move into the point-GEMM, whose output lives in the transform
domain.

Tile map. ``wino-*`` keeps the reference's (bk, bt) TPU blocks (K by T,
channel block 128); a Hopper CTA tile halves each, capped at 128, with a
channel depth of 8 — the rule of ``kernels/matmul/ops.py``. ``mm-*`` on a
Winograd base takes the matmul variant's CTA tile as (K, C, T):

    variant        TPU (bk, bt)   Hopper CTA (BM, BK, BN)
    wino-128x128   (128, 128)     (64, 8,  64)
    wino-256x128   (256, 128)     (128, 8, 64)
    wino-128x256   (128, 256)     (64, 8, 128)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import epilogue
from repro_torch.kernels.matmul.ops import CTA_TILES as MM_CTA_TILES
from repro_torch.kernels.winograd.winograd import winograd_point_gemm_batch
from repro_torch.primitives.conv import _WINO_SETS

VARIANTS: Dict[str, Tuple[int, int]] = {
    "wino-128x128": (128, 128), "wino-256x128": (256, 128),
    "wino-128x256": (128, 256)}

CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "wino-128x128": (64, 8, 64),
    "wino-256x128": (128, 8, 64),
    "wino-128x256": (64, 8, 128),
}


def cta_tile(variant: str) -> Tuple[int, int, int]:
    """(BM, BK, BN) point-GEMM tile of a ``wino-*`` or ``mm-*`` variant."""
    return CTA_TILES[variant] if variant in CTA_TILES else MM_CTA_TILES[variant]


def winograd_conv_batch(x: torch.Tensor, w: torch.Tensor, *, m: int = 2,
                        variant: str = "wino-128x128", bias=None,
                        residual=None, relu: bool = False) -> torch.Tensor:
    """x (N, C, H, W), w (K, C, 3, 3) -> (N, K, H-2, W-2), stride 1,
    F(mxm, 3x3). U is transformed once and shared; only V carries the batch."""
    AT, G, BT = (torch.as_tensor(a, dtype=torch.float32, device=x.device)
                 for a in _WINO_SETS[(m, 3)])
    N, C, H, W = x.shape
    K = w.shape[0]
    n = m + 2
    oh, ow = H - 2, W - 2
    th, tw = -(-oh // m), -(-ow // m)
    ph, pw = (th - 1) * m + n, (tw - 1) * m + n
    xp = F.pad(x, (0, pw - W, 0, ph - H))
    rows = [torch.stack([xp[:, :, a:a + (th - 1) * m + 1:m, b:b + (tw - 1) * m + 1:m]
                         for b in range(n)], -1) for a in range(n)]
    tiles = torch.stack(rows, -2)                              # (N, C, th, tw, n, n)
    V = torch.einsum("ap,ncijpq,qb->nabcij", BT, tiles.float(), BT.T)
    V = V.reshape(N, n * n, C, th * tw)                        # (N, n², C, T)
    U = torch.einsum("ar,kcrs,sb->abkc", G, w.float(), G.T)
    U = U.reshape(n * n, K, C)

    bm, bk, bn = cta_tile(variant)
    M = winograd_point_gemm_batch(U.contiguous(), V.to(U.dtype).contiguous(),
                                  bm=bm, bk=bk, bn=bn)         # (N, n², K, T)
    M = M.reshape(N, n, n, K, th, tw)
    Y = torch.einsum("ap,npqkij,qm->nkiajm", AT, M, AT.T)      # (N, K, th, m, tw, m)
    y = Y.reshape(N, K, th * m, tw * m)[:, :, :oh, :ow]
    y = epilogue(y, bias, residual, relu, channel_axis=1)
    return y.to(x.dtype)
