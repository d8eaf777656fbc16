"""Variant registry for the matmul kernels (``matmul_op`` and the batched
``matmul_batch_op``), and the rule that turns a TPU block variant and a
GEMM shape into a launch plan for ``csrc/matmul.cu``.

``VARIANTS`` keeps the reference's keys and TPU (bm, bk, bn) blocks, so
every column name the selection produces (``<base>@mm-...``) executes. The
TPU blocks are sized for a 128x128 MXU and many megabytes of VMEM; fp32
``mm-512x256x256`` would need 512 KB for its A block alone against 227 KB of
shared memory per H100 block. ``CTA_TILES`` therefore maps each key onto a
ceiling tile by one rule — halve the M and N blocks, capped at 128, and take
a K depth of ``bk / 8`` (two or four of the tensor core's 8-deep steps):

    variant            TPU (bm, bk, bn)   ceiling (BM, BK, BN)
    mm-128x128x128     (128, 128, 128)    ( 64, 16,  64)
    mm-256x128x128     (256, 128, 128)    (128, 16,  64)
    mm-128x128x256     (128, 128, 256)    ( 64, 16, 128)
    mm-256x128x256     (256, 128, 256)    (128, 16, 128)
    mm-512x128x128     (512, 128, 128)    (128, 16,  64)   M block capped
    mm-128x256x128     (128, 256, 128)    ( 64, 32,  64)
    mm-256x256x256     (256, 256, 256)    (128, 32, 128)
    mm-512x256x256     (512, 256, 256)    (128, 32, 128)   M block capped

``cta_plan`` fits the ceiling to the shape of each call (see its rule). On
a shape that fills the card with ceiling tiles the plan is the ceiling, so
the six distinct ceilings stay six distinct kernels and the selection's
columns keep their meaning; the two capped keys run as their 256-row
twins.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.kernels.common import SMS, WARPS_PER_SM, fit_plan  # noqa: F401
from repro_torch.kernels.matmul.matmul import (TILE_M, TILE_N, matmul,
                                               matmul_batch)

# (bm, bk, bn) TPU blocks, as in the reference
VARIANTS: Dict[str, Tuple[int, int, int]] = {
    "mm-128x128x128": (128, 128, 128),
    "mm-256x128x128": (256, 128, 128),
    "mm-128x128x256": (128, 128, 256),
    "mm-256x128x256": (256, 128, 256),
    "mm-512x128x128": (512, 128, 128),
    "mm-128x256x128": (128, 256, 128),
    "mm-256x256x256": (256, 256, 256),
    "mm-512x256x256": (512, 256, 256),
}

# (BM, BK, BN) ceiling tile per variant — the table in the docstring
CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "mm-128x128x128": (64, 16, 64),
    "mm-256x128x128": (128, 16, 64),
    "mm-128x128x256": (64, 16, 128),
    "mm-256x128x256": (128, 16, 128),
    "mm-512x128x128": (128, 16, 64),
    "mm-128x256x128": (64, 32, 64),
    "mm-256x256x256": (128, 32, 128),
    "mm-512x256x256": (128, 32, 128),
}


def cta_plan(M: int, N: int, K: int, batch: int,
             variant: str) -> Tuple[int, int, int, int]:
    """(BM, BN, BK, split_k) for a (batch x) (M, K) @ (K, N) call under
    ``variant``: ``common.fit_plan`` on the variant's ceiling tile and the
    tile sizes csrc/matmul.cu instantiates. BM and BN are the smallest
    instantiated sizes covering M and N under the ceiling; K is split, in
    whole BK steps, until the output tiles give every SM a CTA and 8 warps
    (or one step per slice)."""
    return fit_plan(M, N, K, batch, CTA_TILES[variant], TILE_M, TILE_N)


def matmul_op(x, y, variant: str = "mm-128x128x128", bias=None,
              residual=None, relu: bool = False):
    """(M, K) @ (K, N) under ``variant``'s plan for this shape, epilogue
    applied once to the full sum."""
    (M, K), N = x.shape, y.shape[1]
    bm, bn, bk, split = cta_plan(M, N, K, 1, variant)
    return matmul(x, y, bm=bm, bk=bk, bn=bn, split_k=split, bias=bias,
                  residual=residual, relu=relu)


def matmul_batch_op(x, y, variant: str = "mm-128x128x128", bias=None,
                    residual=None, relu: bool = False):
    """(B, M, K) @ (B, K, N) under ``variant``'s plan for this shape, the
    batch on the grid, epilogue applied once to the full sum; ``x`` or
    ``y`` may be broadcast over B."""
    B, M, K = x.shape
    bm, bn, bk, split = cta_plan(M, y.shape[2], K, B, variant)
    return matmul_batch(x, y, bm=bm, bk=bk, bn=bn, split_k=split, bias=bias,
                        residual=residual, relu=relu)
