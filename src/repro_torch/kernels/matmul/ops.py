"""Variant registry for the tiled matmul kernels (``matmul_op`` and the
batched ``matmul_batch_op``), and the map from each TPU block variant onto a
legal Hopper CTA tile.

``VARIANTS`` keeps the reference's keys and TPU (bm, bk, bn) blocks, so
every column name the selection produces (``<base>@mm-...``) executes. The
TPU blocks are sized for a 128x128 MXU and many megabytes of VMEM; fp32
``mm-512x256x256`` would need 512 KB for its A block alone against 227 KB of
shared memory per H100 block. ``CTA_TILES`` therefore maps each key with one
rule — halve the M and N blocks, capped at 128, and take a K depth of
``bk / 16`` — onto a (BM, BK, BN) tile of ``csrc/gemm_tile.cuh``. Every tile
uses 256 threads and at most 16.6 KB of static shared memory. The batched
kernel takes the same tile per key, with the batch on the grid's z axis:

    variant            TPU (bm, bk, bn)   Hopper CTA (BM, BK, BN)
    mm-128x128x128     (128, 128, 128)    ( 64,  8,  64)
    mm-256x128x128     (256, 128, 128)    (128,  8,  64)
    mm-128x128x256     (128, 128, 256)    ( 64,  8, 128)
    mm-256x128x256     (256, 128, 256)    (128,  8, 128)
    mm-512x128x128     (512, 128, 128)    (128,  8,  64)   M block capped
    mm-128x256x128     (128, 256, 128)    ( 64, 16,  64)
    mm-256x256x256     (256, 256, 256)    (128, 16, 128)
    mm-512x256x256     (512, 256, 256)    (128, 16, 128)   M block capped
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.kernels.matmul.matmul import matmul, matmul_batch

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

# (BM, BK, BN) Hopper CTA tile per variant — the table in the docstring
CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "mm-128x128x128": (64, 8, 64),
    "mm-256x128x128": (128, 8, 64),
    "mm-128x128x256": (64, 8, 128),
    "mm-256x128x256": (128, 8, 128),
    "mm-512x128x128": (128, 8, 64),
    "mm-128x256x128": (64, 16, 64),
    "mm-256x256x256": (128, 16, 128),
    "mm-512x256x256": (128, 16, 128),
}


def matmul_op(x, y, variant: str = "mm-128x128x128", bias=None,
              residual=None, relu: bool = False):
    """(M, K) @ (K, N) under ``variant``'s CTA tile, epilogue fused."""
    bm, bk, bn = CTA_TILES[variant]
    return matmul(x, y, bm=bm, bk=bk, bn=bn, bias=bias, residual=residual,
                  relu=relu)


def matmul_batch_op(x, y, variant: str = "mm-128x128x128", bias=None,
                    residual=None, relu: bool = False):
    """(B, M, K) @ (B, K, N) under ``variant``'s CTA tile, one tile walk per
    batch entry, epilogue fused; ``x`` or ``y`` may be broadcast over B."""
    bm, bk, bn = CTA_TILES[variant]
    return matmul_batch(x, y, bm=bm, bk=bk, bn=bn, bias=bias,
                        residual=residual, relu=relu)
