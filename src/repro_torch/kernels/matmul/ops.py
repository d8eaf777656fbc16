"""Variant registry for the matmul kernels (``matmul_op`` and the batched
``matmul_batch_op``), and the rule that turns a TPU block variant and a
GEMM shape into a launch plan for ``csrc/matmul.cu``.

``VARIANTS`` keeps the reference's keys and TPU (bm, bk, bn) blocks, so
every column name the selection produces (``<base>@mm-...``) executes. The
TPU blocks are sized for a 128x128 MXU and many megabytes of VMEM; fp32
``mm-512x256x256`` would need 512 KB for its A block alone against 227 KB of
shared memory per H100 block. ``CTA_TILES`` therefore maps each key onto a
ceiling tile by one rule — halve the M and N blocks, capped at 128, and take
a K depth of ``bk / 8`` (two or four of the tensor core's 8-deep tf32
steps). For bf16 operands (``ceiling(variant, torch.bfloat16)``) the rule
keeps BM and BN and doubles the depth to ``bk / 4``, a multiple of the bf16
mma's 16: a stage then holds the same bytes of A and B as the fp32 stage,
and both dtypes take the same shared memory (three stages):

    variant            TPU (bm, bk, bn)   fp32 (BM, BK, BN)  bf16 (BM, BK, BN)  shared memory
    mm-128x128x128     (128, 128, 128)    ( 64, 16,  64)     ( 64, 32,  64)      29,184 /  29,184 B
    mm-256x128x128     (256, 128, 128)    (128, 16,  64)     (128, 32,  64)      44,544 /  44,544 B
    mm-128x128x256     (128, 128, 256)    ( 64, 16, 128)     ( 64, 32, 128)      41,472 /  41,472 B
    mm-256x128x256     (256, 128, 256)    (128, 16, 128)     (128, 32, 128)      56,832 /  56,832 B
    mm-512x128x128     (512, 128, 128)    (128, 16,  64)     (128, 32,  64)      44,544 /  44,544 B   M block capped
    mm-128x256x128     (128, 256, 128)    ( 64, 32,  64)     ( 64, 64,  64)      55,296 /  55,296 B
    mm-256x256x256     (256, 256, 256)    (128, 32, 128)     (128, 64, 128)     107,520 / 107,520 B
    mm-512x256x256     (512, 256, 256)    (128, 32, 128)     (128, 64, 128)     107,520 / 107,520 B   M block capped

(shared memory fp32 / bf16: 3 (BM (BK + 4) + BK (BN + 8)) * 4 and
3 (BM (BK + 8) + BK (BN + 8)) * 2 bytes; an fp32 B stage of BN = 8 pads by
16.) ``cta_plan`` fits the ceiling to the shape of each call (see its
rule). On a shape that fills the card with ceiling tiles the plan is the
ceiling, so the six distinct ceilings stay six distinct kernels at each
dtype and the selection's columns keep their meaning; the two capped keys
run as their 256-row twins.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

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


def ceiling(variant: str,
            dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """(BM, BK, BN) ceiling tile of ``variant`` for operands of ``dtype``:
    ``CTA_TILES``' for fp32, its depth doubled for bf16 (the table)."""
    bm, bk, bn = CTA_TILES[variant]
    return (bm, 2 * bk, bn) if dtype == torch.bfloat16 else (bm, bk, bn)


def cta_plan(M: int, N: int, K: int, batch: int, variant: str,
             dtype: torch.dtype = torch.float32) -> Tuple[int, int, int, int]:
    """(BM, BN, BK, split_k) for a (batch x) (M, K) @ (K, N) call under
    ``variant`` on operands of ``dtype``: ``common.fit_plan`` on the
    variant's ceiling tile at that dtype and the tile sizes csrc/matmul.cu
    instantiates. BM and BN are the smallest instantiated sizes covering M
    and N under the ceiling; K is split, in whole BK steps, until the output
    tiles give every SM a CTA and 8 warps (or one step per slice)."""
    return fit_plan(M, N, K, batch, ceiling(variant, dtype), TILE_M, TILE_N)


def matmul_op(x, y, variant: str = "mm-128x128x128", bias=None,
              residual=None, relu: bool = False, out_dtype=None):
    """(M, K) @ (K, N) under ``variant``'s plan for this shape and dtype,
    epilogue applied once to the fp32 sum, stored as ``out_dtype`` (default:
    the operands' dtype)."""
    (M, K), N = x.shape, y.shape[1]
    bm, bn, bk, split = cta_plan(M, N, K, 1, variant, x.dtype)
    return matmul(x, y, bm=bm, bk=bk, bn=bn, split_k=split, bias=bias,
                  residual=residual, relu=relu, out_dtype=out_dtype)


def matmul_batch_op(x, y, variant: str = "mm-128x128x128", bias=None,
                    residual=None, relu: bool = False, out_dtype=None):
    """(B, M, K) @ (B, K, N) under ``variant``'s plan for this shape and
    dtype, the batch on the grid, epilogue applied once to the fp32 sum,
    stored as ``out_dtype`` (default: the operands' dtype); ``x`` or ``y``
    may be broadcast over B."""
    B, M, K = x.shape
    bm, bn, bk, split = cta_plan(M, y.shape[2], K, B, variant, x.dtype)
    return matmul_batch(x, y, bm=bm, bk=bk, bn=bn, split_k=split, bias=bias,
                        residual=residual, relu=relu, out_dtype=out_dtype)
