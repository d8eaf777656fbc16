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

**Routes.** ``route`` picks each call's kernel from the call alone, before
anything launches: bf16 operands with M >= 64 (``matmul.takes_wgmma``),
whatever their alignment, take ``"wgmma"`` (``csrc/matmul_wgmma.cu``),
everything else (fp32, M < 64) ``"mma.sync"`` (``csrc/matmul.cu``) under
``cta_plan``, as before. ``matmul.loaders`` says how the wgmma route reads
each operand: by TMA where TMA can address it (rows of a multiple of 8
elements, 16-byte aligned base and batch stride), else gathered. Where
both come by TMA the plan is the one below, unchanged; otherwise it is a
gathered tile (``WGMMA_GATHER_TILES``, below the table). On the
wgmma route ``WGMMA_CEILINGS`` gives each key a (BM, BN, stages) ceiling, 64
deep a stage: BM half the TPU's bm, capped at 128 (one or two consumer
warpgroups of ``wgmma.m64nBNk16``), BN the TPU's bn, capped at 256, and a
ring of as many stages as the TPU's bk asks and shared memory allows: 4
for bk = 128 and 8 for bk = 256 where the tile is small, 3 and 4 where it
is 128 x 256. The six distinct TPU blocks stay six distinct kernels:

    variant            wgmma (BM, BK, BN) x stages   threads   shared memory
    mm-128x128x128     ( 64, 64, 128) x 4              256      99,392 B
    mm-256x128x128     (128, 64, 128) x 4              384     132,160 B
    mm-128x128x256     ( 64, 64, 256) x 4              256     164,928 B
    mm-256x128x256     (128, 64, 256) x 3              384     148,528 B
    mm-512x128x128     (128, 64, 128) x 4              384     132,160 B   M block capped
    mm-128x256x128     ( 64, 64, 128) x 8              256     197,760 B
    mm-256x256x256     (128, 64, 256) x 4              384     197,696 B
    mm-512x256x256     (128, 64, 256) x 4              384     197,696 B   M block capped

(shared memory: 1,024 bytes of alignment, stages x (BM + BN) x 128 bytes,
16 bytes of barriers a stage; the epilogue reuses the ring.)
``wgmma_plan`` fits BM and BN to the shape as ``cta_plan`` does and splits K
only where the output tiles cannot give every SM a CTA (a wgmma CTA of one
or two consumer warpgroups fills an SM by itself, so the mma.sync rule's
warps per SM do not apply), into as many slices as one wave holds.

A call with a gathered operand takes a gathered tile whatever the variant:
64 x 64 (two CTAs an SM, each with its own producer) where M <= 64, 128 x
64 (one CTA an SM, two consumer warpgroups on one producer) above it, 4
stages; a gathered A takes ``matmul.WGMMA_GATHER_A_TILE``, the one tile
instantiated for it. Measured on resnet18's 20 GEMMs at b = 8
(``tools/ab_matmul_batch_bf16.py --tiles``, ``PERF.md`` section 6), 64 x
64 won every M = 64 layer and 128 x 64 every M >= 256 layer (M = 128:
within 2% either way); 64 x 128 won none and is not instantiated. Where
B's short rows are packed across the batch (``matmul.packs``), the tiles
are counted over the packed columns when the split is decided.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import SMS, WARPS_PER_SM, fit_plan  # noqa: F401
from repro_torch.kernels.matmul.matmul import (TILE_M, TILE_N, WGMMA_BK,
                                               WGMMA_GATHER_A_TILE,
                                               WGMMA_GATHER_TILES,
                                               WGMMA_TILE_M, WGMMA_TILE_N,
                                               loaders, matmul, matmul_batch,
                                               packs, takes_wgmma)

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


# (BM, BN, stages) wgmma ceiling per variant — the second table in the
# docstring
WGMMA_CEILINGS: Dict[str, Tuple[int, int, int]] = {
    "mm-128x128x128": (64, 128, 4),
    "mm-256x128x128": (128, 128, 4),
    "mm-128x128x256": (64, 256, 4),
    "mm-256x128x256": (128, 256, 3),
    "mm-512x128x128": (128, 128, 4),
    "mm-128x256x128": (64, 128, 8),
    "mm-256x256x256": (128, 256, 4),
    "mm-512x256x256": (128, 256, 4),
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


def wgmma_plan(M: int, N: int, K: int, batch: int, variant: str,
               how: str = "tma/tma",
               packed: bool = False) -> Tuple[int, int, int, int, int]:
    """(BM, BN, BK, stages, split_k) for a (batch x) (M, K) @ (K, N) call
    under ``variant`` on the wgmma route: BM and BN the smallest of
    ``WGMMA_TILE_M`` / ``WGMMA_TILE_N`` covering min(M, ceiling BM) and
    min(N, ceiling BN), BK 64, the ceiling's stages, where ``how``
    (``matmul.loaders``) has both operands by TMA; else the smallest of
    ``WGMMA_GATHER_TILES`` covering min(M, 128) rows (``WGMMA_GATHER_A_TILE``
    where A is gathered), the tiles counted over the batch N packed columns
    where ``packed``. K is split only where the output tiles of all batch
    entries are fewer than the ``SMS`` streaming multiprocessors, into as
    many slices as one wave of CTAs holds (``wgmma_split``): ``want =
    min(steps, SMS // tiles)``, dealt out as whole 64-deep steps, ``per =
    ceil(steps / want)`` a slice, split_k = ceil(steps / per). So (5,120,
    2,048, 768) under a 128 x 256 tile, 120 tiles, stays whole, where a
    second slice would start a second wave."""
    if how != "tma/tma":
        bm, bn, stages = (next(t for t in WGMMA_GATHER_TILES if t[0] >= min(M, 128))
                          if how == "tma/gather" else WGMMA_GATHER_A_TILE)
        cols, entries = (N * batch, 1) if packed else (N, batch)
        tiles = -(-M // bm) * -(-cols // bn) * entries
    else:
        cm, cn, stages = WGMMA_CEILINGS[variant]
        bm = next(t for t in WGMMA_TILE_M if t >= min(M, cm))
        bn = next(t for t in WGMMA_TILE_N if t >= min(N, cn))
        tiles = -(-M // bm) * -(-N // bn) * batch
    return bm, bn, WGMMA_BK, stages, wgmma_split(tiles, K)


def wgmma_split(tiles: int, K: int) -> int:
    """split_k of a wgmma call of ``tiles`` output tiles over a K-deep
    reduction: 1 where the tiles give every SM a CTA or K is one step, else
    as many slices as one wave holds, dealt out as whole 64-deep steps
    (``wgmma_plan``)."""
    steps = -(-K // WGMMA_BK)
    if tiles == 0 or tiles >= SMS or steps <= 1:
        return 1
    per = -(-steps // min(steps, SMS // tiles))
    return -(-steps // per)


def route(x: torch.Tensor, y: torch.Tensor) -> str:
    """The kernel a call of ``x`` @ ``y`` (2-D, or batched 3-D) takes:
    ``"wgmma"`` where ``matmul.takes_wgmma`` accepts the operands (bf16, M
    >= 64, any alignment), else ``"mma.sync"``. Decided from the call
    alone; neither route falls back to the other."""
    return "wgmma" if takes_wgmma(x, y) else "mma.sync"


def plan(x: torch.Tensor, y: torch.Tensor, variant: str) -> dict:
    """The launch arguments of ``x`` @ ``y`` under ``variant``: route, tile,
    stages and split, as ``matmul`` / ``matmul_batch`` take them."""
    M, K = x.shape[-2:]
    N, batch = y.shape[-1], (x.shape[0] if x.dim() == 3 else 1)
    if route(x, y) == "wgmma":
        how = loaders(x, y)
        bm, bn, bk, stages, split = wgmma_plan(M, N, K, batch, variant, how,
                                               packs(x, y, how))
        return dict(bm=bm, bk=bk, bn=bn, split_k=split, route="wgmma",
                    stages=stages)
    bm, bn, bk, split = cta_plan(M, N, K, batch, variant, x.dtype)
    return dict(bm=bm, bk=bk, bn=bn, split_k=split, route="mma.sync")


def matmul_op(x, y, variant: str = "mm-128x128x128", bias=None,
              residual=None, relu: bool = False, out_dtype=None):
    """(M, K) @ (K, N) under ``variant``'s plan for this call's route,
    shape and dtype, epilogue applied once to the fp32 sum, stored as
    ``out_dtype`` (default: the operands' dtype)."""
    return matmul(x, y, bias=bias, residual=residual, relu=relu,
                  out_dtype=out_dtype, **plan(x, y, variant))


def matmul_batch_op(x, y, variant: str = "mm-128x128x128", bias=None,
                    residual=None, relu: bool = False, out_dtype=None):
    """(B, M, K) @ (B, K, N) under ``variant``'s plan for this call's
    route, shape and dtype, the batch on the grid, epilogue applied once to
    the fp32 sum, stored as ``out_dtype`` (default: the operands' dtype);
    ``x`` or ``y`` may be broadcast over B."""
    return matmul_batch(x, y, bias=bias, residual=residual, relu=relu,
                        out_dtype=out_dtype, **plan(x, y, variant))
