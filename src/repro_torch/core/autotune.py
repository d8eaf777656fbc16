"""Tile columns of the conv kernels — the port's copy of the part of
``repro.core.autotune`` that names them: ``PALLAS_CONV_BASES`` and
``pallas_columns``.

A tile column ``<base>@<variant>`` is a runnable base primitive executed
under one tile variant of a hand-written kernel (``primitives/variants.py``);
selection treats each pair as its own column. The reference's columns take
the matmul variants only; the port's take every variant family its kernels
have (``mm-*``, ``conv-bk*``, ``wino-*``), filtered to the pairs the plan
can run: 55 columns over the five bases, of which the 40 ``mm-*`` ones are
the reference's.

The reference's analytic TPU surface (``conv_tile_time_batch``,
``pallas_dlt_time_batch``, ``PallasTileProvider``) does not apply on the
card: there the tile columns are measured (``profiler/device.py``,
``service.platforms.GpuPlatform``). The LM matmul-site autotune comes with
the LM slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.kernels.im2col_gemm.ops import VARIANTS as CONV_VARIANTS
from repro_torch.kernels.matmul.ops import VARIANTS as MM_VARIANTS
from repro_torch.kernels.winograd.ops import VARIANTS as WINO_VARIANTS
from repro_torch.primitives.conv import tile_columns

# Kernel-backed base primitives: im2col lowerings ride the matmul or the
# implicit-GEMM conv kernel, winograd the Winograd point-GEMM, 1x1 the
# matmul or the implicit-GEMM conv. Only runnable bases.
PALLAS_CONV_BASES: Tuple[str, ...] = (
    "im2col-copy-ab-ki",
    "im2col-scan-ab-ki",
    "winograd-2x2-3x3",
    "winograd-4x4-3x3",
    "conv-1x1-gemm-ab-ki",
)

TILE_VARIANTS: Tuple[str, ...] = (*MM_VARIANTS, *CONV_VARIANTS, *WINO_VARIANTS)


def pallas_columns(bases: Sequence[str] = PALLAS_CONV_BASES,
                   variants: Optional[Sequence[str]] = None) -> List[str]:
    """The (base primitive × tile variant) column set, pairs the plan can
    run only; ``variants`` defaults to every variant of the three kernels."""
    return tile_columns(bases, list(variants) if variants is not None
                        else list(TILE_VARIANTS))
