"""Tiled fp32 matmul with a fused bias -> residual -> ReLU epilogue: the
port of the Pallas kernel ``repro.kernels.matmul.matmul.matmul``.

``matmul`` launches ``csrc/matmul.cu`` for CUDA tensors and computes
``matmul_plain`` — the same function in plain torch, no padding — for CPU
tensors. The CTA tile ``(bm, bk, bn)`` is a Hopper tile from
``ops.CTA_TILES``, not the TPU block.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (bind, check_launch, count_launch,
                                        epilogue, on_cpu, ptr, stream_of)


def matmul_plain(x: torch.Tensor, y: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False) -> torch.Tensor:
    """x (M, K) @ y (K, N), then bias (M,) -> residual (M, N) -> ReLU."""
    return epilogue(x @ y, bias, residual, relu, channel_axis=0)


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 64, bk: int = 8,
           bn: int = 64, bias: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None,
           relu: bool = False) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) fp32 with the epilogue fused before the
    store. ``bias`` is (M,), ``residual`` is (M, N). Ragged edges are masked
    in the kernel; shapes need not divide the tile."""
    M, K = x.shape
    K2, N = y.shape
    if K != K2:
        raise ValueError(f"matmul: inner dims {x.shape} @ {y.shape}")
    if bias is not None and tuple(bias.shape) != (M,):
        raise ValueError(f"matmul: bias {tuple(bias.shape)} != ({M},)")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"matmul: residual {tuple(residual.shape)} != ({M}, {N})")
    if on_cpu("matmul", x, y, bias, residual):
        return matmul_plain(x, y, bias=bias, residual=residual, relu=relu)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    fn = bind("matmul", "rt_matmul_f32", 5, 7)
    check_launch("matmul", fn(ptr(x), ptr(y), ptr(bias), ptr(residual),
                              ptr(out), M, N, K, int(relu), bm, bn, bk,
                              stream_of(x)))
    count_launch("matmul", (M, K, N, bm, bk, bn, bias is not None,
                            residual is not None, bool(relu)))
    return out
