"""Tiled fp32 matmul with a fused bias -> residual -> ReLU epilogue: the
port of the Pallas kernels ``repro.kernels.matmul.matmul.matmul`` and
``matmul_batch``.

``matmul`` and ``matmul_batch`` launch ``csrc/matmul.cu`` for CUDA tensors
and compute ``matmul_plain`` / ``matmul_batch_plain`` — the same functions
in plain torch, no padding — for CPU tensors. The CTA tile ``(bm, bk, bn)``
is a Hopper tile from ``ops.CTA_TILES``, not the TPU block.
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


def matmul_batch_plain(x: torch.Tensor, y: torch.Tensor, *,
                       bias: Optional[torch.Tensor] = None,
                       residual: Optional[torch.Tensor] = None,
                       relu: bool = False) -> torch.Tensor:
    """x (B, M, K) @ y (B, K, N), then bias (M,) -> residual (B, M, N) -> ReLU."""
    return epilogue(x @ y, bias, residual, relu, channel_axis=1)


def _batch_stride(name: str, t: torch.Tensor) -> int:
    """Element stride between the matrices of a (B, R, C) operand whose
    matrices are each contiguous: 0 for a batch broadcast with ``expand``."""
    if not t[0].is_contiguous():
        raise ValueError(f"{name}: each matrix of the batch must be contiguous")
    return t.stride(0) if t.shape[0] > 1 else 0


def matmul_batch(x: torch.Tensor, y: torch.Tensor, *, bm: int = 64,
                 bk: int = 8, bn: int = 64, bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False) -> torch.Tensor:
    """x (B, M, K) @ y (B, K, N) -> (B, M, N) fp32, the batch on the grid's
    z axis, with the epilogue fused before the store. ``bias`` is (M,),
    ``residual`` is (B, M, N). ``x`` and ``y`` may be broadcast over the
    batch (``expand``, batch stride 0): the kernel reads such an operand in
    place through its batch stride, and no copy per batch entry is made.
    Ragged edges are masked in the kernel."""
    B, M, K = x.shape
    B2, K2, N = y.shape
    if (B, K) != (B2, K2) or B < 1:
        raise ValueError(f"matmul_batch: {tuple(x.shape)} @ {tuple(y.shape)}")
    if bias is not None and tuple(bias.shape) != (M,):
        raise ValueError(f"matmul_batch: bias {tuple(bias.shape)} != ({M},)")
    if residual is not None and tuple(residual.shape) != (B, M, N):
        raise ValueError(f"matmul_batch: residual {tuple(residual.shape)} "
                         f"!= {(B, M, N)}")
    sx, sy = _batch_stride("matmul_batch", x), _batch_stride("matmul_batch", y)
    if on_cpu("matmul_batch", x[0], y[0], bias, residual):
        return matmul_batch_plain(x, y, bias=bias, residual=residual, relu=relu)
    out = torch.empty((B, M, N), dtype=torch.float32, device=x.device)
    fn = bind("matmul", "rt_matmul_batch_f32", 5, 10)
    check_launch("matmul_batch", fn(ptr(x), ptr(y), ptr(bias), ptr(residual),
                                    ptr(out), B, M, N, K, int(relu), sx, sy,
                                    bm, bn, bk, stream_of(x)))
    count_launch("matmul_batch", (B, M, K, N, sx == 0, sy == 0, bm, bk, bn,
                                  bias is not None, residual is not None,
                                  bool(relu)))
    return out
