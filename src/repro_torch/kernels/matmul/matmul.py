"""fp32 matmul with a fused bias -> residual -> ReLU epilogue, on the tensor
cores at fp32 accuracy (3xTF32): the port of the Pallas kernels
``repro.kernels.matmul.matmul.matmul`` and ``matmul_batch``.

``matmul`` and ``matmul_batch`` launch ``csrc/matmul.cu`` for CUDA tensors
and compute ``matmul_plain`` / ``matmul_batch_plain`` — the same functions
in plain torch, no padding — for CPU tensors. The caller names the launch
plan: a CTA tile ``(bm, bk, bn)`` that the source instantiates (``TILE_M``
x ``TILE_K`` x ``TILE_N``) and ``split_k``, the number of slices the K walk
is cut into (``ops.cta_plan`` chooses both per shape). With ``split_k > 1``
each slice writes its partial sum to a workspace allocated here, and a
second kernel adds the slices in a fixed order and applies the epilogue
once; the launch still counts once.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (bind, check_int32, check_launch,
                                        check_plan, count_launch, epilogue,
                                        on_cpu, ptr, stream_of)
from repro_torch.kernels.common import cta_warps  # noqa: F401  (re-exported)

# CTA tile sizes csrc/matmul.cu instantiates (RT_FOR_EACH_MMA_TILE): every
# BM of TILE_M with every BN of TILE_N and every BK of TILE_K
TILE_M = (16, 32, 64, 128)
TILE_N = (8, 32, 64, 128)
TILE_K = (16, 32)


def matmul_plain(x: torch.Tensor, y: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False) -> torch.Tensor:
    """x (M, K) @ y (K, N), then bias (M,) -> residual (M, N) -> ReLU."""
    return epilogue(x @ y, bias, residual, relu, channel_axis=0)


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 64, bk: int = 16,
           bn: int = 64, split_k: int = 1, bias: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None,
           relu: bool = False) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) fp32 with the epilogue applied once to
    the full sum. ``bias`` is (M,), ``residual`` is (M, N). Ragged edges
    are zero-filled in the kernel; shapes need not divide the tile."""
    M, K = x.shape
    K2, N = y.shape
    if K != K2:
        raise ValueError(f"matmul: inner dims {x.shape} @ {y.shape}")
    if bias is not None and tuple(bias.shape) != (M,):
        raise ValueError(f"matmul: bias {tuple(bias.shape)} != ({M},)")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"matmul: residual {tuple(residual.shape)} != ({M}, {N})")
    check_plan("matmul", K, bm, bk, bn, split_k, TILE_M, TILE_K, TILE_N)
    check_int32("matmul", M=M, N=N, K=K)
    if on_cpu("matmul", x, y, bias, residual):
        return matmul_plain(x, y, bias=bias, residual=residual, relu=relu)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ws = (torch.empty((split_k, M, N), dtype=torch.float32, device=x.device)
          if split_k > 1 else None)
    fn = bind("matmul", "rt_matmul_f32", 6, 8)
    check_launch("matmul", fn(ptr(x), ptr(y), ptr(bias), ptr(residual),
                              ptr(out), ptr(ws), M, N, K, int(relu), bm, bn,
                              bk, split_k, stream_of(x)))
    count_launch("matmul", (M, K, N, bm, bk, bn, split_k, bias is not None,
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
                 bk: int = 16, bn: int = 64, split_k: int = 1,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False) -> torch.Tensor:
    """x (B, M, K) @ y (B, K, N) -> (B, M, N) fp32, the batch on the grid's
    z axis, with the epilogue applied once to the full sum. ``bias`` is
    (M,), ``residual`` is (B, M, N). ``x`` and ``y`` may be broadcast over
    the batch (``expand``, batch stride 0): the kernel reads such an operand
    in place through its batch stride (passed as 64 bits), and no copy per
    batch entry is made. Ragged edges are zero-filled in the kernel."""
    B, M, K = x.shape
    B2, K2, N = y.shape
    if (B, K) != (B2, K2) or B < 1:
        raise ValueError(f"matmul_batch: {tuple(x.shape)} @ {tuple(y.shape)}")
    if bias is not None and tuple(bias.shape) != (M,):
        raise ValueError(f"matmul_batch: bias {tuple(bias.shape)} != ({M},)")
    if residual is not None and tuple(residual.shape) != (B, M, N):
        raise ValueError(f"matmul_batch: residual {tuple(residual.shape)} "
                         f"!= {(B, M, N)}")
    check_plan("matmul_batch", K, bm, bk, bn, split_k, TILE_M, TILE_K,
               TILE_N)
    check_int32("matmul_batch", B=B, M=M, N=N, K=K)
    sx, sy = _batch_stride("matmul_batch", x), _batch_stride("matmul_batch", y)
    if on_cpu("matmul_batch", x[0], y[0], bias, residual):
        return matmul_batch_plain(x, y, bias=bias, residual=residual, relu=relu)
    out = torch.empty((B, M, N), dtype=torch.float32, device=x.device)
    ws = (torch.empty((split_k, B, M, N), dtype=torch.float32, device=x.device)
          if split_k > 1 else None)
    fn = bind("matmul", "rt_matmul_batch_f32", 6, 9, n_longs=2)
    check_launch("matmul_batch", fn(ptr(x), ptr(y), ptr(bias), ptr(residual),
                                    ptr(out), ptr(ws), B, M, N, K, int(relu),
                                    bm, bn, bk, split_k, sx, sy, stream_of(x)))
    count_launch("matmul_batch", (B, M, K, N, sx == 0, sy == 0, bm, bk, bn,
                                  split_k, bias is not None,
                                  residual is not None, bool(relu)))
    return out
