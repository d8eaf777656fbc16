"""Matmul with a fused bias -> residual -> ReLU epilogue on the tensor
cores: the port of the Pallas kernels ``repro.kernels.matmul.matmul.matmul``
and ``matmul_batch``, with their dtype contract.

``matmul`` and ``matmul_batch`` launch ``csrc/matmul.cu`` for CUDA tensors
and compute ``matmul_plain`` / ``matmul_batch_plain`` — the same functions
in plain torch, no padding — for CPU tensors. Operands are fp32 (run at fp32
accuracy, 3xTF32) or bf16 (one bf16 tensor-core product per fragment), the
two of one call of one dtype; bias and residual each have the operands'
dtype or fp32 (a bf16 product takes an fp32 bias or residual). The sum is
fp32 and the epilogue runs on it in fp32, widening bias and residual, as
the reference's ``_finish`` does; the output is stored once in
``out_dtype`` (fp32 or bf16, default: the operands' dtype), the
reference's signature. The caller names the launch plan: a CTA tile
``(bm, bk, bn)`` that the source instantiates (``TILE_M`` x ``TILE_K`` x
``TILE_N`` for fp32, ``TILE_K_BF16`` deep for bf16) and ``split_k``, the
number of slices the K walk is cut into (``ops.cta_plan`` chooses both per
shape). With ``split_k > 1`` each slice writes its fp32 partial sum to a
workspace allocated here, and a second kernel adds the slices in a fixed
order and applies the epilogue once; the launch still counts once.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (bind, check_int32, check_launch,
                                        check_plan, count_launch, dtype_name,
                                        epilogue, on_cpu, ptr, stream_of)
from repro_torch.kernels.common import cta_warps  # noqa: F401  (re-exported)

# CTA tile sizes csrc/matmul.cu instantiates (RT_FOR_EACH_MMA_TILE,
# RT_FOR_EACH_BF16_TILE): every BM of TILE_M with every BN of TILE_N and
# every BK of TILE_K (fp32) or TILE_K_BF16 (bf16: a stage of the same bytes)
TILE_M = (16, 32, 64, 128)
TILE_N = (8, 32, 64, 128)
TILE_K = (16, 32)
TILE_K_BF16 = (32, 64)
OUT_DTYPES = (torch.float32, torch.bfloat16)
# operand dtype -> (library, suffix of its C entry points)
_LIB = {torch.float32: ("matmul", "f32"), torch.bfloat16: ("matmul_bf16", "bf16")}


def tile_k(dtype: torch.dtype) -> tuple:
    """The K depths instantiated for operands of ``dtype``."""
    return TILE_K_BF16 if dtype == torch.bfloat16 else TILE_K


def _out_dtype(name: str, x: torch.Tensor, out_dtype) -> torch.dtype:
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    return out_dtype


def _ep(t: Optional[torch.Tensor]):
    """An epilogue tensor as a launch signature records it: its dtype's
    name, or False where the call has none."""
    return False if t is None else dtype_name(t.dtype)


def _bf16(out_dtype, bias, residual) -> tuple:
    """The entry points' flags (out_bf16, bias_bf16, res_bf16)."""
    ep = [None if t is None else t.dtype for t in (bias, residual)]
    return tuple(int(d == torch.bfloat16) for d in (out_dtype, *ep))


def _plain(x, y, bias, residual, relu, out_dtype, channel_axis):
    """The product in fp32 on the operands' values, the epilogue in fp32,
    one cast to ``out_dtype`` (or the operands' dtype)."""
    f = lambda t: None if t is None else t.float()  # noqa: E731
    out = epilogue(f(x) @ f(y), f(bias), f(residual), relu, channel_axis)
    return out.to(x.dtype if out_dtype is None else out_dtype)


def matmul_plain(x: torch.Tensor, y: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False, out_dtype=None) -> torch.Tensor:
    """x (M, K) @ y (K, N), then bias (M,) -> residual (M, N) -> ReLU, in
    fp32, stored as ``out_dtype`` (default: the operands' dtype)."""
    return _plain(x, y, bias, residual, relu, out_dtype, channel_axis=0)


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 64,
           bk: Optional[int] = None, bn: int = 64, split_k: int = 1,
           bias: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None,
           relu: bool = False, out_dtype=None) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) in ``out_dtype`` (default: the
    operands' dtype), the epilogue applied once to the fp32 sum. ``bias``
    is (M,), ``residual`` is (M, N). Ragged edges are zero-filled in the
    kernel; shapes need not divide the tile. ``bk`` defaults to the
    dtype's shallowest instantiated depth."""
    M, K = x.shape
    K2, N = y.shape
    if K != K2:
        raise ValueError(f"matmul: inner dims {x.shape} @ {y.shape}")
    if bias is not None and tuple(bias.shape) != (M,):
        raise ValueError(f"matmul: bias {tuple(bias.shape)} != ({M},)")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"matmul: residual {tuple(residual.shape)} != ({M}, {N})")
    out_dtype = _out_dtype("matmul", x, out_dtype)
    bk = tile_k(x.dtype)[0] if bk is None else bk
    check_plan("matmul", K, bm, bk, bn, split_k, TILE_M, tile_k(x.dtype),
               TILE_N)
    check_int32("matmul", M=M, N=N, K=K)
    if on_cpu("matmul", x, y, epilogue=(bias, residual)):
        return matmul_plain(x, y, bias=bias, residual=residual, relu=relu,
                            out_dtype=out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws = (torch.empty((split_k, M, N), dtype=torch.float32, device=x.device)
          if split_k > 1 else None)
    lib, suffix = _LIB[x.dtype]
    fn = bind(lib, f"rt_matmul_{suffix}", 6, 11)
    check_launch("matmul", fn(ptr(x), ptr(y), ptr(bias), ptr(residual),
                              ptr(out), ptr(ws), M, N, K, int(relu), bm, bn,
                              bk, split_k, *_bf16(out_dtype, bias, residual),
                              stream_of(x)))
    count_launch("matmul", (M, K, N, bm, bk, bn, split_k, _ep(bias),
                            _ep(residual), bool(relu), dtype_name(x.dtype),
                            dtype_name(out_dtype)))
    return out


def matmul_batch_plain(x: torch.Tensor, y: torch.Tensor, *,
                       bias: Optional[torch.Tensor] = None,
                       residual: Optional[torch.Tensor] = None,
                       relu: bool = False, out_dtype=None) -> torch.Tensor:
    """x (B, M, K) @ y (B, K, N), then bias (M,) -> residual (B, M, N) ->
    ReLU, in fp32, stored as ``out_dtype`` (default: the operands' dtype)."""
    return _plain(x, y, bias, residual, relu, out_dtype, channel_axis=1)


def _batch_stride(name: str, t: torch.Tensor) -> int:
    """Element stride between the matrices of a (B, R, C) operand whose
    matrices are each contiguous: 0 for a batch broadcast with ``expand``."""
    if not t[0].is_contiguous():
        raise ValueError(f"{name}: each matrix of the batch must be contiguous")
    return t.stride(0) if t.shape[0] > 1 else 0


def matmul_batch(x: torch.Tensor, y: torch.Tensor, *, bm: int = 64,
                 bk: Optional[int] = None, bn: int = 64, split_k: int = 1,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False, out_dtype=None) -> torch.Tensor:
    """x (B, M, K) @ y (B, K, N) -> (B, M, N) in ``out_dtype`` (default: the
    operands' dtype), the batch on the grid's z axis, with the epilogue
    applied once to the fp32 sum. ``bias`` is
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
    out_dtype = _out_dtype("matmul_batch", x, out_dtype)
    bk = tile_k(x.dtype)[0] if bk is None else bk
    check_plan("matmul_batch", K, bm, bk, bn, split_k, TILE_M,
               tile_k(x.dtype), TILE_N)
    check_int32("matmul_batch", B=B, M=M, N=N, K=K)
    sx, sy = _batch_stride("matmul_batch", x), _batch_stride("matmul_batch", y)
    if on_cpu("matmul_batch", x[0], y[0], epilogue=(bias, residual)):
        return matmul_batch_plain(x, y, bias=bias, residual=residual, relu=relu,
                                  out_dtype=out_dtype)
    out = torch.empty((B, M, N), dtype=out_dtype, device=x.device)
    ws = (torch.empty((split_k, B, M, N), dtype=torch.float32, device=x.device)
          if split_k > 1 else None)
    lib, suffix = _LIB[x.dtype]
    fn = bind(lib, f"rt_matmul_batch_{suffix}", 6, 12, n_longs=2)
    check_launch("matmul_batch", fn(ptr(x), ptr(y), ptr(bias), ptr(residual),
                                    ptr(out), ptr(ws), B, M, N, K, int(relu),
                                    bm, bn, bk, split_k,
                                    *_bf16(out_dtype, bias, residual), sx, sy,
                                    stream_of(x)))
    count_launch("matmul_batch", (B, M, K, N, sx == 0, sy == 0, bm, bk, bn,
                                  split_k, _ep(bias), _ep(residual),
                                  bool(relu), dtype_name(x.dtype),
                                  dtype_name(out_dtype)))
    return out
