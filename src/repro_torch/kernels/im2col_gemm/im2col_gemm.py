"""Implicit-GEMM valid convolution with a fused bias -> residual -> ReLU
epilogue: the port of the Pallas kernels
``repro.kernels.im2col_gemm.im2col_gemm.conv_im2col_batch`` and
``conv_im2col`` (one image).

``conv_im2col_batch`` and ``conv_im2col`` launch ``csrc/im2col_gemm.cu`` for
CUDA tensors — each CTA stages its slice of the patch matrix in shared
memory straight from ``x``, so the patch matrix never exists in device
memory — and compute ``conv_im2col_batch_plain`` / ``conv_im2col_plain``
(explicit patch matrix + matmul) for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import (bind, check_launch, count_launch,
                                        epilogue, on_cpu, ptr, stream_of)


def conv_im2col_batch_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                            bias: Optional[torch.Tensor] = None,
                            residual: Optional[torch.Tensor] = None,
                            relu: bool = False) -> torch.Tensor:
    """Explicit (c, a, b)-ordered patch matrix, one matmul, then the epilogue."""
    N, C, H, W = x.shape
    K, _, f, _ = w.shape
    oh, ow = (H - f) // stride + 1, (W - f) // stride + 1
    cols = F.unfold(x, f, stride=stride)                 # (N, C*f*f, oh*ow)
    y = (w.reshape(K, -1) @ cols).reshape(N, K, oh, ow)
    return epilogue(y, bias, residual, relu, channel_axis=1)


def conv_im2col_batch(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                      bm: int = 128, bk: int = 16, bn: int = 64,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      relu: bool = False) -> torch.Tensor:
    """x (N, C, H, W), w (K, C, f, f) -> (N, K, oh, ow), valid padding.
    ``bias`` is (K,), ``residual`` is (N, K, oh, ow). The CTA tile covers
    ``bm`` output channels by ``bn`` output pixels (batch folded in), with a
    reduction depth of ``bk`` patch rows."""
    N, C, H, W = x.shape
    K, C2, f, f2 = w.shape
    if C != C2 or f != f2 or f > min(H, W):
        raise ValueError(f"conv_im2col_batch: x {tuple(x.shape)} w {tuple(w.shape)}")
    oh, ow = (H - f) // stride + 1, (W - f) // stride + 1
    if bias is not None and tuple(bias.shape) != (K,):
        raise ValueError(f"conv_im2col_batch: bias {tuple(bias.shape)} != ({K},)")
    if residual is not None and tuple(residual.shape) != (N, K, oh, ow):
        raise ValueError(f"conv_im2col_batch: residual {tuple(residual.shape)} "
                         f"!= {(N, K, oh, ow)}")
    if on_cpu("conv_im2col_batch", x, w, bias, residual):
        return conv_im2col_batch_plain(x, w, stride, bias=bias,
                                       residual=residual, relu=relu)
    out = torch.empty((N, K, oh, ow), dtype=torch.float32, device=x.device)
    fn = bind("im2col_gemm", "rt_conv_im2col_batch_f32", 5, 13)
    check_launch("conv_im2col_batch", fn(
        ptr(x), ptr(w), ptr(bias), ptr(residual), ptr(out), N, C, H, W, K, f,
        stride, oh, ow, int(relu), bm, bn, bk, stream_of(x)))
    count_launch("conv_im2col_batch", (N, C, H, W, K, f, stride, bm, bk, bn,
                                       bias is not None, residual is not None,
                                       bool(relu)))
    return out


def conv_im2col_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      relu: bool = False) -> torch.Tensor:
    """One image: explicit (c, a, b)-ordered (C*f*f, oh*ow) patch matrix, one
    matmul, then the epilogue."""
    C, H, W = x.shape
    K, _, f, _ = w.shape
    oh, ow = (H - f) // stride + 1, (W - f) // stride + 1
    cols = F.unfold(x[None], f, stride=stride)[0]        # (C*f*f, oh*ow)
    y = (w.reshape(K, -1) @ cols).reshape(K, oh, ow)
    return epilogue(y, bias, residual, relu, channel_axis=0)


def conv_im2col(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
                bm: int = 128, bk: int = 16, bn: int = 64,
                bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
    """x (C, H, W), w (K, C, f, f) -> (K, oh, ow), valid padding. ``bias`` is
    (K,), ``residual`` is (K, oh, ow), read in place (the TPU kernel
    transposes it to (oh, K, ow) for its row grid). The CTA tile covers
    ``bm`` output channels by ``bn`` output pixels with a reduction depth of
    ``bk`` patch rows."""
    C, H, W = x.shape
    K, C2, f, f2 = w.shape
    if C != C2 or f != f2 or f > min(H, W):
        raise ValueError(f"conv_im2col: x {tuple(x.shape)} w {tuple(w.shape)}")
    oh, ow = (H - f) // stride + 1, (W - f) // stride + 1
    if bias is not None and tuple(bias.shape) != (K,):
        raise ValueError(f"conv_im2col: bias {tuple(bias.shape)} != ({K},)")
    if residual is not None and tuple(residual.shape) != (K, oh, ow):
        raise ValueError(f"conv_im2col: residual {tuple(residual.shape)} "
                         f"!= {(K, oh, ow)}")
    if on_cpu("conv_im2col", x, w, bias, residual):
        return conv_im2col_plain(x, w, stride, bias=bias, residual=residual,
                                 relu=relu)
    out = torch.empty((K, oh, ow), dtype=torch.float32, device=x.device)
    fn = bind("im2col_gemm", "rt_conv_im2col_f32", 5, 12)
    check_launch("conv_im2col", fn(
        ptr(x), ptr(w), ptr(bias), ptr(residual), ptr(out), C, H, W, K, f,
        stride, oh, ow, int(relu), bm, bn, bk, stream_of(x)))
    count_launch("conv_im2col", (C, H, W, K, f, stride, bm, bk, bn,
                                 bias is not None, residual is not None,
                                 bool(relu)))
    return out
