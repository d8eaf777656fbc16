"""Variant-aware conv execution: route a (base primitive, tile variant)
column through the matching hand-written kernel — the port of
``repro.primitives.variants``.

* ``mm-*``   — the base's GEMM stage runs through ``kernels/matmul`` under
  that variant's CTA tile. For im2col bases the patch matrix is lowered in
  torch and the batch is folded into the GEMM N axis (one launch, weights
  shared); for 1x1 the pointwise GEMM maps directly (strided slice first);
  for 2-D Winograd bases the variant tiles the point-GEMM as (K, C, T).
* ``conv-bk*`` — the implicit-GEMM conv kernel (patches staged in shared
  memory) with that K-block.
* ``wino-*`` — the Winograd point-GEMM with that (K, T) tiling.

Compatibility is ``conv.variant_compatible``. Every path takes the fused
epilogue in the reference's order, bias -> residual -> ReLU; semantics equal
the base impl plus the epilogue ops. Kernel operands are made contiguous
here, since the kernels take nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.im2col_gemm.ops import conv_im2col_batch_op
from repro_torch.kernels.matmul.ops import matmul_op
from repro_torch.kernels.winograd.ops import winograd_conv_batch
from repro_torch.primitives.conv import (Primitive, _patches_copy_chw,
                                         _patches_scan_chw, _w_mat,
                                         variant_compatible)


def _gemm_chw(wm: torch.Tensor, x2: torch.Tensor, variant: str, bias, res,
              relu: bool, N: int, K: int, oh: int, ow: int) -> torch.Tensor:
    """Shared mm-* tail: wm (K, R) @ x2 (R, N*oh*ow) through the tiled
    matmul kernel, epilogue fused, result viewed back as (N, K, oh, ow)."""
    res2 = None
    if res is not None:
        res2 = res.permute(1, 0, 2, 3).reshape(K, N * oh * ow).contiguous()
    y2 = matmul_op(wm.contiguous(), x2.contiguous(), variant=variant,
                   bias=bias, residual=res2, relu=relu)        # (K, N*oh*ow)
    return y2.reshape(K, N, oh, ow).permute(1, 0, 2, 3)


def conv_variant_call(prim: Primitive, variant: str, x: torch.Tensor,
                      w: torch.Tensor, stride: int, *,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      relu: bool = False) -> torch.Tensor:
    """Run chw conv ``prim`` under tile ``variant``.

    ``x`` is (C, H, W) or (N, C, H, W); ``w`` is (K, C, f, f). ``bias`` is
    (K,); ``residual`` must already be cropped to the conv's output shape.
    Numerics match ``prim.impl(x, w, stride)`` plus the epilogue ops.
    """
    if not variant_compatible(prim.name, variant):
        raise ValueError(f"variant {variant!r} cannot lower through "
                         f"{prim.name!r}")
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
        if residual is not None:
            residual = residual[None]
    N, C, H, W = x.shape
    K, _, f, _ = w.shape
    x, w = x.contiguous(), w.contiguous()
    if residual is not None:
        residual = residual.contiguous()

    if variant.startswith("conv-bk"):
        y = conv_im2col_batch_op(x, w, stride, variant=variant, bias=bias,
                                 residual=residual, relu=relu)
    elif variant.startswith("wino-") or prim.family == "wino3":
        y = winograd_conv_batch(x, w, m=int(prim.traits["tile_m"]),
                                variant=variant, bias=bias,
                                residual=residual, relu=relu)
    elif variant.startswith("mm-"):
        if prim.family == "c1x1":
            xs = x[..., ::stride, ::stride]
            oh, ow = xs.shape[-2:]
            x2 = xs.reshape(N, C, oh * ow).permute(1, 0, 2).reshape(
                C, N * oh * ow)
            y = _gemm_chw(w[:, :, 0, 0], x2, variant, bias, residual, relu,
                          N, K, oh, ow)
        else:                                     # im2 family, chw/ki
            patches = (_patches_scan_chw if prim.traits.get("trav") == "scan"
                       else _patches_copy_chw)
            pat = patches(x, f, stride)           # (N, C*f*f, oh*ow)
            oh = (H - f) // stride + 1
            ow = (W - f) // stride + 1
            x2 = pat.permute(1, 0, 2).reshape(C * f * f, N * oh * ow)
            y = _gemm_chw(_w_mat(w), x2, variant, bias, residual, relu,
                          N, K, oh, ow)
    else:
        raise ValueError(f"unknown tile variant {variant!r}")
    return y[0] if squeeze else y
