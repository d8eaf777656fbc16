"""Winograd point-GEMM ``M[n, p] = U[p] @ V[n, p]``: the port of the Pallas
kernels ``repro.kernels.winograd.winograd.winograd_point_gemm_batch`` and
``winograd_point_gemm`` (one image).

``winograd_point_gemm_batch`` and ``winograd_point_gemm`` launch
``csrc/winograd.cu`` for CUDA tensors — U is shared across the batch and
read in place (batch stride 0), never copied per image — and compute
``winograd_point_gemm_batch_plain`` / ``winograd_point_gemm_plain`` for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (bind, check_launch, count_launch,
                                        on_cpu, ptr, stream_of)


def winograd_point_gemm_batch_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u (P, K, C), v (N, P, C, T) -> (N, P, K, T)."""
    return torch.einsum("pkc,npct->npkt", u, v)


def winograd_point_gemm_batch(u: torch.Tensor, v: torch.Tensor, *,
                              bm: int = 64, bk: int = 8,
                              bn: int = 64) -> torch.Tensor:
    """u (P, K, C) shared weights, v (N, P, C, T) batched input transform ->
    (N, P, K, T). The CTA tile covers ``bm`` of K by ``bn`` of T with a
    reduction depth of ``bk`` channels; one CTA column per (n, p)."""
    P, K, C = u.shape
    N, P2, C2, T = v.shape
    if (P, C) != (P2, C2):
        raise ValueError(f"winograd_point_gemm_batch: u {tuple(u.shape)} "
                         f"v {tuple(v.shape)}")
    if on_cpu("winograd_point_gemm_batch", u, v):
        return winograd_point_gemm_batch_plain(u, v)
    out = torch.empty((N, P, K, T), dtype=torch.float32, device=u.device)
    fn = bind("winograd", "rt_winograd_point_gemm_batch_f32", 3, 8)
    check_launch("winograd_point_gemm_batch", fn(
        ptr(u), ptr(v), ptr(out), N, P, K, C, T, bm, bn, bk, stream_of(u)))
    count_launch("winograd_point_gemm_batch", (N, P, K, C, T, bm, bk, bn))
    return out


def winograd_point_gemm_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u (P, K, C), v (P, C, T) -> (P, K, T)."""
    return torch.einsum("pkc,pct->pkt", u, v)


def winograd_point_gemm(u: torch.Tensor, v: torch.Tensor, *, bm: int = 64,
                        bk: int = 8, bn: int = 64) -> torch.Tensor:
    """u (P, K, C), v (P, C, T) -> (P, K, T): one image's P point-GEMMs. The
    CTA tile covers ``bm`` of K by ``bn`` of T with a reduction depth of
    ``bk`` channels; one CTA column per point p."""
    P, K, C = u.shape
    P2, C2, T = v.shape
    if (P, C) != (P2, C2):
        raise ValueError(f"winograd_point_gemm: u {tuple(u.shape)} "
                         f"v {tuple(v.shape)}")
    if on_cpu("winograd_point_gemm", u, v):
        return winograd_point_gemm_plain(u, v)
    out = torch.empty((P, K, T), dtype=torch.float32, device=u.device)
    fn = bind("winograd", "rt_winograd_point_gemm_f32", 3, 7)
    check_launch("winograd_point_gemm", fn(
        ptr(u), ptr(v), ptr(out), P, K, C, T, bm, bn, bk, stream_of(u)))
    count_launch("winograd_point_gemm", (P, K, C, T, bm, bk, bn))
    return out
