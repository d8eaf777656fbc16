"""Causal or full fp32 flash attention over (BH, S, d): the port of the
Pallas kernel ``repro.kernels.flash_attention.flash_attention.flash_attention``.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors —
one CTA per (bh, query block) walks the key blocks up to the causal
diagonal with an online softmax, Q K^T and P V on the tensor cores at fp32
accuracy (3xTF32), scores, running max, sum and output accumulator in fp32
registers — and computes ``flash_attention_plain`` (the full score matrix,
masked, softmax, times V) for CPU tensors. The CTA tile ``(bq, bkv)`` is one
of the Hopper tiles in ``TILES``, not the TPU block; the kernel masks ragged
edges, so the sequence lengths need not divide it. The kernel has no
backward (the reference's Pallas kernel has no VJP): a call on CUDA tensors
through which autograd would need a gradient raises ``KernelError`` instead
of returning an output with no ``grad_fn``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.common import (KernelError, bind, check_launch,
                                        count_launch, on_cpu, ptr, stream_of)

NEG_INF = -1e30                      # the reference's mask value
HEAD_DIMS = (32, 64, 128)            # head dims the CUDA kernel instantiates
# (BQ, BKV) CTA tiles the CUDA kernel instantiates: BQ / 16 warps of 16 query
# rows each, BKV keys per step of the KV loop
TILES = ((64, 32), (64, 64), (128, 32), (128, 64))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q (BH, Sq, d), k and v (BH, Sk, d) -> (BH, Sq, d): softmax((scale q)
    k^T) v with scores of key positions past the query's set to ``NEG_INF``
    when ``causal`` (top-left aligned: query i sees keys 0..i)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = (q * scale) @ k.transpose(1, 2)
    if causal:
        sq, sk = s.shape[-2:]
        pos = torch.arange(max(sq, sk), device=q.device)
        s = s.masked_fill(pos[:sq, None] < pos[None, :sk], NEG_INF)
    return torch.softmax(s, dim=-1) @ v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    bq: int = 64, bkv: int = 64) -> torch.Tensor:
    """q (BH, Sq, d), k and v (BH, Sk, d) -> (BH, Sq, d) fp32, heads folded
    into the batch dim (GQA callers repeat the KV heads first). ``scale``
    defaults to 1/sqrt(d). The CTA tile covers ``bq`` queries by ``bkv``
    keys, one of ``TILES``; the kernel takes d in ``HEAD_DIMS`` and
    operands that start on a 16-byte boundary (its copies are 16 bytes)."""
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if on_cpu("flash_attention", q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise KernelError("flash_attention: the kernel has no backward; "
                          "operands require grad")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel for head dim {d} "
                         f"(instantiated: {HEAD_DIMS})")
    if (bq, bkv) not in TILES:
        raise ValueError(f"flash_attention: ({bq}, {bkv}) is not an "
                         f"instantiated tile {TILES}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must start on a 16-byte "
                         "boundary")
    sk = k.shape[1]
    out = torch.empty_like(q)
    fn = bind("flash_attention", "rt_flash_attention_f32", 4, 7, 1)
    check_launch("flash_attention", fn(
        ptr(q), ptr(k), ptr(v), ptr(out), bh, sq, sk, d, int(causal), bq, bkv,
        scale, stream_of(q)))
    count_launch("flash_attention", (bh, sq, sk, d, bool(causal), bq, bkv, scale))
    return out
