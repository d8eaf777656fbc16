"""Causal or full flash attention over (BH, S, d): the port of the Pallas
kernel ``repro.kernels.flash_attention.flash_attention.flash_attention``,
with its dtype contract (fp32 or bf16 q, k, v; fp32 inside; the output in
q's dtype).

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors —
one CTA per (bh, query block) walks the key blocks up to the causal
diagonal with an online softmax, Q K^T and P V on the tensor cores (fp32
operands at fp32 accuracy by 3xTF32; bf16 operands read as bf16 on bf16
mma with P in two bf16 parts), scores, running max, sum and output
accumulator in fp32 registers — and computes ``flash_attention_plain`` (q,
k, v upcast, the full score matrix, masked, softmax, times V, cast back)
for CPU tensors. The CTA tile ``(bq, bkv)`` is one
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
                                        count_launch, dtype_name, on_cpu, ptr,
                                        stream_of)

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
    when ``causal`` (top-left aligned: query i sees keys 0..i). As the
    reference's kernel does, q, k and v are upcast to fp32 (at least),
    everything is computed there, and the output is cast back to q's
    dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dtype, up = q.dtype, torch.promote_types(q.dtype, torch.float32)
    q, k, v = (t.to(up) for t in (q, k, v))
    s = (q * scale) @ k.transpose(1, 2)
    if causal:
        sq, sk = s.shape[-2:]
        pos = torch.arange(max(sq, sk), device=q.device)
        s = s.masked_fill(pos[:sq, None] < pos[None, :sk], NEG_INF)
    return (torch.softmax(s, dim=-1) @ v).to(dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    bq: int = 64, bkv: int = 64) -> torch.Tensor:
    """q (BH, Sq, d), k and v (BH, Sk, d), all fp32 or all bf16 -> (BH, Sq,
    d) in q's dtype, heads folded into the batch dim (GQA callers repeat
    the KV heads first). ``scale`` (default 1/sqrt(d)) multiplies the fp32
    scores. The CTA tile covers ``bq`` queries by ``bkv`` keys, one of
    ``TILES``; the kernel takes d in ``HEAD_DIMS`` and operands that start
    on a 16-byte boundary (its copies are 16 bytes)."""
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
    lib, suffix = (("flash_attention_bf16", "bf16") if q.dtype == torch.bfloat16
                   else ("flash_attention", "f32"))
    fn = bind(lib, f"rt_flash_attention_{suffix}", 4, 7, 1)
    check_launch("flash_attention", fn(
        ptr(q), ptr(k), ptr(v), ptr(out), bh, sq, sk, d, int(causal), bq, bkv,
        scale, stream_of(q)))
    count_launch("flash_attention", (bh, sq, sk, d, bool(causal), bq, bkv, scale,
                                     dtype_name(q.dtype)))
    return out
