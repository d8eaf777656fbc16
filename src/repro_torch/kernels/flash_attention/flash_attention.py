"""Causal or full flash attention over (BH, S, d): the port of the Pallas
kernel ``repro.kernels.flash_attention.flash_attention.flash_attention``,
with its dtype contract (fp32 or bf16 q, k, v; fp32 inside; the output in
q's dtype).

``flash_attention`` launches a hand-written kernel for CUDA tensors — one
CTA per (bh, query block) walks the key blocks up to the causal diagonal
with an online softmax, scores, running max, sum and output accumulator in
fp32 registers — and computes ``flash_attention_plain`` (q, k, v upcast,
the full score matrix, masked, softmax, times V, cast back) for CPU
tensors. The kernel has no backward (the reference's Pallas kernel has no
VJP): a call on CUDA tensors through which autograd would need a gradient
raises ``KernelError`` instead of returning an output with no ``grad_fn``.

**Grouped-query attention in place.** k and v hold ``BH / rep`` heads:
query row ``bh`` reads KV row ``bh // rep`` (heads folded as ``b * H + h``
over ``b * Hkv + h // rep``), so no caller repeats K and V.

**Routes.** ``route`` picks each call's kernel from the call alone, before
anything launches: bf16 q, k, v with d in ``WGMMA_HEAD_DIMS`` and 16-byte
aligned bases (what TMA needs) take ``"wgmma"`` (``csrc/flash_wgmma.cu``:
TMA, a producer warp and one or two ``wgmma`` consumer warpgroups, P V with
P from registers), everything else ``"mma.sync"`` (``csrc/flash_attention.
cu``: fp32 on 3xTF32, bf16 on bf16 mma with P in two bf16 parts). A call
that names a route it does not fit raises ``ValueError``; neither route
falls back to the other. The CTA tile ``(bq, bkv)`` is one of the route's
Hopper tiles (``TILES``; ``WGMMA_TILES`` at the head dim), not the TPU
block; the kernels mask ragged edges, so the sequence lengths need not
divide it. The launch signature records ``rep`` and the route.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.common import (KernelError, bind, check_launch,
                                        count_launch, dtype_name, on_cpu, ptr,
                                        stream_of)

NEG_INF = -1e30                      # the reference's mask value
HEAD_DIMS = (32, 64, 128)            # head dims the mma.sync kernels instantiate
# (BQ, BKV) CTA tiles the mma.sync kernels instantiate: BQ / 16 warps of 16
# query rows each, BKV keys per step of the KV loop
TILES = ((64, 32), (64, 64), (128, 32), (128, 64))
WGMMA_HEAD_DIMS = (64, 128)          # head dims csrc/flash_wgmma.cu instantiates
# (BQ, BKV, d) tiles csrc/flash_wgmma.cu instantiates
# (RT_FOR_EACH_FLASH_WGMMA_TILE): BQ / 64 consumer warpgroups, BKV keys a
# stage of its ring; 128 keys only at d = 64 (a consumer holds S, P's two
# parts and O in registers)
WGMMA_TILES = ((64, 64, 64), (64, 128, 64), (128, 64, 64), (128, 128, 64),
               (64, 64, 128), (128, 64, 128))
ROUTES = ("mma.sync", "wgmma")


def takes_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the wgmma route can take the call: bf16 q, k and v, a head
    dim in ``WGMMA_HEAD_DIMS`` (rows of 128 or 256 bytes) and base addresses
    on a 16-byte boundary, what TMA needs to address every row. Plain
    comparisons: an entry point asks on every call."""
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        return False
    if q.shape[-1] not in WGMMA_HEAD_DIMS:
        return False
    return all(t.data_ptr() % 16 == 0 for t in (q, k, v))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a call on ``q``, ``k``, ``v`` takes: ``"wgmma"`` where
    ``takes_wgmma`` accepts them, else ``"mma.sync"``. Decided from the call
    alone; neither route falls back to the other."""
    return "wgmma" if takes_wgmma(q, k, v) else "mma.sync"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          rep: int = 1) -> torch.Tensor:
    """q (BH, Sq, d), k and v (BH / rep, Sk, d) -> (BH, Sq, d): softmax((scale
    q) k^T) v, query row bh against KV row bh // rep, with scores of key
    positions past the query's set to ``NEG_INF`` when ``causal`` (top-left
    aligned: query i sees keys 0..i). As the reference's kernel does, q, k
    and v are upcast to fp32 (at least), everything is computed there, and
    the output is cast back to q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dtype, up = q.dtype, torch.promote_types(q.dtype, torch.float32)
    if rep > 1:
        kv_of = torch.arange(q.shape[0], device=k.device) // rep
        k, v = k[kv_of], v[kv_of]
    q, k, v = (t.to(up) for t in (q, k, v))
    s = (q * scale) @ k.transpose(1, 2)
    if causal:
        sq, sk = s.shape[-2:]
        pos = torch.arange(max(sq, sk), device=q.device)
        s = s.masked_fill(pos[:sq, None] < pos[None, :sk], NEG_INF)
    return (torch.softmax(s, dim=-1) @ v).to(dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    bq: int = 64, bkv: int = 64, rep: int = 1,
                    force_route: Optional[str] = None) -> torch.Tensor:
    """q (BH, Sq, d), k and v (BH / rep, Sk, d), all fp32 or all bf16 ->
    (BH, Sq, d) in q's dtype, heads folded into the batch dim; query row bh
    attends KV row bh // rep. ``scale`` (default 1/sqrt(d)) multiplies the
    fp32 scores. ``force_route`` names the kernel (``ROUTES``; default:
    ``route``'s choice). The CTA tile covers ``bq`` queries by ``bkv``
    keys: one of ``TILES`` at d in ``HEAD_DIMS`` on the mma.sync route, one
    of ``WGMMA_TILES`` at d on the wgmma route. Both kernels take operands
    that start on a 16-byte boundary (their copies are 16 bytes)."""
    bh, sq, d = q.shape
    if (rep < 1 or bh % rep or k.shape != v.shape or k.shape[0] * rep != bh
            or k.shape[2] != d or sq < 1 or k.shape[1] < 1):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} rep {rep}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    chosen = route(q, k, v) if force_route is None else force_route
    if chosen not in ROUTES:
        raise ValueError(f"flash_attention: route must be one of {ROUTES}, "
                         f"got {chosen!r}")
    if chosen == "wgmma" and not takes_wgmma(q, k, v):
        raise ValueError("flash_attention: the wgmma route takes bf16 q, k, v "
                         f"with d in {WGMMA_HEAD_DIMS} and 16-byte aligned "
                         f"bases; got {q.dtype} d={d}")
    tiles = ({(a, b) for a, b, dd in WGMMA_TILES if dd == d}
             if chosen == "wgmma" else set(TILES))
    if on_cpu("flash_attention", q, k, v):
        if (bq, bkv) not in tiles:
            raise ValueError(f"flash_attention: ({bq}, {bkv}) is not an "
                             f"instantiated {chosen} tile at d={d}")
        return flash_attention_plain(q, k, v, causal=causal, scale=scale, rep=rep)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise KernelError("flash_attention: the kernel has no backward; "
                          "operands require grad")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel for head dim {d} "
                         f"(instantiated: {HEAD_DIMS})")
    if (bq, bkv) not in tiles:
        raise ValueError(f"flash_attention: ({bq}, {bkv}) is not an "
                         f"instantiated {chosen} tile at d={d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must start on a 16-byte "
                         "boundary")
    sk = k.shape[1]
    out = torch.empty_like(q)
    if chosen == "wgmma":
        fn = bind("flash_wgmma", "rt_flash_wgmma_bf16", 4, 8, 1)
        err = fn(ptr(q), ptr(k), ptr(v), ptr(out), bh, sq, sk, d, int(causal),
                 bq, bkv, rep, scale, stream_of(q))
    else:
        lib, suffix = (("flash_attention_bf16", "bf16") if q.dtype == torch.bfloat16
                       else ("flash_attention", "f32"))
        fn = bind(lib, f"rt_flash_attention_{suffix}", 4, 8, 1)
        err = fn(ptr(q), ptr(k), ptr(v), ptr(out), bh, sq, sk, d, int(causal),
                 bq, bkv, rep, scale, stream_of(q))
    check_launch("flash_attention", err)
    count_launch("flash_attention", (bh, sq, sk, d, bool(causal), bq, bkv, rep,
                                     chosen, scale, dtype_name(q.dtype)))
    return out
