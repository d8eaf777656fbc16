"""Transformer building blocks in torch: the port of
``repro.models.components``.

Parameters are plain nested dicts of tensors, keyed and laid out as the
reference keys and lays out its pytrees: activations (B, S, D), weights in
matmul-ready (d_in, d_out) orientation. Initialisers take an explicit
``torch.Generator`` and draw on its device; they cannot reproduce JAX's
PRNG, so parity with the reference goes through
``repro_torch.convert.lm_params_from_jax``, never through a seed.

``attention`` is the reference's function, with one dispatch added: on CUDA
tensors, a prefill call the hand-written flash attention kernel computes
exactly (causal or not, positions shared by queries and keys, no window
short of the keys, no softcap, a head dim the kernel instantiates) and
through which no gradient is needed runs on the kernel (``_flash_route``);
every other call runs the torch port of the reference's ``jnp`` code. The kernel has no
backward, as the reference's Pallas kernel has no VJP, so training
attention is the reference's plain code under autograd. A kernel that fails
to build or launch raises ``KernelError``; nothing falls back.

MLA (``mla_*``, MiniCPM3 / DeepSeek-V2 multi-head latent attention) expands
the cached latent to per-head K/V in prefill and runs decode in the latent
space (the absorbed path). Its prefill attention stays on the plain path:
the kernel needs equal q/k and v head dims.

``chunked_ce_loss`` is the training loss: each sequence chunk's fp32 logits
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so
the full (B, S, vocab) logits never exist.

torch's matmul and einsum refuse mixed float dtypes where ``jnp`` promotes
them; ``promoted`` casts operands to their common dtype first, as
``jnp.result_type`` would.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.flash_attention import (HEAD_DIMS,
                                                                 flash_attention)
from repro_torch.kernels.flash_attention.ops import fold_heads, plan

Params = Dict[str, Any]
FLASH_VARIANT = "fa-128x128"         # the kernel tile the LM prefill runs under


def promoted(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors cast to their common dtype (``jnp.result_type``: bf16
    with fp32 is fp32); a tensor already of it is returned as is."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return tuple(t.to(dt) for t in ts)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """In fp32, cast back to x's dtype; ``plus_one`` scales by (1 + scale)
    (gemma)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    if plus_one:
        scale = 1.0 + scale
    return (x * scale).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In fp32 with the population variance (``jnp.var``)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# Dense / embeddings
# ---------------------------------------------------------------------------

class ShapesOnly:
    """Stands in for the generator of every initialiser here and gives the
    parameters' shapes and dtypes without drawing or allocating: each
    tensor is an uninitialised ``meta`` tensor."""
    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """Normals drawn in fp32 on the generator's device, times ``scale``,
    cast to ``dtype`` (for ``ShapesOnly``, an empty ``meta`` tensor)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.bfloat16,
               scale: Optional[float] = None) -> Params:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": normal(gen, (d_in, d_out), s, dtype)}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16) -> Params:
    return {"emb": normal(gen, (vocab, d), 0.02, dtype)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table (``emb[tokens]``); ``F.embedding`` sums a repeated
    token's gradient in a fixed order, where indexing's backward does not."""
    return F.embedding(tokens, params["emb"])


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: (B, S, D) @ (V, D)^T."""
    return x @ params["emb"].T


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, rot_dim: Optional[int] = None,
               device="cuda") -> torch.Tensor:
    rd = rot_dim if rot_dim is not None else head_dim
    return 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32,
                                         device=device) / rd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               rot_dim: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,). Rotates the interleaved pairs
    (x[..., 0::2], x[..., 1::2]) of the first ``rot_dim`` dims (partial
    rotary: chatglm3 rotates half)."""
    hd = x.shape[-1]
    rd = rot_dim if rot_dim is not None else hd
    freqs = rope_freqs(hd, theta, rd, device=x.device)           # (rd/2,)
    ang = positions[:, None].float() * freqs                     # (S, rd/2)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rot, xp], dim=-1) if rd < hd else rot


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------

def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) additive fp32 bias: 0 allowed, -inf masked."""
    d = q_pos[:, None].long() - k_pos[None, :].long()
    ok = d >= 0 if causal else torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if window is not None:
        ok = ok & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, zero - math.inf)


def flash_routed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                 window: Optional[int], softcap: Optional[float]) -> bool:
    """Whether ``attention`` runs this call on the flash attention kernel:
    CUDA tensors, a prefill (Sq > 1) self-attention over the same positions
    for queries and keys (one arange in prefill and forward, so the
    reference's causal mask is the kernel's top-left diagonal), causal or
    not (an encoder), no window shorter than the keys, no softcap, a head
    dim the kernel instantiates for both K and V, and no gradient needed
    through q, k or v (the kernel has no backward). Cross-attention
    (``k_pos`` another tensor) and decode stay plain. Decided from the
    call's semantics before any launch."""
    Sq, hd, Sk, vd = q.shape[1], q.shape[-1], k.shape[1], v.shape[-1]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return (q.is_cuda and Sq > 1 and Sq == Sk and q_pos is k_pos
            and (window is None or window >= Sk) and softcap is None
            and hd in HEAD_DIMS and vd == hd and not grad)


def _flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 sc: float, causal: bool = True) -> torch.Tensor:
    """The reference's prefill attention on the flash attention kernel:
    q scaled in its own dtype (as the reference does), heads folded into
    the batch dim, K and V with their own Hkv heads (the kernel reads KV
    head h // rep in place, where the reference repeats them with
    ``jnp.repeat``), the kernel at scale 1 under ``FLASH_VARIANT``'s plan
    for this call's route (it masks ragged edges, so any length runs). q, k
    and v stay in their dtype, fp32 or bf16: the kernel computes in fp32
    inside and returns q's dtype, so a bf16 prefill makes no fp32 copy of
    them. On CPU tensors ``flash_attention`` computes its plain version,
    which is how the CPU tests reach this glue."""
    B, Sq, Hq, hd = q.shape
    qf, kf, vf = fold_heads(q * sc), fold_heads(k), fold_heads(v)
    out = flash_attention(qf, kf, vf, causal=causal, scale=1.0,
                          rep=Hq // k.shape[2], **plan(qf, kf, vf, FLASH_VARIANT))
    return out.reshape(B, Hq, Sq, hd).transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              kv_block: int = 1024) -> torch.Tensor:
    """GQA attention. q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd);
    q_pos/k_pos: (Sq,)/(Sk,) absolute positions -> (B, Sq, Hq, vd) in q's
    dtype. Prefill (Sq > 1) attends one shot up to Sk = max(kv_block, 2048)
    keys and blockwise (online softmax over ``kv_block`` keys) beyond, with
    K/V broadcast to the query heads; decode (Sq == 1) is a grouped einsum
    without the broadcast. Calls ``flash_routed`` accepts run on the
    kernel instead."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    vd = v.shape[-1]
    rep = Hq // Hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    Sk = k.shape[1]

    if flash_routed(q, k, v, q_pos, k_pos, causal=causal, window=window,
                    softcap=softcap):
        return _flash_route(q, k, v, sc, causal)

    if Sq > 1:
        qf = (q * sc).float()

        def blk_attend(kc, vc, pc):
            if rep > 1:
                kc = torch.repeat_interleave(kc, rep, dim=2)
                vc = torch.repeat_interleave(vc, rep, dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float())
            logits = _softcap(logits, softcap)
            logits = logits + _mask_bias(q_pos, pc, causal, window)[None, None]
            return logits, vc

        if Sk <= max(kv_block, 2048):
            logits, vc = blk_attend(k, v, k_pos)
            p = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", p, vc.float())
            return out.to(q.dtype)

        nblk = Sk // kv_block
        if nblk * kv_block != Sk:
            raise ValueError("Sk must divide kv_block for blockwise path")
        m = torch.full((B, Hq, Sq), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hq, Sq, vd), dtype=torch.float32, device=q.device)
        for i in range(nblk):
            blk = slice(i * kv_block, (i + 1) * kv_block)
            logits, vc = blk_attend(k[:, blk], v[:, blk], k_pos[blk])  # (B, H, Sq, kb)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.transpose(1, 2).to(q.dtype)                  # (B, Sq, H, vd)

    # ---- decode (Sq == 1): grouped single shot, no K/V broadcast ----
    qf = (q * sc).float().reshape(B, Sq, Hkv, rep, hd)
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qf, k.float())
    logits = _softcap(logits, softcap)
    logits = logits + _mask_bias(q_pos, k_pos, causal, window)[None, None, None]
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", p, v.float())
    return out.reshape(B, Sq, Hq, vd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int, head_dim: int,
             dtype=torch.bfloat16, qkv_bias: bool = False) -> Params:
    p = {
        "wq": dense_init(gen, d, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d, n_kv * head_dim, dtype),
        "wv": dense_init(gen, d, n_kv * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d, dtype),
    }
    if qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
    return p


def gqa_project(params: Params, x: torch.Tensor, n_heads: int, n_kv: int,
                head_dim: int, positions: torch.Tensor, rope_theta: float,
                rot_dim: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = dense(params["wq"], x)
    k = dense(params["wk"], x)
    v = dense(params["wv"], x)
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta, rot_dim)
        k = apply_rope(k, positions, rope_theta, rot_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLADims:
    q_lora: int = 768
    kv_lora: int = 256
    qk_nope: int = 64
    qk_rope: int = 32
    v_head: int = 64


def mla_init(gen: torch.Generator, d: int, n_heads: int, dims: MLADims,
             dtype=torch.bfloat16) -> Params:
    qk_head = dims.qk_nope + dims.qk_rope
    return {
        "wdq": dense_init(gen, d, dims.q_lora, dtype),
        "q_norm": rmsnorm_init(dims.q_lora, device=gen.device),
        "wuq": dense_init(gen, dims.q_lora, n_heads * qk_head, dtype),
        "wdkv": dense_init(gen, d, dims.kv_lora, dtype),
        "kv_norm": rmsnorm_init(dims.kv_lora, device=gen.device),
        "wkr": dense_init(gen, d, dims.qk_rope, dtype),
        "wukv": dense_init(gen, dims.kv_lora, n_heads * (dims.qk_nope + dims.v_head), dtype),
        "wo": dense_init(gen, n_heads * dims.v_head, d, dtype),
    }


def mla_project(params: Params, x: torch.Tensor, n_heads: int, dims: MLADims,
                positions: torch.Tensor, rope_theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (q (B, S, H, qk_nope + qk_rope) with its rope dims
    rotated, c_kv (B, S, kv_lora), k_rope (B, S, qk_rope) rotated): the
    latent (c_kv, k_rope) is what decode caches."""
    B, S, _ = x.shape
    cq = rmsnorm(params["q_norm"], dense(params["wdq"], x))
    q = dense(params["wuq"], cq).reshape(B, S, n_heads, dims.qk_nope + dims.qk_rope)
    q_nope, q_rope = q[..., :dims.qk_nope], q[..., dims.qk_nope:]
    q = torch.cat([q_nope, apply_rope(q_rope, positions, rope_theta)], dim=-1)
    c_kv = rmsnorm(params["kv_norm"], dense(params["wdkv"], x))
    k_rope = dense(params["wkr"], x).reshape(B, S, 1, dims.qk_rope)
    k_rope = apply_rope(k_rope, positions, rope_theta)
    return q, c_kv, k_rope[:, :, 0, :]


def mla_attend(params: Params, q: torch.Tensor, c_kv: torch.Tensor,
               k_rope: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
               n_heads: int, dims: MLADims, *, causal: bool = True,
               kv_block: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, qk); c_kv (B, Sk, kv_lora); k_rope (B, Sk, qk_rope) ->
    the layer's output (B, Sq, D) after ``wo``.

    Prefill (Sq > 1) expands the latent to per-head K (qk_nope + qk_rope
    dims) and V (v_head dims) and runs ``attention``. Decode (Sq == 1) is
    the absorbed path, in fp32: W_uk folded into the query, attention over
    the latent itself, W_uv applied to its output, cast to q's dtype before
    ``wo``; the (B, Sk, H, .) expansion never exists."""
    B, Sk, _ = c_kv.shape
    Sq = q.shape[1]
    scale = 1.0 / math.sqrt(dims.qk_nope + dims.qk_rope)

    if Sq == 1:
        w = params["wukv"]["w"].reshape(-1, n_heads, dims.qk_nope + dims.v_head).float()
        w_uk, w_uv = w[..., :dims.qk_nope], w[..., dims.qk_nope:]
        q_nope, q_rope = q[..., :dims.qk_nope].float(), q[..., dims.qk_nope:].float()
        ckv = c_kv.float()
        q_lat = torch.einsum("bqhn,chn->bqhc", q_nope, w_uk)
        logits = (torch.einsum("bqhc,bkc->bhqk", q_lat, ckv)
                  + torch.einsum("bqhr,bkr->bhqk", q_rope, k_rope.float())) * scale
        logits = logits + _mask_bias(q_pos, k_pos, causal, None)[None, None]
        p = torch.softmax(logits, dim=-1)
        o_lat = torch.einsum("bhqk,bkc->bqhc", p, ckv)
        out = torch.einsum("bqhc,chv->bqhv", o_lat, w_uv)
        return dense(params["wo"], out.to(q.dtype).reshape(B, 1, n_heads * dims.v_head))

    kv = dense(params["wukv"], c_kv).reshape(B, Sk, n_heads, dims.qk_nope + dims.v_head)
    k_nope, v = kv[..., :dims.qk_nope], kv[..., dims.qk_nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Sk, n_heads, dims.qk_rope)],
                  dim=-1)
    out = attention(q, k, v, q_pos, k_pos, causal=causal, scale=scale, kv_block=kv_block)
    return dense(params["wo"], out.reshape(B, Sq, n_heads * dims.v_head))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.bfloat16,
             gated: bool = True) -> Params:
    p = {"w_up": dense_init(gen, d, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, d, dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, d, d_ff, dtype)
    return p


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    """silu, or GELU in its tanh form (``jax.nn.gelu``'s default)."""
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = dense(params["w_up"], x)
    if "w_gate" in params:
        h = _act(dense(params["w_gate"], x), act) * h
    else:
        h = _act(h, act)
    return dense(params["w_down"], h)


# ---------------------------------------------------------------------------
# Cross-entropy (sequence-chunked: never materialises (B, S, V) at once)
# ---------------------------------------------------------------------------

def _ce_chunk(emb: torch.Tensor, hc: torch.Tensor, lc: torch.Tensor,
              mc: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """Summed masked CE of one chunk: fp32 logits, softcap, logsumexp minus
    the gold logit."""
    logits = _softcap(unembed({"emb": emb}, hc).float(), softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mc)


def chunked_ce_loss(emb_params: Params, h: torch.Tensor, labels: torch.Tensor,
                    n_chunks: int = 8, softcap: Optional[float] = None,
                    label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h: (B, S, D) final hidden; labels: (B, S). Mean CE over ``n_chunks``
    slabs of the sequence (lowered until it divides S), each slab's logits
    recomputed in backward instead of stored, so the (B, S, V) logits never
    exist at once."""
    B, S, D = h.shape
    n_chunks = min(n_chunks, S)
    while S % n_chunks:
        n_chunks -= 1
    c = S // n_chunks
    emb = emb_params["emb"]
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        mc = (torch.ones((B, c), dtype=torch.float32, device=h.device)
              if label_mask is None else label_mask[:, sl].float())
        tot = tot + checkpoint(_ce_chunk, emb, h[:, sl], labels[:, sl], mc,
                               softcap, use_reentrant=False)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)
