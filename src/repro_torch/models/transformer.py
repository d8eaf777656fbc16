"""Model assembly in torch for the dense GQA decoder family: the port of
``repro.models.transformer`` for llama3, chatglm3, gemma2 (local/global
alternation, softcaps, post-norms, (1 + scale) RMSNorm, GELU) and internvl2
(a stubbed vision prefix).

Parameters are the reference's nested dicts, each layer's tensors stacked
on a leading ``n_layers`` axis as its ``_stack`` does; the decode cache
keeps its ``(n_layers, B, S, Hkv, hd)`` layout. What differs:

- A Python loop over layers takes the place of ``lax.scan``; with
  ``cfg.remat`` and grad enabled, ``forward`` runs each layer under
  ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(body)``), so
  backward keeps one layer's activations at a time.
- ``ActShard``/``_cst`` (activation sharding constraints) have no meaning
  on one device and are dropped.
- ``decode_step`` writes the new token's K/V into the cache in place and
  returns the same cache (the reference returns a new one); ``pos`` is a
  Python int. A position past a linear cache's last slot raises (the
  reference's ``dynamic_update_slice`` clamps it onto the last slot).
- MLA, MoE, SSM, hybrid and encoder-decoder configs raise
  ``NotImplementedError`` naming the family: later slices.

Prefill attention of causal, unwindowed, uncapped layers runs on the
hand-written flash attention kernel on the card when no gradient is needed
(``components.attention``); ``loss_fn`` under autograd runs the plain code.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import components as C

Params = Dict[str, Any]
_BIG_WINDOW = 1 << 30


def _dense_gqa_only(cfg: ArchConfig) -> None:
    """Raise for a config outside the dense GQA decoder family."""
    family = ("encoder-decoder" if cfg.kind == "encdec" else
              "hybrid SSM + attention" if cfg.hybrid_attn_every else
              "SSM" if cfg.ssm is not None else
              "MLA" if cfg.attn_kind == "mla" else
              "MoE" if cfg.moe is not None else None)
    if family is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {family} family is not ported yet "
            f"(repro_torch runs the dense GQA decoders)")


def map_params(fn: Callable, tree):
    """``fn`` applied to every tensor of a parameter (or cache) tree, the
    tree's structure kept (e.g. ``map_params(lambda a: a.to("cpu"), p)``)."""
    return ({k: map_params(fn, v) for k, v in tree.items()} if isinstance(tree, dict)
            else fn(tree))


def _layer(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return map_params(lambda a: a[i], layers)


# ---------------------------------------------------------------------------
# Norm dispatch
# ---------------------------------------------------------------------------

def _norm_init(cfg: ArchConfig, d: int, device) -> Params:
    if cfg.norm == "layernorm":
        return C.layernorm_init(d, device=device)
    return C.rmsnorm_init(d, device=device)


def _norm(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return C.layernorm(p, x, cfg.norm_eps)
    return C.rmsnorm(p, x, cfg.norm_eps, plus_one=(cfg.norm == "rmsnorm1p"))


# ---------------------------------------------------------------------------
# Parameter initialisers
# ---------------------------------------------------------------------------

def _attn_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return C.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.param_dtype, qkv_bias=cfg.qkv_bias)


def _dense_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    p: Params = {
        "ln_attn": _norm_init(cfg, cfg.d_model, gen.device),
        "attn": _attn_init(gen, cfg),
        "ln_mlp": _norm_init(cfg, cfg.d_model, gen.device),
        "mlp": C.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype),
    }
    if cfg.post_norms:
        p["ln_attn_post"] = _norm_init(cfg, cfg.d_model, gen.device)
        p["ln_mlp_post"] = _norm_init(cfg, cfg.d_model, gen.device)
    return p


def _stack(init_fn: Callable[[], Params], n: int) -> Params:
    """``n`` draws of ``init_fn()`` stacked on a leading axis, filled one
    layer at a time (the peak is the stack plus one layer)."""
    first = init_fn()
    out = map_params(lambda a: a.new_empty((n, *a.shape)), first)

    def fill(dst, src, i):
        for k in dst:
            if isinstance(dst[k], dict):
                fill(dst[k], src[k], i)
            else:
                dst[k][i].copy_(src[k])

    fill(out, first, 0)
    for i in range(1, n):
        fill(out, init_fn(), i)
    return out


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters drawn from ``gen`` on its device (a CUDA generator
    for the card), in ``cfg.param_dtype`` (norm scales in fp32, as in the
    reference)."""
    _dense_gqa_only(cfg)
    params: Params = {"embed": C.embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype),
                      "final_norm": _norm_init(cfg, cfg.d_model, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = C.dense_init(gen, cfg.d_model, cfg.vocab, cfg.param_dtype)
    params["layers"] = _stack(lambda: _dense_block_init(gen, cfg), cfg.n_layers)
    return params


# ---------------------------------------------------------------------------
# Blocks (forward / prefill)
# ---------------------------------------------------------------------------

def _rot_dim(cfg: ArchConfig) -> Optional[int]:
    return int(cfg.hd * cfg.rope_fraction) if cfg.rope_theta > 0 else None


def _layer_window(cfg: ArchConfig, layer: int) -> Optional[int]:
    """The attention window of ``layer``: under ``alt_local_global`` odd
    layers are global."""
    if cfg.layer_pattern == "alt_local_global":
        return _BIG_WINDOW if layer % 2 == 1 else cfg.window
    return cfg.window


def _dense_block(cfg: ArchConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor, window: Optional[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder block over a full sequence -> (h, k, v), k and v the
    layer's (B, S, Hkv, hd) keys and values after RoPE (prefill caches
    them)."""
    B, Sq, _ = h.shape
    x = _norm(cfg, p["ln_attn"], h)
    q, k, v = C.gqa_project(p["attn"], x, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            positions, cfg.rope_theta, _rot_dim(cfg))
    o = C.attention(q, k, v, positions, positions, causal=True, window=window,
                    softcap=cfg.attn_softcap)
    a = C.dense(p["attn"]["wo"], o.reshape(B, Sq, cfg.n_heads * cfg.hd))
    if cfg.post_norms:
        a = _norm(cfg, p["ln_attn_post"], a)
    h = h + a
    m = C.mlp(p["mlp"], _norm(cfg, p["ln_mlp"], h), cfg.act)
    if cfg.post_norms:
        m = _norm(cfg, p["ln_mlp_post"], m)
    return h + m, k, v


def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = C.embed(params["embed"], tokens)
    if cfg.norm == "rmsnorm1p":         # gemma scales embeddings
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype, device=h.device)
    return h


def _embed_inputs(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) input embeddings, a prefix prepended, and their positions
    0..S-1."""
    h = _embed(params, cfg, tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    return h, torch.arange(h.shape[1], device=h.device)


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """(B, 1, D) last hidden -> (B, vocab) fp32 logits: final norm, tied
    or untied head, final softcap on the fp32 logits."""
    h = _norm(cfg, params["final_norm"], h)
    emb = params["embed"] if cfg.tie_embeddings else {"emb": params["lm_head"]["w"].T}
    logits = C.unembed(emb, h)[:, 0].float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _block_hidden(cfg: ArchConfig, p: Params, h: torch.Tensor,
                  positions: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    return _dense_block(cfg, p, h, positions, window)[0]


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden (B, S, D), aux loss: 0 for dense layers). With
    ``cfg.remat`` and grad enabled each layer is recomputed in backward."""
    _dense_gqa_only(cfg)
    h, positions = _embed_inputs(params, cfg, tokens, prefix_embeds)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        args = (cfg, _layer(params["layers"], i), h, positions, _layer_window(cfg, i))
        h = (checkpoint(_block_hidden, *args, use_reentrant=False) if remat
             else _block_hidden(*args))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _norm(cfg, params["final_norm"], h), aux


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S_text), labels (B, S_text) and optionally
    prefix_embeds / label_mask -> (ce + aux, {"ce", "aux"}). The prefix's
    positions carry no loss; the head is the tied embedding or ``lm_head``."""
    prefix = batch.get("prefix_embeds")
    h, aux = forward(params, cfg, batch["tokens"], prefix_embeds=prefix)
    if prefix is not None:
        h = h[:, prefix.shape[1]:]
    emb = params["embed"] if cfg.tie_embeddings else {"emb": params["lm_head"]["w"].T}
    ce = C.chunked_ce_loss(emb, h, batch["labels"], cfg.loss_chunks,
                           softcap=cfg.final_softcap, label_mask=batch.get("label_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Full-context forward pass that also collects the decode cache.
    Returns (last-position logits (B, vocab) fp32, {"k", "v"} each
    (n_layers, B, S, Hkv, hd), S the input length with the prefix)."""
    _dense_gqa_only(cfg)
    h, positions = _embed_inputs(params, cfg, tokens, prefix_embeds)
    cache: Params = {}
    for i in range(cfg.n_layers):
        h, k, v = _dense_block(cfg, _layer(params["layers"], i), h, positions,
                               _layer_window(cfg, i))
        if i == 0:
            cache = {"k": k.new_empty((cfg.n_layers, *k.shape)),
                     "v": v.new_empty((cfg.n_layers, *v.shape))}
        cache["k"][i], cache["v"][i] = k, v
    return _logits(params, cfg, h[:, -1:]), cache


# ---------------------------------------------------------------------------
# Decode: cache init + single-token step
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Zero K/V caches (n_layers, B, S, Hkv, hd). An all-windowed config
    decodes from a window-long ring; alternating local/global configs keep
    the full length for their global layers."""
    _dense_gqa_only(cfg)
    if cfg.window is not None and cfg.layer_pattern == "global":
        kv_len = min(max_len, cfg.window)
    else:
        kv_len = max_len
    shape = (cfg.n_layers, batch_size, kv_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens: (B, 1); pos: the current length. Returns
    (logits (B, vocab) fp32, the cache, updated in place)."""
    _dense_gqa_only(cfg)
    pos = int(pos)
    h = _embed(params, cfg, tokens)
    q_pos = torch.tensor([pos], device=h.device)
    h = _decode_step_dense(params, cfg, cache, h, q_pos, pos)
    return _logits(params, cfg, h), cache


def _cached_attn(cfg: ArchConfig, p: Params, h: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, q_pos: torch.Tensor, pos: int,
                 window: Optional[int], kv_block: int = 2048) -> torch.Tensor:
    """Project one token, write its K/V into the layer's cache (in place),
    attend over the cache."""
    B = h.shape[0]
    q, k, v = C.gqa_project(p, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd, q_pos,
                            cfg.rope_theta, _rot_dim(cfg))
    S = ck.shape[1]
    # a ring when the cache is exactly the sliding window; else linear slots
    ring = cfg.window is not None and S == cfg.window
    if not ring and pos >= S:
        raise ValueError(f"decode position {pos} is past the cache's {S} slots")
    slot = pos % S if ring else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    idx = torch.arange(S, device=h.device)
    if ring:
        # absolute position held by each slot; never-written slots get a
        # large sentinel so the causal mask kills them during warm-up
        wrap = (pos // S) * S
        k_pos = torch.where(idx <= pos % S, wrap + idx, wrap - S + idx)
        k_pos = torch.where(k_pos < 0, torch.full_like(k_pos, _BIG_WINDOW), k_pos)
    else:
        k_pos = idx
    out = C.attention(q, ck, cv, q_pos, k_pos, causal=True, window=window,
                      softcap=cfg.attn_softcap, kv_block=kv_block)
    return C.dense(p["wo"], out.reshape(B, 1, cfg.n_heads * cfg.hd))


def _decode_step_dense(params: Params, cfg: ArchConfig, cache: Params,
                       h: torch.Tensor, q_pos: torch.Tensor, pos: int) -> torch.Tensor:
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        a = _cached_attn(cfg, p["attn"], _norm(cfg, p["ln_attn"], h),
                         cache["k"][i], cache["v"][i], q_pos, pos,
                         _layer_window(cfg, i))
        if cfg.post_norms:
            a = _norm(cfg, p["ln_attn_post"], a)
        h = h + a
        m = C.mlp(p["mlp"], _norm(cfg, p["ln_mlp"], h), cfg.act)
        if cfg.post_norms:
            m = _norm(cfg, p["ln_mlp_post"], m)
        h = h + m
    return h
