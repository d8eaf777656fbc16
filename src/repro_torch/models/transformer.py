"""Model assembly in torch: the port of ``repro.models.transformer`` for
every assigned family. Dense GQA decoders (llama3, chatglm3, gemma2 with
local/global alternation, softcaps, post-norms, (1 + scale) RMSNorm, GELU,
and internvl2 with a stubbed vision prefix), MLA (minicpm3), MoE (mixtral,
qwen3-moe), pure SSM (mamba2), hybrid SSM + shared attention (zamba2) and
encoder-decoder (whisper: LayerNorm, learned positions, GELU MLPs).

Parameters are the reference's nested dicts, each layer's tensors stacked
on a leading ``n_layers`` axis as its ``_stack`` does (the hybrid's SSM
blocks on (groups, per group), its shared attention block unstacked); the
decode cache keeps the reference's layouts. What differs:

- A Python loop over layers takes the place of ``lax.scan``. With
  ``cfg.remat`` and grad enabled, ``forward`` runs each of the reference's
  ``jax.checkpoint`` bodies under ``torch.utils.checkpoint``: a decoder
  layer, an SSM block, an encoder layer, an encoder-decoder's decoder
  layer, and for the hybrid a whole group of SSM blocks with the shared
  block after it. Backward keeps one such unit's activations at a time.
- ``forward`` takes each layer's parameters by one ``torch.unbind`` of
  every stacked leaf, so backward stacks a leaf's layer gradients once
  (indexing one layer at a time adds a full-stack gradient a layer).
- ``ActShard``/``_cst`` (activation sharding constraints) have no meaning
  on one device and are dropped.
- ``decode_step`` writes the new token's cache entries in place and
  returns the same cache (the reference returns a new one); ``pos`` is a
  Python int. A position past a linear cache's last slot raises (the
  reference's ``dynamic_update_slice`` clamps it onto the last slot).
- Every function takes every family: the serving path (``init_params``,
  ``prefill``, ``init_cache``, ``decode_step``) and the training path
  (``forward``, ``loss_fn``; the MoE aux loss summed over the layers).

Prefill self-attention that is unwindowed (or windowed no shorter than the
sequence) and uncapped, at a head dim the kernel instantiates, runs on the
hand-written flash attention kernel on the card when no gradient is needed
(``components.attention``): the dense and MoE decoders' and Whisper's
causal decoder and non-causal encoder. MLA (qk 96 != v 64) and zamba2's
shared block (head dim 80) run the plain code, as does every decode step
and cross-attention. ``forward`` and ``loss_fn`` under autograd run the
plain code for every family (the kernel has no backward).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import components as C
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

Params = Dict[str, Any]
_BIG_WINDOW = 1 << 30


def map_params(fn: Callable, tree):
    """``fn`` applied to every tensor of a parameter (or cache) tree, the
    tree's structure kept (e.g. ``map_params(lambda a: a.to("cpu"), p)``)."""
    return ({k: map_params(fn, v) for k, v in tree.items()} if isinstance(tree, dict)
            else fn(tree))


def _layer(layers: Params, *i: int) -> Params:
    """The parameters at index ``i`` of the stacked axes (one index a
    layer; two for the hybrid's (group, block)): views into the stack."""
    return map_params(lambda a: a[i], layers)


def _unstack(layers: Params, n: int) -> List[Params]:
    """The ``n`` layers' parameters along the leading stacked axis, by one
    ``torch.unbind`` a leaf: under autograd a leaf's layer gradients are
    stacked once in backward."""
    parts = map_params(torch.unbind, layers)
    return [map_params(lambda t: t[i], parts) for i in range(n)]


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
    if cfg.attn_kind == "mla":
        return C.mla_init(gen, cfg.d_model, cfg.n_heads, cfg.mla, cfg.param_dtype)
    return C.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.param_dtype, qkv_bias=cfg.qkv_bias)


def _dense_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    p: Params = {
        "ln_attn": _norm_init(cfg, cfg.d_model, gen.device),
        "attn": _attn_init(gen, cfg),
        "ln_mlp": _norm_init(cfg, cfg.d_model, gen.device),
    }
    if cfg.moe is not None:
        p["moe"] = M.moe_init(gen, cfg.d_model, cfg.moe, cfg.param_dtype)
    else:
        p["mlp"] = C.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)
    if cfg.post_norms:
        p["ln_attn_post"] = _norm_init(cfg, cfg.d_model, gen.device)
        p["ln_mlp_post"] = _norm_init(cfg, cfg.d_model, gen.device)
    return p


def _ssm_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"ln": _norm_init(cfg, cfg.d_model, gen.device),
            "ssm": S.ssm_init(gen, cfg.d_model, cfg.ssm, cfg.param_dtype)}


def _enc_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {
        "ln_attn": _norm_init(cfg, cfg.d_model, gen.device),
        "attn": C.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           cfg.param_dtype),
        "ln_mlp": _norm_init(cfg, cfg.d_model, gen.device),
        "mlp": C.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype, gated=False),
    }


def _dec_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Encoder-decoder decoder block: self-attention, cross-attention, MLP."""
    gqa = lambda: C.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, cfg.param_dtype)
    return {
        "ln_self": _norm_init(cfg, cfg.d_model, gen.device),
        "self_attn": gqa(),
        "ln_cross": _norm_init(cfg, cfg.d_model, gen.device),
        "cross_attn": gqa(),
        "ln_mlp": _norm_init(cfg, cfg.d_model, gen.device),
        "mlp": C.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype, gated=False),
    }


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
    for the card), in ``cfg.param_dtype`` (norm scales, the MoE router and
    the SSM's A_log, D and dt_bias in fp32, as in the reference)."""
    params: Params = {"embed": C.embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype),
                      "final_norm": _norm_init(cfg, cfg.d_model, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = C.dense_init(gen, cfg.d_model, cfg.vocab, cfg.param_dtype)
    if cfg.pos == "learned":
        params["pos_emb"] = C.embed_init(gen, cfg.max_position, cfg.d_model,
                                         cfg.param_dtype)
    if cfg.kind == "encdec":
        params["enc_layers"] = _stack(lambda: _enc_block_init(gen, cfg), cfg.n_enc_layers)
        params["enc_final_norm"] = _norm_init(cfg, cfg.d_model, gen.device)
        params["layers"] = _stack(lambda: _dec_block_init(gen, cfg), cfg.n_layers)
    elif cfg.hybrid_attn_every:
        per = cfg.hybrid_attn_every
        params["layers"] = _stack(lambda: _stack(lambda: _ssm_block_init(gen, cfg), per),
                                  cfg.n_layers // per)
        params["shared"] = _dense_block_init(gen, cfg)
    elif cfg.ssm is not None:
        params["layers"] = _stack(lambda: _ssm_block_init(gen, cfg), cfg.n_layers)
    else:
        params["layers"] = _stack(lambda: _dense_block_init(gen, cfg), cfg.n_layers)
    return params


def param_shapes(cfg: ArchConfig) -> Params:
    """``init_params``'s tree as ``meta`` tensors: every leaf's shape and
    dtype, nothing drawn or allocated (``components.ShapesOnly``)."""
    return init_params(C.ShapesOnly(), cfg)


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


def _self_attn(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
               window: Optional[int], causal: bool = True
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over a full sequence -> (output (B, S, D) after
    ``wo``, what decode caches: GQA's (k, v) (B, S, Hkv, hd) after RoPE,
    MLA's latent (c_kv, k_rope))."""
    B, Sq, _ = x.shape
    if cfg.attn_kind == "mla":
        q, ckv, kr = C.mla_project(p, x, cfg.n_heads, cfg.mla, positions, cfg.rope_theta)
        return C.mla_attend(p, q, ckv, kr, positions, positions, cfg.n_heads,
                            cfg.mla, causal=causal), (ckv, kr)
    q, k, v = C.gqa_project(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            positions, cfg.rope_theta, _rot_dim(cfg))
    o = C.attention(q, k, v, positions, positions, causal=causal, window=window,
                    softcap=cfg.attn_softcap)
    return C.dense(p["wo"], o.reshape(B, Sq, cfg.n_heads * cfg.hd)), (k, v)


def _ffn(cfg: ArchConfig, p: Params, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP or MoE layer -> (output, aux loss: 0 for an MLP)."""
    if cfg.moe is not None:
        return M.moe_apply(p["moe"], x, cfg.moe)
    return C.mlp(p["mlp"], x, cfg.act), torch.zeros((), dtype=torch.float32,
                                                     device=x.device)


def _dense_block(cfg: ArchConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor, window: Optional[int]
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One decoder block over a full sequence -> (h, the layer's cache
    entries, aux loss)."""
    a, kv = _self_attn(cfg, p["attn"], _norm(cfg, p["ln_attn"], h), positions, window)
    if cfg.post_norms:
        a = _norm(cfg, p["ln_attn_post"], a)
    h = h + a
    m, aux = _ffn(cfg, p, _norm(cfg, p["ln_mlp"], h))
    if cfg.post_norms:
        m = _norm(cfg, p["ln_mlp_post"], m)
    return h + m, kv, aux


def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = C.embed(params["embed"], tokens)
    if cfg.norm == "rmsnorm1p":         # gemma scales embeddings
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype, device=h.device)
    return h


def _embed_inputs(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) input embeddings, a prefix prepended and learned positions
    0..S-1 added, and those positions."""
    h = _embed(params, cfg, tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    Sq = h.shape[1]
    if cfg.pos == "learned":
        h = h + params["pos_emb"]["emb"][:Sq][None]
    return h, torch.arange(Sq, device=h.device)


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """(B, 1, D) last hidden -> (B, vocab) fp32 logits: final norm, tied
    or untied head, final softcap on the fp32 logits."""
    h = _norm(cfg, params["final_norm"], h)
    emb = params["embed"] if cfg.tie_embeddings else {"emb": params["lm_head"]["w"].T}
    logits = C.unembed(emb, h)[:, 0].float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _remat(on: bool, fn: Callable, *args):
    """``fn(*args)``; with ``on``, under ``torch.utils.checkpoint``, so
    backward recomputes what ``fn`` saved instead of keeping it."""
    return checkpoint(fn, *args, use_reentrant=False) if on else fn(*args)


def _ssm_hidden(cfg: ArchConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """An SSM block with its residual."""
    return h + S.ssm_block(p["ssm"], _norm(cfg, p["ln"], h), cfg.ssm, cfg.d_model)


def _hybrid_group(cfg: ArchConfig, group: Params, shared: Params, h: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """One hybrid group: its SSM blocks, then the shared attention block
    (a dense block: its aux is 0)."""
    for p in _unstack(group, cfg.hybrid_attn_every):
        h = _ssm_hidden(cfg, p, h)
    return _dense_block(cfg, shared, h, positions, cfg.window)[0]


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden (B, S, D), aux loss: the MoE layers' summed, 0
    for every other family). An encoder-decoder needs ``enc_embeds`` (B,
    Se, D). With ``cfg.remat`` and grad enabled each layer (the hybrid: each
    group) is recomputed in backward."""
    h, positions = _embed_inputs(params, cfg, tokens, prefix_embeds)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.kind == "encdec":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: forward needs enc_embeds")
        enc = _encode(params, cfg, enc_embeds)
        enc_pos = torch.arange(enc.shape[1], device=h.device)
        for p in _unstack(params["layers"], cfg.n_layers):
            h = _remat(remat, _dec_layer, cfg, p, h, positions, enc, enc_pos)[0]
    elif cfg.hybrid_attn_every:
        for group in _unstack(params["layers"], cfg.n_layers // cfg.hybrid_attn_every):
            h = _remat(remat, _hybrid_group, cfg, group, params["shared"], h, positions)
    elif cfg.ssm is not None:
        for p in _unstack(params["layers"], cfg.n_layers):
            h = _remat(remat, _ssm_hidden, cfg, p, h)
    else:
        for i, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
            h, _, a = _remat(remat, _dense_block, cfg, p, h, positions,
                             _layer_window(cfg, i))
            aux = aux + a
    return _norm(cfg, params["final_norm"], h), aux


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S_text), labels (B, S_text) and optionally
    prefix_embeds / enc_embeds / label_mask -> (ce + aux, {"ce", "aux"}).
    The prefix's positions carry no loss; the head is the tied embedding or
    ``lm_head``."""
    prefix = batch.get("prefix_embeds")
    h, aux = forward(params, cfg, batch["tokens"], prefix_embeds=prefix,
                     enc_embeds=batch.get("enc_embeds"))
    if prefix is not None:
        h = h[:, prefix.shape[1]:]
    emb = params["embed"] if cfg.tie_embeddings else {"emb": params["lm_head"]["w"].T}
    ce = C.chunked_ce_loss(emb, h, batch["labels"], cfg.loss_chunks,
                           softcap=cfg.final_softcap, label_mask=batch.get("label_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def _stacked(cache: Params, name: str, i, a: torch.Tensor, n) -> None:
    """Write ``a`` at index ``i`` of the cache leaf ``name``, made on first
    use with the leading stacked axes ``n`` (a tuple)."""
    if name not in cache:
        cache[name] = a.new_empty((*n, *a.shape))
    cache[name][i] = a


def _enc_layer(cfg: ArchConfig, p: Params, h: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """An encoder layer: non-causal self-attention, then the GELU MLP."""
    a, _ = _self_attn(cfg, p["attn"], _norm(cfg, p["ln_attn"], h), positions, None,
                      causal=False)
    h = h + a
    return h + C.mlp(p["mlp"], _norm(cfg, p["ln_mlp"], h), cfg.act)


def _encode(params: Params, cfg: ArchConfig, enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over (B, Se, D) frame embeddings (cast to
    ``param_dtype``): learned positions, its layers (each recomputed in
    backward under ``cfg.remat``), the final norm."""
    Se = enc_embeds.shape[1]
    h = enc_embeds.to(cfg.param_dtype)
    if cfg.pos == "learned":
        h = h + params["pos_emb"]["emb"][:Se][None]
    positions = torch.arange(Se, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in _unstack(params["enc_layers"], cfg.n_enc_layers):
        h = _remat(remat, _enc_layer, cfg, p, h, positions)
    return _norm(cfg, params["enc_final_norm"], h)


def _dec_layer(cfg: ArchConfig, p: Params, h: torch.Tensor, positions: torch.Tensor,
               enc: torch.Tensor, enc_pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """An encoder-decoder's decoder layer: causal self-attention, cross
    attention over K/V projected from the encoder output, the MLP -> (h,
    the layer's cache entries (k, v, ck, cv))."""
    a, (k, v) = _self_attn(cfg, p["self_attn"], _norm(cfg, p["ln_self"], h), positions,
                           None)
    h = h + a
    _, ke, ve = C.gqa_project(p["cross_attn"], enc, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              enc_pos, 0.0)
    h = h + _cross_attn(cfg, p["cross_attn"], _norm(cfg, p["ln_cross"], h), positions,
                        ke, ve, enc_pos)
    return h + C.mlp(p["mlp"], _norm(cfg, p["ln_mlp"], h), cfg.act), (k, v, ke, ve)


def _cross_attn(cfg: ArchConfig, p: Params, x: torch.Tensor, q_pos: torch.Tensor,
                ke: torch.Tensor, ve: torch.Tensor, enc_pos: torch.Tensor,
                kv_block: int = 1024) -> torch.Tensor:
    """Cross-attention of x's queries over the encoder's keys and values
    (no RoPE, not causal) -> (B, Sq, D) after ``wo``."""
    B, Sq, _ = x.shape
    q, _, _ = C.gqa_project(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd, q_pos, 0.0)
    o = C.attention(q, ke, ve, q_pos, enc_pos, causal=False, kv_block=kv_block)
    return C.dense(p["wo"], o.reshape(B, Sq, cfg.n_heads * cfg.hd))


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Full-context forward pass that also collects the decode cache.
    Returns (last-position logits (B, vocab) fp32, cache), the cache's
    sequence axes as long as the input with the prefix:

    - dense and MoE: {"k", "v"} (n_layers, B, S, Hkv, hd);
    - MLA: {"ckv" (n_layers, B, S, kv_lora), "kr" (n_layers, B, S, qk_rope)};
    - SSM: {"ssm" (n_layers, B, H, P, N) fp32, "conv" (n_layers, B,
      d_conv - 1, conv_dim)};
    - hybrid: "ssm", "conv" on (groups, per group, ...) and the shared
      block's {"k", "v"} (groups, B, S, Hkv, hd);
    - encoder-decoder (``enc_embeds`` (B, Se, D) required): the decoder's
      {"k", "v"} and the cross-attention's {"ck", "cv"} (n_layers, B, Se,
      Hkv, hd)."""
    h, positions = _embed_inputs(params, cfg, tokens, prefix_embeds)
    L = cfg.n_layers
    cache: Params = {}

    if cfg.kind == "encdec":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: prefill needs enc_embeds")
        enc = _encode(params, cfg, enc_embeds)
        enc_pos = torch.arange(enc.shape[1], device=h.device)
        for i in range(L):
            h, entries = _dec_layer(cfg, _layer(params["layers"], i), h, positions,
                                    enc, enc_pos)
            for name, a in zip(("k", "v", "ck", "cv"), entries):
                _stacked(cache, name, i, a, (L,))

    elif cfg.ssm is not None:
        # the hybrid's SSM blocks in groups of ``per``, the shared attention
        # block after each group; a pure SSM stack is one group
        hybrid = bool(cfg.hybrid_attn_every)
        per = cfg.hybrid_attn_every or L
        lead = (L // per, per) if hybrid else (L,)
        for g in range(L // per):
            for j in range(per):
                at = (g, j) if hybrid else (j,)
                p = _layer(params["layers"], *at)
                y, st, cs = S.ssm_block(p["ssm"], _norm(cfg, p["ln"], h), cfg.ssm,
                                        cfg.d_model, return_state=True)
                h = h + y
                _stacked(cache, "ssm", at, st, lead)
                _stacked(cache, "conv", at, cs, lead)
            if hybrid:
                h, (k, v), _ = _dense_block(cfg, params["shared"], h, positions,
                                            cfg.window)
                _stacked(cache, "k", g, k, lead[:1])
                _stacked(cache, "v", g, v, lead[:1])

    else:
        names = ("ckv", "kr") if cfg.attn_kind == "mla" else ("k", "v")
        for i in range(L):
            h, kv, _ = _dense_block(cfg, _layer(params["layers"], i), h, positions,
                                    _layer_window(cfg, i))
            for name, a in zip(names, kv):
                _stacked(cache, name, i, a, (L,))
    return _logits(params, cfg, h[:, -1:]), cache


# ---------------------------------------------------------------------------
# Decode: cache init + single-token step
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, enc_len: int = 0,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Zero caches in ``prefill``'s layouts, ``max_len`` slots long
    (``enc_len`` for the cross-attention's), the SSM states in fp32. An
    all-windowed config (and the hybrid's shared block) decodes from a
    window-long ring; alternating local/global configs keep the full length
    for their global layers."""
    B, L = batch_size, cfg.n_layers
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if cfg.kind == "encdec":
        kv = (L, B, max_len, cfg.n_kv_heads, cfg.hd)
        ckv = (L, B, enc_len, cfg.n_kv_heads, cfg.hd)
        return {"k": z(*kv), "v": z(*kv), "ck": z(*ckv), "cv": z(*ckv)}
    if cfg.ssm is not None:
        ssm = cfg.ssm
        H = ssm.n_heads(cfg.d_model)
        conv_dim = ssm.d_inner(cfg.d_model) + 2 * ssm.n_groups * ssm.d_state
        lead = ((L // cfg.hybrid_attn_every, cfg.hybrid_attn_every)
                if cfg.hybrid_attn_every else (L,))
        cache = {"ssm": z(*lead, B, H, ssm.headdim, ssm.d_state, dt=torch.float32),
                 "conv": z(*lead, B, ssm.d_conv - 1, conv_dim)}
        if cfg.hybrid_attn_every:
            kv_len = min(max_len, cfg.window) if cfg.window else max_len
            kv = (lead[0], B, kv_len, cfg.n_kv_heads, cfg.hd)
            cache.update(k=z(*kv), v=z(*kv))
        return cache
    if cfg.attn_kind == "mla":
        return {"ckv": z(L, B, max_len, cfg.mla.kv_lora),
                "kr": z(L, B, max_len, cfg.mla.qk_rope)}
    if cfg.window is not None and cfg.layer_pattern == "global":
        kv_len = min(max_len, cfg.window)
    else:
        kv_len = max_len
    kv = (L, B, kv_len, cfg.n_kv_heads, cfg.hd)
    return {"k": z(*kv), "v": z(*kv)}


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens: (B, 1); pos: the current length. Returns
    (logits (B, vocab) fp32, the cache, updated in place)."""
    pos = int(pos)
    h = _embed(params, cfg, tokens)
    if cfg.pos == "learned":
        h = h + params["pos_emb"]["emb"][pos][None, None]
    q_pos = torch.tensor([pos], device=h.device)
    if cfg.kind == "encdec":
        h = _decode_step_encdec(params, cfg, cache, h, q_pos, pos)
    elif cfg.hybrid_attn_every:
        h = _decode_step_hybrid(params, cfg, cache, h, q_pos, pos)
    elif cfg.ssm is not None:
        h = _decode_step_ssm(params, cfg, cache, h)
    else:
        h = _decode_step_dense(params, cfg, cache, h, q_pos, pos)
    return _logits(params, cfg, h), cache


def _slot(cfg: ArchConfig, S: int, pos: int) -> Tuple[int, bool]:
    """(the cache slot of position ``pos``, whether the cache is a ring):
    a ring when the cache is exactly the sliding window, else linear slots,
    a position past the last one refused."""
    ring = cfg.window is not None and S == cfg.window
    if not ring and pos >= S:
        raise ValueError(f"decode position {pos} is past the cache's {S} slots")
    return (pos % S if ring else pos), ring


def _cached_attn(cfg: ArchConfig, p: Params, h: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, q_pos: torch.Tensor, pos: int,
                 window: Optional[int], kv_block: int = 2048) -> torch.Tensor:
    """Project one token, write its K/V into the layer's cache (in place),
    attend over the cache."""
    B = h.shape[0]
    q, k, v = C.gqa_project(p, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd, q_pos,
                            cfg.rope_theta, _rot_dim(cfg))
    S = ck.shape[1]
    slot, ring = _slot(cfg, S, pos)
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


def _cached_mla(cfg: ArchConfig, p: Params, h: torch.Tensor, ckv: torch.Tensor,
                kr: torch.Tensor, q_pos: torch.Tensor, pos: int) -> torch.Tensor:
    """Project one token, write its latent into the layer's cache (in
    place), attend over the cache by the absorbed path."""
    q, new_ckv, new_kr = C.mla_project(p, h, cfg.n_heads, cfg.mla, q_pos, cfg.rope_theta)
    S = ckv.shape[1]
    slot, _ = _slot(cfg, S, pos)
    ckv[:, slot] = new_ckv[:, 0].to(ckv.dtype)
    kr[:, slot] = new_kr[:, 0].to(kr.dtype)
    return C.mla_attend(p, q, ckv, kr, q_pos, torch.arange(S, device=h.device),
                        cfg.n_heads, cfg.mla, kv_block=2048)


def _decode_step_dense(params: Params, cfg: ArchConfig, cache: Params,
                       h: torch.Tensor, q_pos: torch.Tensor, pos: int) -> torch.Tensor:
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        x = _norm(cfg, p["ln_attn"], h)
        if cfg.attn_kind == "mla":
            a = _cached_mla(cfg, p["attn"], x, cache["ckv"][i], cache["kr"][i], q_pos, pos)
        else:
            a = _cached_attn(cfg, p["attn"], x, cache["k"][i], cache["v"][i], q_pos,
                             pos, _layer_window(cfg, i))
        if cfg.post_norms:
            a = _norm(cfg, p["ln_attn_post"], a)
        h = h + a
        m, _ = _ffn(cfg, p, _norm(cfg, p["ln_mlp"], h))
        if cfg.post_norms:
            m = _norm(cfg, p["ln_mlp_post"], m)
        h = h + m
    return h


def _ssm_step(cfg: ArchConfig, p: Params, h: torch.Tensor, st: torch.Tensor,
              cs: torch.Tensor) -> torch.Tensor:
    """One SSM block's decode step, its states written back in place."""
    y, new_st, new_cs = S.ssm_decode_step(p["ssm"], _norm(cfg, p["ln"], h), cfg.ssm,
                                          cfg.d_model, st, cs)
    st.copy_(new_st)
    cs.copy_(new_cs)
    return h + y


def _decode_step_ssm(params: Params, cfg: ArchConfig, cache: Params,
                     h: torch.Tensor) -> torch.Tensor:
    for i in range(cfg.n_layers):
        h = _ssm_step(cfg, _layer(params["layers"], i), h, cache["ssm"][i],
                      cache["conv"][i])
    return h


def _decode_step_hybrid(params: Params, cfg: ArchConfig, cache: Params,
                        h: torch.Tensor, q_pos: torch.Tensor, pos: int) -> torch.Tensor:
    shared = params["shared"]
    per = cfg.hybrid_attn_every
    for g in range(cfg.n_layers // per):
        for j in range(per):
            h = _ssm_step(cfg, _layer(params["layers"], g, j), h, cache["ssm"][g, j],
                          cache["conv"][g, j])
        h = h + _cached_attn(cfg, shared["attn"], _norm(cfg, shared["ln_attn"], h),
                             cache["k"][g], cache["v"][g], q_pos, pos, cfg.window)
        h = h + C.mlp(shared["mlp"], _norm(cfg, shared["ln_mlp"], h), cfg.act)
    return h


def _decode_step_encdec(params: Params, cfg: ArchConfig, cache: Params,
                        h: torch.Tensor, q_pos: torch.Tensor, pos: int) -> torch.Tensor:
    enc_pos = torch.arange(cache["ck"].shape[2], device=h.device)
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = h + _cached_attn(cfg, p["self_attn"], _norm(cfg, p["ln_self"], h),
                             cache["k"][i], cache["v"][i], q_pos, pos, None)
        h = h + _cross_attn(cfg, p["cross_attn"], _norm(cfg, p["ln_cross"], h), q_pos,
                            cache["ck"][i], cache["cv"][i], enc_pos, kv_block=2048)
        h = h + C.mlp(p["mlp"], _norm(cfg, p["ln_mlp"], h), cfg.act)
    return h
