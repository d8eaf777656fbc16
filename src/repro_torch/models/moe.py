"""Mixture-of-Experts layer in torch (Mixtral 8x7b top-2, Qwen3-MoE 128x
top-8): the port of ``repro.models.moe``.

Capacity-based top-k routing, per sequence row: each batch row gives every
expert ``capacity(cfg, S)`` slots, filled in the order of the row's
flattened (token, k) pairs; a pair past its expert's capacity is dropped and
passes through the residual only. Experts run as one batched product over
the expert axis on (B, E, C, D) buffers. Two dispatches build the buffers,
as in the reference: ``_moe_sort`` (the default: positions from a stable
argsort of the expert ids, buffers gathered) and ``_moe_scatter`` (the
baseline: positions from a one-hot cumsum, buffers scatter-added). Both
drop the same pairs. A Switch-style auxiliary load-balance loss is returned
beside the output.

The reference's ``_buf_cst`` (an expert-parallel sharding constraint) has
no meaning on one device and is dropped. A decode step (S = 1) gets one
slot an expert and so never drops, but runs every expert's buffer, as the
reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.components import dense_init, normal, promoted


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    dispatch: str = "sort"    # "sort" (optimized) | "scatter" (baseline)


def moe_init(gen: torch.Generator, d: int, cfg: MoEConfig, dtype=torch.bfloat16) -> Dict:
    s = 1.0 / math.sqrt(d)
    E, f = cfg.n_experts, cfg.d_ff
    return {
        "router": dense_init(gen, d, E, torch.float32),
        "w_gate": normal(gen, (E, d, f), s, dtype),
        "w_up": normal(gen, (E, d, f), s, dtype),
        "w_down": normal(gen, (E, f, d), 1.0 / math.sqrt(f), dtype),
    }


def capacity(cfg: MoEConfig, S: int) -> int:
    """Slots an expert gets in one batch row of ``S`` tokens."""
    return max(1, int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts))


def _route(params: Dict, x: torch.Tensor, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 router -> (gate_idx (B, S, K), gate_vals (B, S, K) renormalised
    over the k chosen, aux loss). The top k by a stable descending sort:
    ``jax.lax.top_k``'s order, the lower expert first on a tie."""
    E, K = cfg.n_experts, cfg.top_k
    B, S, _ = x.shape
    logits = x.float() @ params["router"]["w"].float()              # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :K], gate_idx[..., :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e f_e * p_e, f_e from per-row counts
    me = torch.mean(probs, dim=(0, 1))
    counts = torch.zeros((B, E), dtype=torch.float32, device=x.device).scatter_add_(
        1, gate_idx.reshape(B, S * K), torch.ones((B, S * K), device=x.device))
    fe = torch.mean(counts, dim=0) / S
    aux = cfg.aux_coef * E * torch.sum(me * fe)
    return gate_idx, gate_vals, aux


def _experts(params: Dict, buf: torch.Tensor) -> torch.Tensor:
    """The gated SiLU FFN of every expert over its (B, E, C, D) buffer."""
    buf, wg, wu, wd = promoted(buf, params["w_gate"], params["w_up"], params["w_down"])
    h = torch.einsum("becd,edf->becf", buf, wg)
    u = torch.einsum("becd,edf->becf", buf, wu)
    return torch.einsum("becf,efd->becd", F.silu(h) * u, wd)


def moe_apply(params: Dict, x: torch.Tensor, cfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss), by ``cfg.dispatch``."""
    if cfg.dispatch == "sort":
        return _moe_sort(params, x, cfg)
    return _moe_scatter(params, x, cfg)


def sort_positions(flat_e: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flat_e (B, N): each row's expert ids in (token, k) order ->
    (order: the stable argsort, pos_sorted: each sorted pair's place in its
    expert's run, pos_tok: each pair's place, in the original order). A
    pair is dropped where its place reaches the capacity."""
    B, N = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    ar = torch.arange(N, device=flat_e.device)[None].expand(B, N)
    is_start = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=flat_e.device),
                          sorted_e[:, 1:] != sorted_e[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(is_start, ar, -1), dim=1).values
    pos_sorted = ar - run_start
    pos_tok = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    return order, pos_sorted, pos_tok


def _moe_sort(params: Dict, x: torch.Tensor, cfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort dispatch: each (expert, slot) of the buffer reads its token by
    a gather; each (token, k) reads its slot back."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    gate_idx, gate_vals, aux = _route(params, x, cfg)
    flat_e = gate_idx.reshape(B, S * K)
    order, pos_sorted, pos_tok = sort_positions(flat_e)
    # the (token * K + k) id feeding each buffer slot; pairs past capacity
    # go to one extra slot E * C, cut off after (the reference's mode="drop")
    sorted_e = torch.gather(flat_e, 1, order)
    slot = torch.where(pos_sorted < C, sorted_e * C + pos_sorted, E * C)
    slot_token = torch.zeros((B, E * C + 1), dtype=torch.long, device=x.device
                             ).scatter_(1, slot, order)[:, :E * C]
    slot_filled = torch.zeros((B, E * C + 1), dtype=torch.bool, device=x.device
                              ).scatter_(1, slot, True)[:, :E * C]
    src_tok = slot_token // K                                          # (B, E*C)
    buf = torch.gather(x, 1, src_tok[..., None].expand(B, E * C, D))
    buf = buf.masked_fill_(~slot_filled[..., None], 0).reshape(B, E, C, D)
    y = _experts(params, buf)                                          # (B, E, C, D)
    keep = (pos_tok < C).reshape(B, S, K).to(x.dtype) * gate_vals.to(x.dtype)
    bidx = torch.arange(B, device=x.device)[:, None]
    out = y[bidx, flat_e, torch.clamp(pos_tok, max=C - 1)]             # (B, N, D)
    out = out.reshape(B, S, K, D) * keep[..., None]
    return out.sum(2), aux


def _moe_scatter(params: Dict, x: torch.Tensor, cfg: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter dispatch: positions from a dense (B, S*K, E) one-hot cumsum,
    the buffers built by a scatter-add of every (token, k) copy (dropped
    copies zeroed onto the last slot)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    gate_idx, gate_vals, aux = _route(params, x, cfg)
    flat_hot = F.one_hot(gate_idx, E).float().reshape(B, S * K, E)
    pos = torch.cumsum(flat_hot, dim=1) - flat_hot
    pos = torch.sum(pos * flat_hot, dim=-1).reshape(B, S, K)
    keep = (pos < C).to(x.dtype) * gate_vals.to(x.dtype)
    pos = torch.clamp(pos, max=C - 1).long()
    bidx = torch.arange(B, device=x.device)[:, None, None]
    mask = (keep > 0).to(x.dtype)[..., None]
    xk = x[:, :, None, :].expand(B, S, K, D) * mask
    buf = torch.zeros((B, E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx.expand(B, S, K), gate_idx, pos), xk, accumulate=True)
    y = _experts(params, buf)
    out = y[bidx, gate_idx, pos] * keep[..., None]
    return out.sum(2), aux
