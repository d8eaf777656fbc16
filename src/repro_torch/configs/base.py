"""Architecture configuration schema + registry: the port of
``repro.configs.base``.

One module per assigned architecture lives in ``repro_torch.configs.<id>``
and exposes ``CONFIG``; they register themselves here. ``ArchConfig.
reduced()`` returns a tiny same-family config for CPU tests. The fields are
the reference's, one for one; ``param_dtype`` is a ``torch.dtype``
(``torch.bfloat16``, and ``torch.float32`` in ``reduced()``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional

import torch

from repro_torch.models.components import MLADims
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "silu"
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # fraction of head_dim rotated (chatglm3: 0.5)
    qkv_bias: bool = False
    attn_kind: str = "gqa"           # gqa | mla | none
    mla: Optional[MLADims] = None
    window: Optional[int] = None     # sliding-window size (mixtral / gemma2 local)
    layer_pattern: str = "global"    # "global" | "alt_local_global"
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_norms: bool = False         # gemma2 post-attn/post-mlp norms
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: Optional[int] = None   # zamba2 shared block period
    kind: str = "decoder"            # decoder | encdec
    n_enc_layers: int = 0
    prefix_tokens: int = 0           # vlm/audio stub frontend tokens
    tie_embeddings: bool = True
    norm: str = "rmsnorm"            # rmsnorm | rmsnorm1p (gemma) | layernorm
    pos: str = "rope"                # rope | learned | none
    max_position: int = 524288       # learned-pos table size
    norm_eps: float = 1e-6
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    loss_chunks: int = 8
    supports_long_decode: bool = False
    source: str = ""                 # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // max(self.n_heads, 1)

    def n_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attn_kind == "gqa":
            per_layer += d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd \
                         + self.n_heads * self.hd * d
        elif self.attn_kind == "mla":
            m = self.mla
            qk = m.qk_nope + m.qk_rope
            per_layer += d * m.q_lora + m.q_lora * self.n_heads * qk \
                         + d * m.kv_lora + d * m.qk_rope \
                         + m.kv_lora * self.n_heads * (m.qk_nope + m.v_head) \
                         + self.n_heads * m.v_head * d
        if self.moe is not None:
            per_layer += d * self.moe.n_experts * self.moe.d_ff * 3 + d * self.moe.n_experts
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff
        if self.ssm is not None:
            din = self.ssm.d_inner(d)
            gn = self.ssm.n_groups * self.ssm.d_state
            H = self.ssm.n_heads(d)
            ssm_l = d * (2 * din + 2 * gn + H) + din * d + self.ssm.d_conv * (din + 2 * gn)
            if self.hybrid_attn_every:
                n_ssm = L
                shared = d * self.n_heads * self.hd * 2 + 2 * d * self.n_kv_heads * self.hd \
                         + 3 * d * self.d_ff
                return emb + n_ssm * ssm_l + shared
            return emb + L * ssm_l
        total = emb + L * per_layer
        if self.kind == "encdec":
            # encoder layers + decoder cross-attention
            enc = self.n_enc_layers * (4 * d * d + 2 * d * self.d_ff)
            cross = L * 4 * d * d
            total += enc + cross
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = L * (d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd
                    + self.n_heads * self.hd * d)
        moe = L * (d * self.moe.top_k * self.moe.d_ff * 3 + d * self.moe.n_experts)
        return emb + attn + moe

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke", n_layers=min(self.n_layers, 4) if not self.hybrid_attn_every else 4,
            d_model=64, n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_ff=128 if self.d_ff else 0, vocab=256, head_dim=16,
            loss_chunks=2, remat=False, param_dtype=torch.float32,
        )
        if self.moe is not None:
            # dropless at smoke scale so incremental decode matches the
            # batched forward exactly (capacity drops are batch-dependent)
            kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_ff=32,
                                  capacity_factor=8.0)
            kw["d_ff"] = 0
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, headdim=16, expand=2, chunk=8,
                                  n_groups=1, d_conv=self.ssm.d_conv)
            kw["d_ff"] = self.d_ff and 128
        if self.mla is not None:
            kw["mla"] = MLADims(q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16)
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 2
        if self.kind == "encdec":
            kw["n_enc_layers"] = 2
        if self.window is not None:
            kw["window"] = 16
        return dataclasses.replace(self, **kw)


ASSIGNED_ARCHS = (
    "internvl2_1b", "zamba2_2_7b", "whisper_medium", "minicpm3_4b",
    "llama3_405b", "gemma2_27b", "chatglm3_6b", "qwen3_moe_30b_a3b",
    "mixtral_8x7b", "mamba2_2_7b",
)

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{key}")
    return _REGISTRY[key]


def all_assigned() -> List[ArchConfig]:
    return [get(n) for n in ASSIGNED_ARCHS]
