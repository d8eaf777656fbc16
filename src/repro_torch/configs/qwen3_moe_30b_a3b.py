"""Qwen3-30B-A3B — MoE, 128 experts top-8, per-expert ffn 768, GQA kv=4,
head_dim 128. [hf:Qwen/Qwen3-30B-A3B]. Expert axis shards over 'model'
(expert parallelism); q/k-norm omitted (noted in DESIGN.md §10)."""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.moe import MoEConfig

CONFIG = register(ArchConfig(
    name="qwen3_moe_30b_a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=0,
    vocab=151936, head_dim=128, rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
    source="hf:Qwen/Qwen3-30B-A3B",
))
