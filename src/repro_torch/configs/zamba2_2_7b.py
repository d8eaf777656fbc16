"""Zamba2-2.7B — Mamba2 backbone with a shared attention(+MLP) block applied
every 6 SSM layers (weights shared across applications; per-invocation LoRA
omitted, DESIGN.md §10). [arXiv:2411.15242; hf]. Shared attention uses a
4096-token sliding window so the 500k-decode shape is serveable (§10)."""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.ssm import SSMConfig

CONFIG = register(ArchConfig(
    name="zamba2_2_7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, chunk=256),
    hybrid_attn_every=6, window=4096, supports_long_decode=True,
    source="arXiv:2411.15242 / hf:Zyphra/Zamba2-2.7B",
))
