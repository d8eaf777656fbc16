"""Mixtral-8x7B — 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]. SWA bounds the decode KV working set, so the long_500k
cell RUNS for this arch (DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.moe import MoEConfig

CONFIG = register(ArchConfig(
    name="mixtral_8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=0,
    vocab=32000, head_dim=128, rope_theta=1e6, window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336),
    supports_long_decode=True,
    source="arXiv:2401.04088",
))
