"""ChatGLM3-6B — GQA kv=2, partial (half-dim '2d') RoPE, qkv bias.
[arXiv:2406.12793; hf:THUDM/chatglm3-6b]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3_6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, head_dim=128, rope_fraction=0.5, qkv_bias=True,
    tie_embeddings=False,
    source="arXiv:2406.12793 / hf:THUDM/chatglm3-6b",
))
