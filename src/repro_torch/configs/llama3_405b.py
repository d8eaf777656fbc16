"""Llama-3.1-405B — dense GQA, 128k vocab. [arXiv:2407.21783].
Full attention: long_500k skipped."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3_405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab=128256, head_dim=128, rope_theta=500000.0, tie_embeddings=False,
    source="arXiv:2407.21783",
))
