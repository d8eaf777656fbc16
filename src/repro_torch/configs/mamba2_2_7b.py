"""Mamba2-2.7B — attention-free SSD (state-space duality).
[arXiv:2405.21060]. O(1)-state decode: long_500k RUNS."""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.ssm import SSMConfig

CONFIG = register(ArchConfig(
    name="mamba2_2_7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, attn_kind="none",
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk=256),
    supports_long_decode=True,
    source="arXiv:2405.21060",
))
