"""Gemma2-27B — alternating local(4096)/global attention, logit softcaps
(attn 50, final 30), gemma-style (1+scale) RMSNorm with post-norms,
head_dim 128 (attention width 4096 != d_model 4608). [arXiv:2408.00118; hf].
Global layers are full attention: long_500k skipped."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2_27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256000, head_dim=128, act="gelu", norm="rmsnorm1p",
    layer_pattern="alt_local_global", window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    source="arXiv:2408.00118 / hf:google/gemma-2-27b",
))
