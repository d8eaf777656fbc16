"""MiniCPM3-4B — dense with Multi-head Latent Attention.
[hf:openbmb/MiniCPM3-4B]. MLA dims from the reference config:
q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head 64; decode caches
the compressed latent (288 floats/token)."""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.components import MLADims

CONFIG = register(ArchConfig(
    name="minicpm3_4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448, attn_kind="mla",
    mla=MLADims(q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64),
    source="hf:openbmb/MiniCPM3-4B",
))
