"""InternVL2-1B — InternViT frontend (stubbed) + Qwen2-0.5B LM backbone.
[arXiv:2404.16821; hf]. Frontend supplies 256 patch embeddings via
input_specs(); the backbone is the assigned 24L/896/14H(kv2)/4864/151655."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2_1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151655, head_dim=64, qkv_bias=True, rope_theta=1e6,
    prefix_tokens=256, tie_embeddings=True,
    source="arXiv:2404.16821 / hf:OpenGVLab/InternVL2-1B (Qwen2-0.5B backbone)",
))
