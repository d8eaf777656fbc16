"""Whisper-medium — encoder-decoder; conv frame frontend stubbed
(input_specs() provides precomputed frame embeddings). [arXiv:2212.04356].
LayerNorm + learned positions per the original; full attention, so the
long_500k shape is skipped (DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper_medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64, kind="encdec", n_enc_layers=24,
    act="gelu", norm="layernorm", pos="learned", rope_theta=0.0,
    tie_embeddings=True, max_position=65536,
    source="arXiv:2212.04356 (openai/whisper-medium)",
))
