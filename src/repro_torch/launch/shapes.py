"""The assigned input-shape cells: the pure part of ``repro.launch.shapes``.

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (serve)
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 token, KV=seq)
  long_500k    seq 524,288 global_batch 1     -> serve_step; SSM/hybrid/SWA only

``input_specs`` gives each cell's model inputs as ``meta`` tensors: the
reference's ``ShapeDtypeStruct`` stand-ins, shapes and dtypes without an
allocation (``launch/dryrun.py`` sums their bytes for one card). Modality
frontends are stubs: internvl2 gets 256 precomputed patch embeddings,
whisper frame embeddings of the full sequence length.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str                  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k only for sub-quadratic-decode archs."""
    if shape == "long_500k":
        return cfg.supports_long_decode
    return True


def input_specs(cfg: ArchConfig, shape: str, dtype=torch.bfloat16,
                device="meta") -> Dict:
    """Stand-ins for one (arch x shape) cell's inputs, ``meta`` tensors by
    default (nothing allocated).

    train/prefill: {'tokens', 'labels'?, 'prefix_embeds'?, 'enc_embeds'?}
    decode:        {'tokens' (B,1), 'pos' (), 'cache': ``init_cache``'s tree}
    """
    cell = SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    if not cell_applicable(cfg, shape):
        raise ValueError(f"{cfg.name} does not run {shape} (full attention)")
    spec = lambda *s, dt: torch.empty(s, dtype=dt, device=device)

    if cell.step in ("train", "prefill"):
        s_text = S - (cfg.prefix_tokens if cfg.prefix_tokens else 0)
        specs: Dict = {"tokens": spec(B, s_text, dt=torch.int32)}
        if cell.step == "train":
            specs["labels"] = spec(B, s_text, dt=torch.int32)
        if cfg.prefix_tokens:
            specs["prefix_embeds"] = spec(B, cfg.prefix_tokens, cfg.d_model, dt=dtype)
        if cfg.kind == "encdec":
            specs["enc_embeds"] = spec(B, S, cfg.d_model, dt=dtype)
        return specs

    # decode: one new token against a cache of S (decode_32k's cache runs to
    # terabytes across the global batch; on ``meta`` it is never allocated)
    cache = T.init_cache(cfg, B, S, enc_len=S if cfg.kind == "encdec" else 0,
                         dtype=dtype, device=device)
    return {"tokens": spec(B, 1, dt=torch.int32), "pos": spec(dt=torch.int32),
            "cache": cache}
