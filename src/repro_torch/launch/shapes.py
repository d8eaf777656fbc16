"""The assigned input-shape cells: the pure part of ``repro.launch.shapes``.

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (serve)
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 token, KV=seq)
  long_500k    seq 524,288 global_batch 1     -> serve_step; SSM/hybrid/SWA only

The reference's ``input_specs`` (shape stand-ins for a mesh dry run) is not
ported: it belongs with the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig


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
