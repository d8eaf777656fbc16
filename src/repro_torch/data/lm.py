"""Synthetic LM data: the port of ``repro.data.lm``.

Batch ``index`` on host ``host`` is a pure function of ``(seed, index,
host)``: the same numpy stream as the reference (``SeedSequence([seed,
index, host])``), so a restarted job regenerates exactly the batches it
needs, and both packages see the same data. Sequences follow ``next = (a *
prev + 7) % V`` with 15% random jumps, so the loss can fall with no corpus.
Tokens and labels are int32 tensors (the reference's values and dtype);
prefix and encoder embeddings float32; all on ``device``.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def make_batch(cfg: ArchConfig, batch: int, seq: int, index: int,
               seed: int = 0, host: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, index, host]))
    V = cfg.vocab
    a = 31 if V > 31 else 3
    x = np.zeros((batch, seq + 1), np.int64)
    x[:, 0] = rng.integers(0, V, batch)
    noise = rng.random((batch, seq)) < 0.15
    jumps = rng.integers(0, V, (batch, seq))
    for t in range(seq):
        nxt = (a * x[:, t] + 7) % V
        x[:, t + 1] = np.where(noise[:, t], jumps[:, t], nxt)
    put = lambda arr, dt: torch.from_numpy(np.ascontiguousarray(arr, dt)).to(device)
    out = {"tokens": put(x[:, :-1], np.int32), "labels": put(x[:, 1:], np.int32)}
    if cfg.prefix_tokens:
        out["prefix_embeds"] = put(
            rng.standard_normal((batch, min(cfg.prefix_tokens, 8), cfg.d_model)) * 0.02,
            np.float32)
    if cfg.kind == "encdec":
        out["enc_embeds"] = put(rng.standard_normal((batch, seq, cfg.d_model)) * 0.02,
                                np.float32)
    return out


def synthetic_batches(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                      host: int = 0, device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    i = 0
    while True:
        yield make_batch(cfg, batch, seq, i, seed=seed, host=host, device=device)
        i += 1
