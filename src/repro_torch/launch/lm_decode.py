"""LM decode: prefill a prompt, then greedy single-token steps from the
cache. The port of ``repro.launch.lm_decode``, for every assigned
architecture.

    python -m repro_torch.launch.lm_decode --arch mixtral_8x7b --tokens 16
    python -m repro_torch.launch.lm_decode --device cpu      # no card

``main`` runs the architecture's reduced config, as the reference's does;
``run`` takes any config (``chip_smoke.py`` runs the registered configs on
the card). An encoder-decoder config attends over zero frame embeddings as
long as the prompt, as the reference's demo does. One divergence: with a
stub prefix (internvl2), the cache is grown past the prefill's whole length
(prefix + prompt) and decode steps sit at the positions after it; the
reference grows only a cache exactly the prompt long and steps from the
prompt's length, which lands its first steps on the prompt's own slots.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import base as cb
from repro_torch.models import transformer as T

PREFIX_LEN = 8                        # stub prefix embeddings (vlm configs)


@dataclasses.dataclass
class DecodeRun:
    tokens: torch.Tensor              # (B, N): the prefill's argmax, then N - 1 steps
    prefill_ms: float                 # host clock, device synchronised
    decode_ms: float
    decode_tok_s: float               # B * (N - 1) / decode seconds


GROWN = ("k", "v", "ckv", "kr")       # the cache leaves decode appends to


def grow_cache(cache: T.Params, extra: int) -> T.Params:
    """The prefill's cache with ``extra`` zero slots appended to the
    self-attention leaves (``GROWN``) along their sequence axis (axis 2);
    SSM states and the cross-attention's keys and values are kept as
    they are."""
    return {k: (torch.cat([a, a.new_zeros((*a.shape[:2], extra, *a.shape[3:]))], dim=2)
                if k in GROWN else a)
            for k, a in cache.items()}


def run(cfg: cb.ArchConfig, batch: int, prompt_len: int, tokens: int, *,
        device="cuda", seed: int = 0, params: Optional[T.Params] = None) -> DecodeRun:
    """Prefill the prompt ``(arange * 11 + 1) % vocab`` of ``batch`` rows
    (after a zero prefix for a config with prefix tokens; over zero frame
    embeddings as long as the prompt for an encoder-decoder), grow the
    cache by ``tokens``, decode ``tokens - 1`` greedy steps. ``params``
    default to ``init_params`` from a ``seed``-ed generator on ``device``."""
    device = torch.device(device)
    if params is None:
        params = T.init_params(torch.Generator(device=device).manual_seed(seed), cfg)
    B, P, N = batch, prompt_len, tokens
    prompt = (torch.arange(B * P, device=device).reshape(B, P) * 11 + 1) % cfg.vocab
    prefix = (torch.zeros((B, PREFIX_LEN, cfg.d_model), device=device)
              if cfg.prefix_tokens else None)
    enc = (torch.zeros((B, P, cfg.d_model), device=device)
           if cfg.kind == "encdec" else None)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    logits, cache = T.prefill(params, cfg, prompt, prefix_embeds=prefix,
                              enc_embeds=enc)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    S = P + (PREFIX_LEN if prefix is not None else 0)
    cache = grow_cache(cache, N)
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(N - 1):
        logits, cache = T.decode_step(params, cfg, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    sync()
    dt = time.perf_counter() - t0
    return DecodeRun(torch.cat(out, dim=1), prefill_ms, dt * 1e3, B * (N - 1) / dt)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3_6b", choices=cb.ASSIGNED_ARCHS)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cb.get(args.arch).reduced()
    B, P, N = args.batch, args.prompt_len, args.tokens
    r = run(cfg, B, P, N, device=args.device)
    print(f"[serve] prefill {P} tokens: {r.prefill_ms:.0f} ms")
    print(f"[serve] decoded {N - 1} x {B} tokens in {r.decode_ms:.0f} ms "
          f"({r.decode_tok_s:.1f} tok/s)")
    print(f"[serve] sample: {r.tokens[0, :12].tolist()}")


if __name__ == "__main__":
    main()
