"""Block-config variants for the flash attention kernel, the GQA entry point
``flash_attention_op``, and the map from each TPU block variant onto a
legal Hopper CTA tile.

``VARIANTS`` keeps the reference's keys and TPU (bq, bkv) blocks. The TPU
blocks are sized for many megabytes of VMEM: fp32 ``fa-128x128`` at d = 128
needs 64 KB each for Q, K and V plus 64 KB for the score tile, over the
227 KB of shared memory an H100 block may take, and ``fa-512x256`` is far
past it. ``cta_tile(variant, d, dtype)`` maps each key, head dim and
operand dtype by one rule onto a (BQ, BKV) tile of
``csrc/flash_attention.cu`` (BQ / 16 warps):

- BQ is half the TPU query block, capped at 128;
- BKV, fp32: ``KV_STEP_ELEMS / d`` keys, capped at 64: the KV step holds
  at most 4,096 elements of K and of V. It is set by the head dim, not by
  the TPU KV block, because on the card the scores of a step live in
  registers beside the d-wide output accumulator. At d = 128, BKV = 64
  leaves too few registers (each fragment is split into two tf32 halves
  in registers) and runs 1.8x slower than BKV = 32.
- BKV, bf16: 64 keys at every head dim. The bf16 kernel reads its
  fragments as bf16 pairs by ``ldmatrix`` and splits nothing but P: BKV =
  64 at d = 128 ran 7-14% faster than 32 on every bf16 pass, though ptxas
  reports a few dozen bytes of spills (``chip_smoke.py`` times every tile
  at each attention path; PERF.md, section 6). 64 is a multiple of the
  bf16 mma's 16 keys.

Shared memory: fp32 (2 BQ + 2 BKV) (d + 4) * 4 bytes (Q's two tf32
halves, a K stage and a V stage, rows padded to d + 4 floats); bf16
(BQ + 2 BKV) (d + 8) * 2 bytes (Q once, as bf16, rows padded by 16
bytes). (* BQ capped at 128.)

    variant      TPU (bq, bkv)   d = 32, 64   d = 128           shared memory, d = 64 / 128
                                 both dtypes  fp32     bf16     fp32                bf16
    fa-128x128   (128, 128)      ( 64, 64)    ( 64, 32) ( 64, 64)   69,632 / 101,376   27,648 / 52,224 B
    fa-128x256   (128, 256)      ( 64, 64)    ( 64, 32) ( 64, 64)   69,632 / 101,376   27,648 / 52,224 B
    fa-256x128   (256, 128)      (128, 64)    (128, 32) (128, 64)  104,448 / 168,960   36,864 / 69,632 B
    fa-256x256   (256, 256)      (128, 64)    (128, 32) (128, 64)  104,448 / 168,960   36,864 / 69,632 B
    fa-512x256   (512, 256)      (128, 64)*   (128, 32)*(128, 64)* 104,448 / 168,960   36,864 / 69,632 B

**The wgmma route** (bf16 q, k, v at d = 64 or 128 with aligned bases;
``flash_attention.route``) runs ``csrc/flash_wgmma.cu``, whose tiles are
(BQ, BKV) per head dim (``WGMMA_TILES``). ``wgmma_tile(variant, d)`` maps
each key by one rule: BQ half the TPU query block, capped at 128 (one or
two consumer warpgroups of 64 rows); BKV half the TPU KV block, capped at
128 at d = 64 and at 64 at d = 128 (a consumer holds S, P's two parts and O
in registers). Shared memory: 1,024 bytes of alignment, Q (BQ d 2 bytes), a
ring of K and V stages (2 BKV d 2 bytes each: as many as fit, at most 4,
in half a block's 227 KB for BQ = 64, which runs two CTAs to an SM) and
3 stages + 3 barriers of 8 bytes:

    variant      d = 64 (BQ, BKV) stages   d = 128 (BQ, BKV) stages   shared memory d = 64 / 128
    fa-128x128   ( 64,  64) x 4            ( 64, 64) x 2               74,872 /  83,016 B
    fa-128x256   ( 64, 128) x 3            ( 64, 64) x 2              107,616 /  83,016 B
    fa-256x128   (128,  64) x 4            (128, 64) x 4               83,064 / 164,984 B
    fa-256x256   (128, 128) x 4            (128, 64) x 4              148,600 / 164,984 B
    fa-512x256   (128, 128) x 4            (128, 64) x 4              148,600 / 164,984 B

``plan(q, k, v, variant)`` gives a call's route and tile, as
``flash_attention`` takes them.

As in the reference, the TPU block is first clamped to the sequence
(``bq = min(bq, Sq)``, ``bkv = min(bkv, Sk)``) and must then divide it; the
CTA tile needs no such fit, since the kernel masks ragged edges.
**GQA:** K and V keep their Hkv heads; the kernel reads KV head ``h //
(H / Hkv)`` in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_attention.flash_attention import (WGMMA_TILES,
                                                                 flash_attention,
                                                                 route)

# (bq, bkv) TPU blocks, as in the reference
VARIANTS: Dict[str, Tuple[int, int]] = {
    "fa-128x128": (128, 128),
    "fa-128x256": (128, 256),
    "fa-256x128": (256, 128),
    "fa-256x256": (256, 256),
    "fa-512x256": (512, 256),
}

KV_STEP_ELEMS = 4096        # fp32: K elements of one KV step, BKV * d, at most
BKV_BF16 = 64               # bf16: keys of one KV step at every head dim


def cta_tile(variant: str, d: int,
             dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(BQ, BKV) Hopper CTA tile of ``variant`` at head dim ``d`` for q, k,
    v of ``dtype``: the rule in the docstring."""
    bq, _ = VARIANTS[variant]
    bkv = BKV_BF16 if dtype == torch.bfloat16 else min(64, KV_STEP_ELEMS // d)
    return min(bq // 2, 128), bkv


def wgmma_tile(variant: str, d: int) -> Tuple[int, int]:
    """(BQ, BKV) wgmma tile of ``variant`` at head dim ``d``: the rule in
    the docstring."""
    bq, bkv = VARIANTS[variant]
    return min(bq // 2, 128), min(bkv // 2, 128 if d == 64 else 64)


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         variant: str) -> dict:
    """The launch arguments of a folded call on ``q``, ``k``, ``v`` under
    ``variant``: its route and that route's tile, as ``flash_attention``
    takes them."""
    d = q.shape[-1]
    if route(q, k, v) == "wgmma":
        bq, bkv = wgmma_tile(variant, d)
        assert (bq, bkv, d) in WGMMA_TILES
        return dict(bq=bq, bkv=bkv, force_route="wgmma")
    bq, bkv = cta_tile(variant, d, q.dtype)
    return dict(bq=bq, bkv=bkv, force_route="mma.sync")


def fold_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, heads, d) -> (B * heads, S, d) contiguous, heads folded into
    the batch dim as ``b * heads + h``."""
    B, S, H, d = t.shape
    return t.transpose(1, 2).reshape(B * H, S, d).contiguous()


def flash_attention_op(q, k, v, causal: bool = True,
                       variant: str = "fa-128x128") -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), GQA layout, fp32 or bf16
    -> (B, Sq, H, hd) in q's dtype. The heads are folded into the batch dim
    for the kernel, K and V with their Hkv heads (query head h reads KV
    head h // (H / Hkv) in place), under ``variant``'s tile for this call's
    route and head dim."""
    B, Sq, Hq, d = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_attention_op: {Hq} query heads over {Hkv} KV heads")
    qf, kf, vf = fold_heads(q), fold_heads(k), fold_heads(v)
    Sk = kf.shape[1]
    bq, bkv = VARIANTS[variant]
    bq, bkv = min(bq, Sq), min(bkv, Sk)
    if Sq % bq or Sk % bkv:
        raise ValueError(f"flash_attention_op: pad sequence to block multiples "
                         f"(Sq {Sq}, Sk {Sk}, {variant} blocks {bq}x{bkv})")
    out = flash_attention(qf, kf, vf, causal=causal, rep=Hq // Hkv,
                          **plan(qf, kf, vf, variant))
    return out.reshape(B, Hq, Sq, d).transpose(1, 2)
