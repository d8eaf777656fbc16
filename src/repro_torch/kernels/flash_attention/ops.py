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

As in the reference, the TPU block is first clamped to the sequence
(``bq = min(bq, Sq)``, ``bkv = min(bkv, Sk)``) and must then divide it; the
CTA tile needs no such fit, since the kernel masks ragged edges.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention

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


def flash_attention_op(q, k, v, causal: bool = True,
                       variant: str = "fa-128x128") -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), GQA layout, fp32 or bf16
    -> (B, Sq, H, hd) in q's dtype. KV heads are repeated to the full H and
    the heads folded into the batch dim for the kernel, under ``variant``'s
    CTA tile at this head dim."""
    B, Sq, Hq, d = q.shape
    Hkv = k.shape[2]
    if Hq != Hkv:
        if Hq % Hkv:
            raise ValueError(f"flash_attention_op: {Hq} query heads over {Hkv} KV heads")
        rep = Hq // Hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qf = q.transpose(1, 2).reshape(B * Hq, Sq, d).contiguous()
    kf = k.transpose(1, 2).reshape(B * Hq, -1, d).contiguous()
    vf = v.transpose(1, 2).reshape(B * Hq, -1, d).contiguous()
    Sk = kf.shape[1]
    bq, bkv = VARIANTS[variant]
    bq, bkv = min(bq, Sq), min(bkv, Sk)
    if Sq % bq or Sk % bkv:
        raise ValueError(f"flash_attention_op: pad sequence to block multiples "
                         f"(Sq {Sq}, Sk {Sk}, {variant} blocks {bq}x{bkv})")
    cq, ckv = cta_tile(variant, d, q.dtype)
    out = flash_attention(qf, kf, vf, causal=causal, bq=cq, bkv=ckv)
    return out.reshape(B, Hq, Sq, d).transpose(1, 2)
