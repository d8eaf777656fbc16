"""Block-config variants for the flash attention kernel, the GQA entry point
``flash_attention_op``, and the map from each TPU block variant onto a
legal Hopper CTA tile.

``VARIANTS`` keeps the reference's keys and TPU (bq, bkv) blocks. The TPU
blocks are sized for many megabytes of VMEM: fp32 ``fa-128x128`` at d = 128
needs 64 KB each for Q, K and V plus 64 KB for the score tile, over the
227 KB of shared memory an H100 block may take, and ``fa-512x256`` is far
past it. ``CTA_TILES`` maps each key with one rule — halve each block, cap
at 128 — onto a (BQ, BKV) tile of ``csrc/flash_attention.cu`` (256
threads). Its dynamic shared memory is (BQ (d+1) + max(d (BKV+1), BKV d) +
BQ (BKV+1)) * 4 bytes, given here at the largest head dim, d = 128:

    variant      TPU (bq, bkv)   Hopper CTA (BQ, BKV)   shared memory, d=128
    fa-128x128   (128, 128)      ( 64,  64)              82,944 B
    fa-128x256   (128, 256)      ( 64, 128)             132,096 B
    fa-256x128   (256, 128)      (128,  64)             132,608 B
    fa-256x256   (256, 256)      (128, 128)             198,144 B
    fa-512x256   (512, 256)      (128, 128)  capped     198,144 B

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

# (BQ, BKV) Hopper CTA tile per variant — the table in the docstring
CTA_TILES: Dict[str, Tuple[int, int]] = {
    "fa-128x128": (64, 64),
    "fa-128x256": (64, 128),
    "fa-256x128": (128, 64),
    "fa-256x256": (128, 128),
    "fa-512x256": (128, 128),
}


def flash_attention_op(q, k, v, causal: bool = True,
                       variant: str = "fa-128x128") -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), GQA layout -> (B, Sq, H, hd).
    KV heads are repeated to the full H and the heads folded into the batch
    dim for the kernel, under ``variant``'s CTA tile."""
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
    cq, ckv = CTA_TILES[variant]
    out = flash_attention(qf, kf, vf, causal=causal, bq=cq, bkv=ckv)
    return out.reshape(B, Hq, Sq, d).transpose(1, 2)
