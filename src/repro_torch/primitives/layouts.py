"""Data layouts and data-layout transformations (DLTs), paper §3.2.2 — the
port of ``repro.primitives.layouts`` on torch tensors.

Three single-image layouts for a (c, im, im) activation: ``chw``, ``hcw``
and ``hwc``. Every transform acts on the *last three* axes, so a batched
(n, c, im, im) tensor goes through the same API; the plan compiler relies on
this to lower whole-batch DLTs and on ``perm``/``compose`` to fuse DLT
chains into one permutation. Permutations return views (``Tensor.permute``);
consumers that need contiguous memory copy explicitly.
"""
from __future__ import annotations

import itertools
from typing import List, Tuple

import torch

LAYOUTS = ("chw", "hcw", "hwc")

# channel / spatial axis positions within the trailing three (image) axes
C_AXIS = {"chw": 0, "hcw": 1, "hwc": 2}
SPATIAL_AXES = {"chw": (1, 2), "hcw": (0, 2), "hwc": (0, 1)}

# permutation that maps a chw tensor to the given layout
_FROM_CHW = {
    "chw": (0, 1, 2),
    "hcw": (1, 0, 2),
    "hwc": (1, 2, 0),
}


def _invert(perm: Tuple[int, int, int]) -> Tuple[int, int, int]:
    inv = [0, 0, 0]
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def perm(src: str, dst: str) -> Tuple[int, int, int]:
    """Axis permutation (over the trailing image axes) realising src -> dst."""
    return compose(_invert(_FROM_CHW[src]), _FROM_CHW[dst])


def compose(p: Tuple[int, int, int], q: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Permutation applying ``p`` then ``q`` (both as transpose arguments)."""
    return tuple(p[a] for a in q)


def is_identity(p: Tuple[int, int, int]) -> bool:
    return tuple(p) == (0, 1, 2)


def apply_perm(x: torch.Tensor, p: Tuple[int, int, int]) -> torch.Tensor:
    """Permute the trailing image axes by ``p``, batch axes untouched."""
    if is_identity(p):
        return x
    lead = x.dim() - 3
    if lead < 0:
        raise ValueError(f"layout transforms need rank >= 3, got {tuple(x.shape)}")
    return x.permute(*range(lead), *(lead + a for a in p))


def from_chw(x: torch.Tensor, layout: str) -> torch.Tensor:
    return apply_perm(x, _FROM_CHW[layout])


def to_chw(x: torch.Tensor, layout: str) -> torch.Tensor:
    return apply_perm(x, _invert(_FROM_CHW[layout]))


def transform(x: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Apply the DLT src -> dst (trailing image axes; leading axes = batch)."""
    if src == dst:
        return x
    return apply_perm(x, perm(src, dst))


def dlt_pairs() -> List[Tuple[str, str]]:
    """All 9 ordered layout pairs, identity included (paper profiles all 9)."""
    return list(itertools.product(LAYOUTS, LAYOUTS))


def dlt_name(src: str, dst: str) -> str:
    return f"{src}->{dst}"
