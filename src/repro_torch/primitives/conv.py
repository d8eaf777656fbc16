"""Convolution primitive families (paper §3.1, appendix Table 6) — the port
of ``repro.primitives.conv`` on torch tensors.

Every primitive computes the same valid, un-padded 2-D cross-correlation

    y[k, i, j] = sum_{c, a, b} x[c, i*s + a, j*s + b] * w[k, c, a, b]

but differs in *how*: data restructuring (im2col/im2row lowering, MEC partial
lowering, kn2 shift-accumulate, Winograd transform), GEMM orientation, the
traversal (``copy`` = slice-stacked lowering, ``scan`` = gather-indexed
lowering) and the input/output data layout (chw / hcw / hwc).

The registry metadata (names, families, layouts, traits, tile-column rules)
is a copy of the reference's, so both packages see one column space. The 21
runnable impls are plain torch, rank-polymorphic over leading batch axes —
the layout describes the trailing three axes, so a (n, c, im, im) batch goes
through the same code with the GEMM stages broadcasting over ``n``. Plain
matrix products inside them go to ``torch.matmul``, as the reference leaves
them to XLA; only tile columns (``base@variant``) reach the hand-written
kernels, through ``primitives.variants``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import lru_cache, partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.primitives import layouts as L


# ---------------------------------------------------------------------------
# Reference oracle (tests and chip_smoke.py only)
# ---------------------------------------------------------------------------

def reference_conv(x_chw: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Oracle: ``F.conv2d``, chw single image. Callers on the card turn TF32
    off (``torch.backends.cudnn.allow_tf32 = False``) before using it."""
    return F.conv2d(x_chw[None], w, stride=stride)[0]


def reference_conv_batch(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Batched oracle: ``F.conv2d`` over an NCHW batch."""
    return F.conv2d(x, w, stride=stride)


def out_size(im: int, f: int, s: int) -> int:
    return (im - f) // s + 1


# ---------------------------------------------------------------------------
# Lowerings (trailing image axes; leading axes are batch)
# ---------------------------------------------------------------------------

def _t(x: torch.Tensor, perm: Tuple[int, ...]) -> torch.Tensor:
    """Permute the trailing ``len(perm)`` axes, leading (batch) untouched."""
    lead = x.dim() - len(perm)
    return x.permute(*range(lead), *(lead + p for p in perm))


def _window_index(n_out: int, f: int, s: int, device) -> torch.Tensor:
    """(n_out * f,) gather index of every window position, output-major."""
    return ((torch.arange(n_out, device=device) * s)[:, None]
            + torch.arange(f, device=device)[None, :]).reshape(-1)


def _patches_copy_chw(x: torch.Tensor, f: int, s: int) -> torch.Tensor:
    """Slice-stacked ("copy") lowering: (..., c*f*f, oh*ow), (c, a, b) order."""
    c, h, w = x.shape[-3:]
    oh, ow = out_size(h, f, s), out_size(w, f, s)
    cols = [x[..., a:a + (oh - 1) * s + 1:s, b:b + (ow - 1) * s + 1:s]
            for a in range(f) for b in range(f)]
    pat = torch.stack(cols, dim=-3)           # (..., c, f*f, oh, ow)
    return pat.reshape(*x.shape[:-3], c * f * f, oh * ow)


def _patches_scan_chw(x: torch.Tensor, f: int, s: int) -> torch.Tensor:
    """Gather-indexed ("scan") lowering — same result, different traversal."""
    c, h, w = x.shape[-3:]
    oh, ow = out_size(h, f, s), out_size(w, f, s)
    ih = _window_index(oh, f, s, x.device)
    iw = _window_index(ow, f, s, x.device)
    pat = x.index_select(-2, ih).index_select(-1, iw)
    pat = pat.reshape(*x.shape[:-2], oh, f, ow, f)          # (..., c, oh, f, ow, f)
    pat = _t(pat, (0, 2, 4, 1, 3))                           # (..., c, f, f, oh, ow)
    return pat.reshape(*x.shape[:-3], c * f * f, oh * ow)


def _w_mat(w: torch.Tensor) -> torch.Tensor:
    """(k, c*f*f) with (c, a, b) ordering — matches chw patch lowering."""
    return w.reshape(w.shape[0], -1)


def _w_mat_rows(w: torch.Tensor) -> torch.Tensor:
    """(k, f*f*c) with (a, b, c) ordering — matches hwc row lowering."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def _patches_rows_hwc(x: torch.Tensor, f: int, s: int, scan: bool) -> torch.Tensor:
    """Row lowering from an hwc image: (..., oh*ow, f*f*c), (a, b, c) order."""
    h, w, c = x.shape[-3:]
    oh, ow = out_size(h, f, s), out_size(w, f, s)
    if scan:
        ih = _window_index(oh, f, s, x.device)
        iw = _window_index(ow, f, s, x.device)
        pat = x.index_select(-3, ih).index_select(-2, iw)
        pat = pat.reshape(*x.shape[:-3], oh, f, ow, f, c)   # (..., oh, f, ow, f, c)
        pat = _t(pat, (0, 2, 1, 3, 4))                       # (..., oh, ow, f, f, c)
    else:
        rows = [x[..., a:a + (oh - 1) * s + 1:s, b:b + (ow - 1) * s + 1:s, :]
                for a in range(f) for b in range(f)]
        pat = torch.stack(rows, dim=-2)                      # (..., oh, ow, f*f, c)
    return pat.reshape(*x.shape[:-3], oh * ow, f * f * c)


# ---------------------------------------------------------------------------
# im2col / im2row family
# ---------------------------------------------------------------------------

def im2col(x: torch.Tensor, w: torch.Tensor, s: int, *, scan: bool, out_ik: bool) -> torch.Tensor:
    c, h, wd = x.shape[-3:]
    f = w.shape[2]
    oh, ow = out_size(h, f, s), out_size(wd, f, s)
    pat = (_patches_scan_chw if scan else _patches_copy_chw)(x, f, s)
    wm = _w_mat(w)
    lead = x.shape[:-3]
    if out_ik:
        y = pat.transpose(-1, -2) @ wm.T              # (..., P, k)  "atb-ik"
        return y.reshape(*lead, oh, ow, w.shape[0])           # hwc
    y = wm @ pat                                      # (..., k, P)  "ab-ki"
    return y.reshape(*lead, w.shape[0], oh, ow)               # chw


def im2row(x: torch.Tensor, w: torch.Tensor, s: int, *, scan: bool, out_ik: bool) -> torch.Tensor:
    h, wd, c = x.shape[-3:]
    f = w.shape[2]
    oh, ow = out_size(h, f, s), out_size(wd, f, s)
    pat = _patches_rows_hwc(x, f, s, scan)
    wm = _w_mat_rows(w)
    lead = x.shape[:-3]
    if out_ik:
        y = pat @ wm.T                                # (..., P, k)
        return y.reshape(*lead, oh, ow, w.shape[0])           # hwc
    y = wm @ pat.transpose(-1, -2)                    # (..., k, P)
    return y.reshape(*lead, w.shape[0], oh, ow)               # chw


# ---------------------------------------------------------------------------
# kn2 family (sum of f*f pointwise GEMMs, shift-accumulated; stride 1)
# ---------------------------------------------------------------------------

def kn2row(x: torch.Tensor, w: torch.Tensor, s: int, *, stacked: bool = False) -> torch.Tensor:
    """chw -> chw. One (k,c)@(c,h*w) GEMM per kernel offset on the *full*
    image, then shifted accumulation of the valid region."""
    c, h, wd = x.shape[-3:]
    k, _, f, _ = w.shape
    oh, ow = out_size(h, f, s), out_size(wd, f, s)
    lead = x.shape[:-3]
    xf = x.reshape(*lead, c, h * wd)
    if stacked:  # "-as" variant: all offsets at once, one reduction
        g = w.permute(2, 3, 0, 1).reshape(f * f * k, c)
        full = (g @ xf).reshape(*lead, f, f, k, h, wd)
        parts = [full[..., a, b, :, a:a + oh, b:b + ow]
                 for a in range(f) for b in range(f)]
        return torch.stack(parts).sum(0)
    acc = x.new_zeros((*lead, k, oh, ow))
    for a in range(f):
        for b in range(f):
            full = (w[:, :, a, b] @ xf).reshape(*lead, k, h, wd)
            acc = acc + full[..., a:a + oh, b:b + ow]
    return acc


def kn2col(x: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """hwc -> hwc. Image-major GEMM per offset."""
    h, wd, c = x.shape[-3:]
    k, _, f, _ = w.shape
    oh, ow = out_size(h, f, s), out_size(wd, f, s)
    lead = x.shape[:-3]
    xf = x.reshape(*lead, h * wd, c)
    acc = x.new_zeros((*lead, oh, ow, k))
    for a in range(f):
        for b in range(f):
            full = (xf @ w[:, :, a, b].T).reshape(*lead, h, wd, k)
            acc = acc + full[..., a:a + oh, b:b + ow, :]
    return acc


# ---------------------------------------------------------------------------
# Winograd family (stride 1)
# ---------------------------------------------------------------------------

# F(2x2, 3x3)
_BT_4 = np.array([[1, 0, -1, 0],
                  [0, 1, 1, 0],
                  [0, -1, 1, 0],
                  [0, 1, 0, -1]], np.float64)
_G_23 = np.array([[1, 0, 0],
                  [0.5, 0.5, 0.5],
                  [0.5, -0.5, 0.5],
                  [0, 0, 1]], np.float64)
_AT_2_3 = np.array([[1, 1, 1, 0],
                    [0, 1, -1, -1]], np.float64)

# n=6 point set {0, 1, -1, 2, -2, inf}
_BT_6 = np.array([[4, 0, -5, 0, 1, 0],
                  [0, -4, -4, 1, 1, 0],
                  [0, 4, -4, -1, 1, 0],
                  [0, -2, -1, 2, 1, 0],
                  [0, 2, -1, -2, 1, 0],
                  [0, 4, 0, -5, 0, 1]], np.float64)
_AT_4_3 = np.array([[1, 1, 1, 1, 1, 0],
                    [0, 1, -1, 2, -2, 0],
                    [0, 1, 1, 4, 4, 0],
                    [0, 1, -1, 8, -8, 1]], np.float64)
_AT_2_5 = np.array([[1, 1, 1, 1, 1, 0],
                    [0, 1, -1, 2, -2, 1]], np.float64)


def _derive_G(AT: np.ndarray, BT: np.ndarray, m: int, r: int) -> np.ndarray:
    """Solve for G from the Winograd identity AT @ diag(G g) @ BT == S(g)
    for kernel basis vectors — numerically robust, avoids transcription bugs
    in hand-copied G matrices. Residual is asserted tiny."""
    n = m + r - 1
    # column k of the linear map: vec(outer(AT[:, k], BT[k, :]))
    M = np.stack([np.outer(AT[:, k], BT[k, :]).ravel() for k in range(n)], axis=1)
    G = np.zeros((n, r))
    for i in range(r):
        S = np.zeros((m, n))
        for t in range(m):
            S[t, t + i] = 1.0
        sol, res, *_ = np.linalg.lstsq(M, S.ravel(), rcond=None)
        if not np.allclose(M @ sol, S.ravel(), atol=1e-9):
            raise RuntimeError("winograd G derivation failed")
        G[:, i] = sol
    return G


_G_43 = _derive_G(_AT_4_3, _BT_6, 4, 3)
_G_25 = _derive_G(_AT_2_5, _BT_6, 2, 5)

_WINO_SETS = {
    (2, 3): (_AT_2_3, _G_23, _BT_4),
    (4, 3): (_AT_4_3, _G_43, _BT_6),
    (2, 5): (_AT_2_5, _G_25, _BT_6),
}


def wino_matrices(m: int, r: int, like: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(AT, G, BT) of F(m, r) as tensors of ``like``'s dtype and device."""
    return tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device)
                 for a in _WINO_SETS[(m, r)])


def winograd2d(x: torch.Tensor, w: torch.Tensor, s: int, *, m: int, r: int) -> torch.Tensor:
    """chw -> chw, F(mxm, rxr), stride 1."""
    assert s == 1
    AT, G, BT = wino_matrices(m, r, x)
    c, h, wd = x.shape[-3:]
    k = w.shape[0]
    n = m + r - 1
    oh, ow = h - r + 1, wd - r + 1
    th, tw = -(-oh // m), -(-ow // m)
    ph, pw = (th - 1) * m + n, (tw - 1) * m + n
    lead = x.shape[:-3]
    xp = F.pad(x, (0, pw - wd, 0, ph - h))
    # overlapping n x n tiles at stride m: slice-stack over in-tile offsets
    rows = [torch.stack([xp[..., a:a + (th - 1) * m + 1:m, b:b + (tw - 1) * m + 1:m]
                         for b in range(n)], -1) for a in range(n)]
    tiles = torch.stack(rows, -2)                      # (..., c, th, tw, n, n)
    V = torch.einsum("an,...cijnb,bm->...cijam", BT, tiles, BT.T)
    U = torch.einsum("an,kcnb,bm->kcam", G, w, G.T)     # (k, c, n, n)
    M = torch.einsum("kcab,...cijab->...kijab", U, V)   # (..., k, th, tw, n, n)
    Y = torch.einsum("an,...kijnb,bm->...kijam", AT, M, AT.T)
    y = _t(Y, (0, 1, 3, 2, 4)).reshape(*lead, k, th * m, tw * m)
    return y[..., :oh, :ow]


def winograd1d(x: torch.Tensor, w: torch.Tensor, s: int, *, m: int, r: int) -> torch.Tensor:
    """chw -> chw. 1-D F(m, r) along rows, direct sum over kernel rows
    (paper's 'winograd-2-3' / 'winograd-2-5' style)."""
    assert s == 1
    AT, G, BT = wino_matrices(m, r, x)
    c, h, wd = x.shape[-3:]
    k = w.shape[0]
    n = m + r - 1
    oh, ow = h - r + 1, wd - r + 1
    tw = -(-ow // m)
    pw = (tw - 1) * m + n
    lead = x.shape[:-3]
    acc = x.new_zeros((*lead, k, oh, ow))
    for a in range(r):  # kernel rows handled directly
        xrow = F.pad(x[..., a:a + oh, :], (0, pw - wd))        # (..., c, oh, pw)
        segs = torch.stack([xrow[..., b:b + (tw - 1) * m + 1:m] for b in range(n)], -1)
        V = segs @ BT.T                                # (..., c, oh, tw, n)
        U = torch.einsum("nr,kcr->kcn", G, w[:, :, a, :])
        M = torch.einsum("kcn,...citn->...kitn", U, V)
        Y = M @ AT.T                                   # (..., k, oh, tw, m)
        acc = acc + Y.reshape(*lead, k, oh, tw * m)[..., :ow]
    return acc


# ---------------------------------------------------------------------------
# conv-1x1 family
# ---------------------------------------------------------------------------

def conv1x1(x: torch.Tensor, w: torch.Tensor, s: int, *, ik: bool) -> torch.Tensor:
    g = w[:, :, 0, 0]                                  # (k, c)
    if ik:   # hwc -> hwc
        return x[..., ::s, ::s, :] @ g.T
    xs = x[..., ::s, ::s]                              # chw -> chw
    c, oh, ow = xs.shape[-3:]
    y = g @ xs.reshape(*xs.shape[:-2], oh * ow)
    return y.reshape(*xs.shape[:-3], g.shape[0], oh, ow)


# ---------------------------------------------------------------------------
# MEC family (memory-efficient convolution, Cho & Brandt)
# ---------------------------------------------------------------------------

def mec_col(x: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """chw -> chw. Lower along width only (L: ow strips of f columns), then
    f partitioned small GEMMs along the height."""
    c, h, wd = x.shape[-3:]
    k, _, f, _ = w.shape
    oh, ow = out_size(h, f, s), out_size(wd, f, s)
    strips = torch.stack([x[..., j * s:j * s + f] for j in range(ow)], -4)  # (..., ow, c, h, f)
    parts = []
    for a in range(f):
        blk = strips[..., a:a + (oh - 1) * s + 1:s, :]     # (..., ow, c, oh, f)
        parts.append(torch.einsum("...jcib,kcb->...kij", blk, w[:, :, a, :]))
    return torch.stack(parts).sum(0)                      # (..., k, oh, ow)


def mec_row(x: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """hwc -> hwc. Lower along height; partitioned GEMMs along width."""
    h, wd, c = x.shape[-3:]
    k, _, f, _ = w.shape
    oh, ow = out_size(h, f, s), out_size(wd, f, s)
    strips = torch.stack([x[..., i * s:i * s + f, :, :] for i in range(oh)], -4)  # (..., oh, f, wd, c)
    parts = []
    for b in range(f):
        blk = strips[..., b:b + (ow - 1) * s + 1:s, :]      # (..., oh, f, ow, c)
        parts.append(torch.einsum("...iajc,kca->...ijk", blk, w[:, :, :, b]))
    return torch.stack(parts).sum(0)                       # (..., oh, ow, k)


# ---------------------------------------------------------------------------
# direct family
# ---------------------------------------------------------------------------

def direct_sum2d(x: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """chw -> chw. Offset-sliced multiply-accumulate without a GEMM
    lowering — the 'six nested loops' structure, vectorised over pixels."""
    c, h, wd = x.shape[-3:]
    k, _, f, _ = w.shape
    oh, ow = out_size(h, f, s), out_size(wd, f, s)
    acc = x.new_zeros((*x.shape[:-3], k, oh, ow))
    for a in range(f):
        for b in range(f):
            sl = x[..., a:a + (oh - 1) * s + 1:s, b:b + (ow - 1) * s + 1:s]
            acc = acc + torch.einsum("...cij,kc->...kij", sl, w[:, :, a, b])
    return acc


# ---------------------------------------------------------------------------
# Registry (metadata identical to the reference's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Primitive:
    name: str
    family: str                       # direct | im2 | kn2 | wino3 | wino5 | c1x1 | mec
    in_layout: str
    out_layout: str
    impl: Optional[Callable]          # (x, w, stride) -> y; None => simulated-only
    traits: dict

    def applicable(self, k: int, c: int, im: int, s: int, f: int) -> bool:
        if f > im:
            return False
        if self.family == "wino3":
            return f == 3 and s == 1 and im >= self.traits.get("tile_n", 4)
        if self.family == "wino5":
            return f == 5 and s == 1 and im >= self.traits.get("tile_n", 6)
        if self.family == "c1x1":
            return f == 1
        if self.family == "kn2":
            return s == 1
        return True


def _mk(name, family, inl, outl, impl, **traits) -> Primitive:
    return Primitive(name, family, inl, outl, impl, traits)


def build_registry() -> Dict[str, Primitive]:
    P: List[Primitive] = []
    # --- direct ---
    P.append(_mk("direct-sum2d", "direct", "chw", "chw", direct_sum2d))
    # --- im2col / im2row (16) ---
    for trav in ("copy", "scan"):
        scan = trav == "scan"
        P.append(_mk(f"im2col-{trav}-ab-ki", "im2", "chw", "chw",
                     partial(im2col, scan=scan, out_ik=False), trav=trav, order="ki",
                     epilogue=True))
        P.append(_mk(f"im2col-{trav}-atb-ik", "im2", "chw", "hwc",
                     partial(im2col, scan=scan, out_ik=True), trav=trav, order="ik"))
        P.append(_mk(f"im2col-{trav}-atb-ki", "im2", "chw", "chw", None, trav=trav, order="ki", t="atb"))
        P.append(_mk(f"im2col-{trav}-atbt-ik", "im2", "chw", "hwc", None, trav=trav, order="ik", t="atbt"))
        P.append(_mk(f"im2row-{trav}-ab-ik", "im2", "hwc", "hwc",
                     partial(im2row, scan=scan, out_ik=True), trav=trav, order="ik", row=True))
        P.append(_mk(f"im2row-{trav}-abt-ki", "im2", "hwc", "chw",
                     partial(im2row, scan=scan, out_ik=False), trav=trav, order="ki", row=True))
        P.append(_mk(f"im2row-{trav}-abt-ik", "im2", "hwc", "hwc", None, trav=trav, order="ik", row=True, t="abt"))
        P.append(_mk(f"im2row-{trav}-atbt-ki", "im2", "hwc", "chw", None, trav=trav, order="ki", row=True, t="atbt"))
    # --- kn2 (6) ---
    P.append(_mk("kn2row", "kn2", "chw", "chw", kn2row))
    P.append(_mk("kn2row-as", "kn2", "chw", "chw", partial(kn2row, stacked=True), variant="as"))
    P.append(_mk("kn2row-aa-ab", "kn2", "chw", "chw", None, variant="aa-ab"))
    P.append(_mk("kn2row-aa-atb", "kn2", "chw", "chw", None, variant="aa-atb"))
    P.append(_mk("kn2col", "kn2", "hwc", "hwc", kn2col))
    P.append(_mk("kn2col-as", "kn2", "hwc", "hwc", None, variant="as"))
    # --- wino3 (10) ---
    P.append(_mk("winograd-2-3", "wino3", "chw", "chw",
                 partial(winograd1d, m=2, r=3), tile_m=2, tile_n=4, oned=True))
    P.append(_mk("winograd-2-3-vec-4", "wino3", "chw", "chw", None, tile_m=2, tile_n=4, oned=True, vec=4))
    P.append(_mk("winograd-2x2-3x3", "wino3", "chw", "chw",
                 partial(winograd2d, m=2, r=3), tile_m=2, tile_n=4, epilogue=True))
    for v in (4, 8, 16):
        P.append(_mk(f"winograd-2x2-3x3-vec-{v}", "wino3", "chw", "chw", None, tile_m=2, tile_n=4, vec=v))
    P.append(_mk("winograd-4x4-3x3", "wino3", "chw", "chw",
                 partial(winograd2d, m=4, r=3), tile_m=4, tile_n=6, epilogue=True))
    for v in (4, 8, 16):
        P.append(_mk(f"winograd-4x4-3x3-vec-{v}", "wino3", "chw", "chw", None, tile_m=4, tile_n=6, vec=v))
    # --- wino5 (6) ---
    P.append(_mk("winograd-2-5", "wino5", "chw", "chw",
                 partial(winograd1d, m=2, r=5), tile_m=2, tile_n=6, oned=True))
    P.append(_mk("winograd-2-5-vec-4", "wino5", "chw", "chw", None, tile_m=2, tile_n=6, oned=True, vec=4))
    P.append(_mk("winograd-2x2-5x5", "wino5", "chw", "chw",
                 partial(winograd2d, m=2, r=5), tile_m=2, tile_n=6))
    for v in (4, 8, 16):
        P.append(_mk(f"winograd-2x2-5x5-vec-{v}", "wino5", "chw", "chw", None, tile_m=2, tile_n=6, vec=v))
    # --- conv-1x1 (8) ---
    P.append(_mk("conv-1x1-gemm-ab-ki", "c1x1", "chw", "chw", partial(conv1x1, ik=False), order="ki",
                 epilogue=True))
    P.append(_mk("conv-1x1-gemm-atb-ik", "c1x1", "hwc", "hwc", partial(conv1x1, ik=True), order="ik"))
    for nm, lay in (("ab-ik", "hwc"), ("abt-ki", "chw"), ("abt-ik", "hwc"),
                    ("atb-ki", "chw"), ("atbt-ik", "hwc"), ("atbt-ki", "chw")):
        P.append(_mk(f"conv-1x1-gemm-{nm}", "c1x1", lay, lay, None, order=nm.split("-")[1]))
    # --- mec (2) ---
    P.append(_mk("mec-col", "mec", "chw", "chw", mec_col))
    P.append(_mk("mec-row-partition", "mec", "hwc", "hwc", mec_row))

    reg = {p.name: p for p in P}
    assert len(reg) == len(P), "duplicate primitive names"
    return reg


REGISTRY: Dict[str, Primitive] = build_registry()
PRIMITIVE_NAMES: List[str] = list(REGISTRY)
RUNNABLE: List[str] = [n for n, p in REGISTRY.items() if p.impl is not None]
FAMILIES = ("direct", "im2", "kn2", "wino3", "wino5", "c1x1", "mec")


# ---------------------------------------------------------------------------
# Tile-config columns: "prim@tile" is a base registry primitive executed
# under one kernel tile configuration (selection treats each pair as its own
# column). Same rules as the reference.
# ---------------------------------------------------------------------------

TILE_SEP = "@"


def split_tile(name: str) -> Tuple[str, Optional[str]]:
    """'prim@tile' -> (base primitive name, tile variant); plain registry
    names return (name, None)."""
    base, sep, variant = name.partition(TILE_SEP)
    return base, (variant if sep else None)


def resolve(name: str) -> Primitive:
    """Registry entry for a (possibly tile-suffixed) column name."""
    return REGISTRY[split_tile(name)[0]]


# Bases each kernel family can lower: "mm-*" feeds the base's GEMM through
# kernels/matmul (im2col / 1x1) or the Winograd point-GEMM (2-D wino3);
# "conv-bk*" is the implicit-GEMM conv's K-block (im2col family and 1x1, a
# degenerate f=1 im2col); "wino-*" tiles the Winograd point-GEMM.
MM_LOWERABLE_BASES = ("im2col-copy-ab-ki", "im2col-scan-ab-ki",
                      "conv-1x1-gemm-ab-ki",
                      "winograd-2x2-3x3", "winograd-4x4-3x3")
CONVBK_LOWERABLE_BASES = ("im2col-copy-ab-ki", "im2col-scan-ab-ki",
                          "conv-1x1-gemm-ab-ki")
WINO_LOWERABLE_BASES = ("winograd-2x2-3x3", "winograd-4x4-3x3")


def variant_compatible(base: str, variant: Optional[str]) -> bool:
    """True iff the plan lowering can execute ``base`` under tile ``variant``."""
    if variant is None:
        return True
    p = REGISTRY.get(base)
    if p is None or p.impl is None:
        return False
    # kernel VARIANTS imports are function-scope: kernels/winograd/ops
    # imports _WINO_SETS from this module at import time
    if variant.startswith("mm-"):
        from repro_torch.kernels.matmul.ops import VARIANTS
        return variant in VARIANTS and base in MM_LOWERABLE_BASES
    if variant.startswith("conv-bk"):
        from repro_torch.kernels.im2col_gemm.ops import VARIANTS
        return variant in VARIANTS and base in CONVBK_LOWERABLE_BASES
    if variant.startswith("wino-"):
        from repro_torch.kernels.winograd.ops import VARIANTS
        return variant in VARIANTS and base in WINO_LOWERABLE_BASES
    return False


def is_runnable(name: str) -> bool:
    """A tile column is runnable iff its base primitive is AND the lowering
    accepts the (base, variant) pair."""
    base, variant = split_tile(name)
    if base not in REGISTRY or REGISTRY[base].impl is None:
        return False
    return variant is None or variant_compatible(base, variant)


def supports_epilogue(name: str) -> bool:
    """Whether the column's base primitive advertises fused elementwise
    epilogues (bias / ReLU / residual add applied before the store)."""
    base, _ = split_tile(name)
    p = REGISTRY.get(base)
    return bool(p is not None and p.traits.get("epilogue", False))


def tile_columns(bases: Sequence[str], variants: Sequence[str]) -> List[str]:
    """The (base × tile-variant) cross product as column names, filtered to
    pairs the lowering can actually execute."""
    return [f"{b}{TILE_SEP}{v}" for b in bases for v in variants
            if variant_compatible(b, v)]


def family_of(name: str) -> str:
    return resolve(name).family


# ---------------------------------------------------------------------------
# Compiled per-column trait arrays (batched estimation), as the reference's
# ---------------------------------------------------------------------------

# transpose-variant codes shared with the simulators: index into this tuple
T_VARIANTS: Tuple[Optional[str], ...] = (None, "atb", "abt", "atbt")


def name_hash64(s: str) -> int:
    """Stable 64-bit key for a registry/DLT name (noise stream seeding)."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


@dataclasses.dataclass(frozen=True)
class ColumnTraits:
    """Registry traits of a column list, pre-compiled into numpy arrays so the
    simulator time models can broadcast over (configs × columns) at once."""
    names: Tuple[str, ...]
    fam: np.ndarray            # (P,) int8 index into FAMILIES
    vec: np.ndarray            # (P,) float64 SIMD lanes, 0.0 = unspecified
    t_idx: np.ndarray          # (P,) int8 index into T_VARIANTS
    scan: np.ndarray           # (P,) bool, trav == "scan"
    order_ki: np.ndarray       # (P,) bool, order == "ki"
    tile_m: np.ndarray         # (P,) int64 Winograd output tile, 0 = n/a
    tile_n: np.ndarray         # (P,) int64 Winograd input tile, 0 = n/a
    oned: np.ndarray           # (P,) bool, 1-D Winograd
    variant_as: np.ndarray     # (P,) bool, kn2 "-as" stacked accumulation
    in_layout: np.ndarray      # (P,) int8 index into layouts.LAYOUTS
    out_layout: np.ndarray     # (P,) int8 index into layouts.LAYOUTS
    key: np.ndarray            # (P,) uint64 per-column noise-stream key
    epilogue: np.ndarray       # (P,) bool, fused elementwise epilogue support

    def applicable_mask(self, k: np.ndarray, c: np.ndarray, im: np.ndarray,
                        s: np.ndarray, f: np.ndarray) -> np.ndarray:
        """(L, P) bool mask mirroring ``Primitive.applicable`` — vectorised
        over (L,) config component arrays and the compiled columns."""
        k, c, im, s, f = (np.asarray(a).reshape(-1, 1) for a in (k, c, im, s, f))
        fam = self.fam[None, :]
        wino = (fam == FAMILIES.index("wino3")) | (fam == FAMILIES.index("wino5"))
        wino_f = np.where(self.fam == FAMILIES.index("wino5"), 5, 3)[None, :]
        return ((f <= im)
                & np.where(wino, (f == wino_f) & (s == 1)
                           & (im >= self.tile_n[None, :]), True)
                & np.where(fam == FAMILIES.index("c1x1"), f == 1, True)
                & np.where(fam == FAMILIES.index("kn2"), s == 1, True))


@lru_cache(maxsize=256)
def compile_traits(names: Tuple[str, ...]) -> ColumnTraits:
    # tile columns ("prim@tile") compile to their BASE primitive's traits —
    # layouts/applicability are tile-invariant — but keep a per-column noise
    # key from the full name so every tile gets its own deterministic stream
    prims = [resolve(n) for n in names]
    t = [p.traits for p in prims]
    return ColumnTraits(
        names=tuple(names),
        fam=np.array([FAMILIES.index(p.family) for p in prims], np.int8),
        vec=np.array([float(x.get("vec", 0) or 0) for x in t], np.float64),
        t_idx=np.array([T_VARIANTS.index(x.get("t")) for x in t], np.int8),
        scan=np.array([x.get("trav") == "scan" for x in t], bool),
        order_ki=np.array([x.get("order") == "ki" for x in t], bool),
        tile_m=np.array([int(x.get("tile_m", 0)) for x in t], np.int64),
        # same defaults as Primitive.applicable: wino3 -> 4, wino5 -> 6
        tile_n=np.array([int(x.get("tile_n", {"wino3": 4, "wino5": 6}.get(p.family, 0)))
                         for p, x in zip(prims, t)], np.int64),
        oned=np.array([bool(x.get("oned", False)) for x in t], bool),
        variant_as=np.array([str(x.get("variant", "")).startswith("as") for x in t], bool),
        in_layout=np.array([L.LAYOUTS.index(p.in_layout) for p in prims], np.int8),
        out_layout=np.array([L.LAYOUTS.index(p.out_layout) for p in prims], np.int8),
        key=np.array([name_hash64(n) for n in names], np.uint64),
        epilogue=np.array([bool(x.get("epilogue", False)) for x in t], bool),
    )


def run_primitive(name: str, x_chw: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Run primitive ``name`` on a chw image, returning chw output — layout
    conversions applied around the primitive's native layouts. Tile columns
    run their base impl here; the plan lowers them onto the kernels."""
    p = resolve(name)
    if p.impl is None:
        raise ValueError(f"{name} is a simulated-only primitive")
    y = p.impl(L.from_chw(x_chw, p.in_layout), w, stride)
    return L.to_chw(y, p.out_layout)


# ---------------------------------------------------------------------------
# Batched entry points (plan compiler)
# ---------------------------------------------------------------------------

def batch_impl(prim: Primitive) -> Callable:
    """Batched callable ``(x (n, *in_layout), w, stride) -> (n, *out_layout)``.
    Every runnable impl is rank-polymorphic over leading batch axes, so the
    single-image impl *is* the batched impl."""
    if prim.impl is None:
        raise ValueError(f"{prim.name} is a simulated-only primitive")
    return prim.impl


def run_primitive_batch(name: str, x_chw: torch.Tensor, w: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """Batched ``run_primitive``: (n, c, im, im) chw in, (n, k, oh, ow) out."""
    p = resolve(name)
    y = batch_impl(p)(L.from_chw(x_chw, p.in_layout), w, stride)
    return L.to_chw(y, p.out_layout)
