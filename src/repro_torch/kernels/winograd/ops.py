"""Full Winograd conv, F(mxm, 3x3) with m = 2 or 4: the port of
``repro.kernels.winograd.ops``. Three hand-written kernels run it — the
input transform, the point-GEMM and the inverse transform, all in
``csrc/winograd.cu`` — around the weight transform U = G w G^T, which stays
a torch einsum (it touches only the weights). The batched
``winograd_conv_batch`` / ``winograd_conv_batch_op`` run the batched
point-GEMM, the single-image ``winograd_conv`` / ``winograd_conv_op`` the
single-image one; both run the same transform kernels. As in the
reference, the bias / residual / ReLU epilogue follows the inverse
transform (here inside its kernel, before the single store): it cannot move
into the point-GEMM, whose output lives in the transform domain.

Dtypes, as the reference's ``winograd_conv`` has them: both transforms and
the point-GEMM run in fp32 whatever x's dtype, bias and residual are
widened to fp32 before the epilogue (the reference's ``_epilogue`` adds
them to the fp32 result), and the output is cast once to x's dtype. So a
bf16 conv returns bf16 without running the bf16 point-GEMM, which only a
caller of ``winograd_point_gemm*`` on bf16 u and v reaches (``cta_plan``
plans it at that dtype).

Launch plans. ``wino-*`` keeps the reference's (bk, bt) TPU blocks (K by T,
channel block 128); its ceiling tile halves each, capped at 128, with a
channel depth of 16. ``mm-*`` on a Winograd base tiles the point-GEMM as
(K, C, T) under the matmul kernel's own ceiling (``kernels/matmul/ops.py``
``ceiling``). A bf16 ceiling doubles the depth (a stage of the same bytes):

    variant           TPU block         ceiling (BM, BK, BN)   bf16
    wino-128x128      (128, 128)        ( 64, 16,  64)        ( 64, 32,  64)
    wino-256x128      (256, 128)        (128, 16,  64)        (128, 32,  64)
    wino-128x256      (128, 256)        ( 64, 16, 128)        ( 64, 32, 128)
    mm-*              (bm, bk, bn)      matmul's ceiling      matmul's bf16 ceiling

``cta_plan`` fits the ceiling to each call's K x C by C x T point-GEMMs by
the matmul kernel's rule (``common.fit_plan``), with the N images times P
points as the batch.

**Routes** of a direct point-GEMM call (``plan``): ``route`` picks each
call's kernel from the call alone, before anything launches. bf16 u and v
with at least 64 output channels, C % 8 == 0 and a 16-byte aligned u
(``winograd.takes_wgmma``), and at least ``WGMMA_MIN_COLS`` (8) output
columns, take ``"wgmma"`` (``csrc/winograd_wgmma.cu``), everything else
``"mma.sync"`` (``csrc/winograd.cu``) under ``cta_plan``. The columns are
T, or the images' T together where the wgmma kernel packs short rows
(``WGMMA_PACK_T``), so U[p] is read once for all images. Of resnet18's
one-image calls with fewer, T = 1 lost to mma.sync and T = 4 tied
(tools/ab_wino_bf16.py). On the wgmma route ``wgmma_plan`` gives BM, the smallest of 64 and 128
covering K (one or two consumer warpgroups of ``wgmma.m64n64k16``), or 64
where 128 would leave half the SMs idle; every tile is 64 t-values wide
and 64 deep a stage (``winograd.WGMMA_TILES``: two 64 x 64 CTAs share an
SM, and were faster than 128- and 256-wide tiles on every resnet18
layer). The wgmma route never splits C: every split of resnet18's
point-GEMMs ran slower than none. The Winograd convs here run the fp32 point-GEMM whatever x's dtype,
as the reference does, so they never take the wgmma route.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import SMS, as_f32, fit_plan
from repro_torch.kernels.matmul.ops import CTA_TILES as MM_CTA_TILES  # noqa: F401
from repro_torch.kernels.matmul.ops import ceiling as mm_ceiling
from repro_torch.kernels.winograd.winograd import (
    TILE_M, TILE_N, WGMMA_BK, WGMMA_BN, WGMMA_MIN_COLS, WGMMA_PACK_T,
    WGMMA_TILE_M, takes_wgmma, transform_matrices, winograd_input_transform,
    winograd_inverse_transform, winograd_point_gemm, winograd_point_gemm_batch)

VARIANTS: Dict[str, Tuple[int, int]] = {
    "wino-128x128": (128, 128), "wino-256x128": (256, 128),
    "wino-128x256": (128, 256)}

# (BM, BK, BN) ceiling tile per wino-* variant — the table in the docstring
CTA_TILES: Dict[str, Tuple[int, int, int]] = {
    "wino-128x128": (64, 16, 64),
    "wino-256x128": (128, 16, 64),
    "wino-128x256": (64, 16, 128),
}


def ceiling(variant: str,
            dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """(BM, BK, BN) ceiling tile of a ``wino-*`` or ``mm-*`` variant for
    operands of ``dtype``: the fp32 tile's depth doubled for bf16 (the
    table)."""
    if variant not in CTA_TILES:
        return mm_ceiling(variant, dtype)
    bm, bk, bn = CTA_TILES[variant]
    return (bm, 2 * bk, bn) if dtype == torch.bfloat16 else (bm, bk, bn)


def cta_plan(K: int, T: int, C: int, batch: int, variant: str,
             dtype: torch.dtype = torch.float32) -> Tuple[int, int, int, int]:
    """(BM, BN, BK, split_k) for ``batch`` = N images x P points
    point-GEMMs (K, C) @ (C, T) under ``variant`` on operands of ``dtype``:
    ``common.fit_plan`` on the variant's ceiling at that dtype and the tile
    sizes csrc/winograd.cu instantiates. BM and BN are the smallest
    instantiated sizes covering K and T under the ceiling; C is split, in
    whole BK steps, until the output tiles give every SM a CTA and 8 warps
    (or one step per slice)."""
    return fit_plan(K, T, C, batch, ceiling(variant, dtype), TILE_M, TILE_N)


def columns(T: int, images: int) -> Tuple[int, int]:
    """(columns of a wgmma tile row, column runs) of ``images`` x P
    point-GEMMs with T t-values: T once per image, or, where T <
    ``WGMMA_PACK_T`` and there is more than one image, the images' T
    together once (the kernel packs them)."""
    if images > 1 and T < WGMMA_PACK_T:
        return images * T, 1
    return T, images


def wgmma_plan(K: int, T: int, batch: int, images: int = 1) -> Tuple[int, int]:
    """(BM, BN) for ``batch`` = ``images`` x P point-GEMMs (K, C) @ (C, T)
    on the wgmma route, ``WGMMA_BK`` deep and unsplit. BM is the smallest
    of ``WGMMA_TILE_M`` covering K (128 above), dropped to 64 where its
    output tiles (``WGMMA_BN`` of the ``columns`` wide) would leave half of
    the ``SMS`` streaming multiprocessors idle; BN is ``WGMMA_BN``."""
    cols, runs = columns(T, images)
    tiles = -(-cols // WGMMA_BN) * (batch // images) * runs   # per BM row
    bm = next((t for t in WGMMA_TILE_M if t >= K), WGMMA_TILE_M[-1])
    if bm > WGMMA_TILE_M[0] and 2 * -(-K // bm) * tiles < SMS:
        bm = WGMMA_TILE_M[0]
    return bm, WGMMA_BN


def route(u, v) -> str:
    """The kernel the point-GEMMs of ``u`` and ``v`` take: ``"wgmma"``
    where ``winograd.takes_wgmma`` accepts the operands (bf16, K >= 64,
    C % 8 == 0, u 16-byte aligned) and they have at least
    ``WGMMA_MIN_COLS`` output ``columns``, else ``"mma.sync"``. Decided
    from the call alone; neither route falls back to the other."""
    images = 1 if v.dim() == 3 else v.shape[0]
    wide = columns(v.shape[-1], images)[0] >= WGMMA_MIN_COLS
    return "wgmma" if wide and takes_wgmma(u, v) else "mma.sync"


def plan(u, v, variant: str = "wino-128x128") -> dict:
    """The launch arguments of the point-GEMMs of ``u`` (P, K, C) and
    ``v`` (N, P, C, T), or (P, C, T) for one image: route, tile and split,
    as ``winograd_point_gemm`` / ``winograd_point_gemm_batch`` take them;
    ``variant`` sets the mma.sync route's tile (``cta_plan``)."""
    P, K, C = u.shape
    T = v.shape[-1]
    images = 1 if v.dim() == 3 else v.shape[0]
    if route(u, v) == "wgmma":
        bm, bn = wgmma_plan(K, T, P * images, images)
        return dict(bm=bm, bk=WGMMA_BK, bn=bn, split_k=1, route="wgmma")
    bm, bn, bk, split = cta_plan(K, T, C, P * images, variant, u.dtype)
    return dict(bm=bm, bk=bk, bn=bn, split_k=split, route="mma.sync")


def weight_transform(w: torch.Tensor, m: int) -> torch.Tensor:
    """w (K, C, 3, 3) -> U (n², K, C) = G w G^T, float32."""
    w = w.float()
    G = transform_matrices(m, w.dtype, w.device)[1]
    K, C = w.shape[:2]
    U = torch.einsum("ar,kcrs,sb->abkc", G, w, G.T)
    return U.reshape((m + 2) ** 2, K, C).contiguous()


def winograd_conv_batch(x: torch.Tensor, w: torch.Tensor, *, m: int = 2,
                        variant: str = "wino-128x128", bias=None,
                        residual=None, relu: bool = False) -> torch.Tensor:
    """x (N, C, H, W), w (K, C, 3, 3) -> (N, K, H-2, W-2), stride 1,
    F(mxm, 3x3), in x's dtype. U is transformed once and shared; only V
    carries the batch."""
    N, C, H, W = x.shape
    K, oh, ow = w.shape[0], H - 2, W - 2
    V = winograd_input_transform(x.float().contiguous(), m)   # (N, n², C, T)
    U = weight_transform(w, m)
    bm, bn, bk, split = cta_plan(K, V.shape[-1], C, N * U.shape[0], variant)
    M = winograd_point_gemm_batch(U, V, bm=bm, bk=bk, bn=bn, split_k=split)
    y = winograd_inverse_transform(M, m, oh, ow, bias=as_f32(bias),
                                   residual=as_f32(residual), relu=relu)
    return y.to(x.dtype)


def winograd_conv(x: torch.Tensor, w: torch.Tensor, *, m: int = 2,
                  variant: str = "wino-128x128", bias=None, residual=None,
                  relu: bool = False) -> torch.Tensor:
    """x (C, H, W), w (K, C, 3, 3) -> (K, H-2, W-2), stride 1, F(mxm, 3x3),
    through the single-image point-GEMM kernel, in x's dtype. ``bias`` is
    (K,), ``residual`` is (K, H-2, W-2)."""
    C, H, W = x.shape
    K, oh, ow = w.shape[0], H - 2, W - 2
    V = winograd_input_transform(x.float().contiguous()[None], m)[0]
    U = weight_transform(w, m)
    bm, bn, bk, split = cta_plan(K, V.shape[-1], C, U.shape[0], variant)
    M = winograd_point_gemm(U, V, bm=bm, bk=bk, bn=bn, split_k=split)
    y = winograd_inverse_transform(
        M[None], m, oh, ow, bias=as_f32(bias),
        residual=None if residual is None else as_f32(residual)[None],
        relu=relu)[0]
    return y.to(x.dtype)


def winograd_conv_op(x: torch.Tensor, w: torch.Tensor,
                     variant: str = "wino-128x128") -> torch.Tensor:
    """x (C, H, W), w (K, C, 3, 3) -> (K, H-2, W-2). Stride 1, F(2x2, 3x3)."""
    return winograd_conv(x, w, m=2, variant=variant)


def winograd_conv_batch_op(x: torch.Tensor, w: torch.Tensor,
                           variant: str = "wino-128x128") -> torch.Tensor:
    """x (N, C, H, W), w (K, C, 3, 3) -> (N, K, H-2, W-2). Stride 1, F(2x2, 3x3)."""
    return winograd_conv_batch(x, w, m=2, variant=variant)
