"""The port's three served GEMM kernels against the reference's Pallas kernels,
and its Winograd transforms against B^T d B and A^T M A of each tile.

On the CPU each wrapper computes its plain PyTorch version (its tensors lie
on the CPU), so these tests hold the plain versions — and the wrappers'
shape/tile/epilogue plumbing — to the Pallas kernels run in interpret mode,
on the same numpy inputs. Tolerances are the reference's own: fp32
rtol=atol=1e-4 for the GEMM kernels (``tests/test_kernels.py::_TOL``) and
1e-3 for the full Winograd conv.

``tests/test_torch_gpu.py`` holds each hand-written CUDA kernel to its plain
version on the card.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.im2col_gemm.im2col_gemm import conv_im2col_batch as jax_conv_batch
from repro.kernels.matmul.matmul import matmul as jax_matmul
from repro.kernels.matmul.ops import VARIANTS as JAX_MM_VARIANTS
from repro.kernels.matmul.ops import matmul_op as jax_matmul_op
from repro.kernels.winograd.ops import winograd_conv_batch as jax_wino_conv
from repro.kernels.winograd.winograd import winograd_point_gemm_batch as jax_point_gemm
from repro.primitives.conv import reference_conv_batch as jax_conv_ref
from repro_torch.kernels.im2col_gemm import im2col_gemm as conv_mod
from repro_torch.kernels.im2col_gemm.im2col_gemm import conv_im2col, conv_im2col_batch
from repro_torch.kernels.im2col_gemm.ops import CTA_TILES as CONV_TILES
from repro_torch.kernels.im2col_gemm.ops import VARIANTS as CONV_VARIANTS
from repro_torch.kernels.im2col_gemm.ops import conv_im2col_batch_op
from repro_torch.kernels.im2col_gemm.ops import cta_plan as conv_cta_plan
from repro_torch.kernels.matmul.matmul import (TILE_K, TILE_M, TILE_N, cta_warps,
                                               matmul, matmul_batch)
from repro_torch.kernels.matmul.ops import CTA_TILES as MM_TILES
from repro_torch.kernels.matmul.ops import SMS, WARPS_PER_SM, cta_plan, matmul_op
from repro_torch.kernels.matmul.ops import VARIANTS as MM_VARIANTS
from repro_torch.kernels.winograd.ops import CTA_TILES as WINO_TILES
from repro_torch.kernels.winograd.ops import MM_CTA_TILES as WINO_MM_TILES
from repro_torch.kernels.winograd.ops import VARIANTS as WINO_VARIANTS
from repro_torch.kernels.winograd import winograd as wino_mod
from repro_torch.kernels.winograd.ops import cta_plan as wino_cta_plan
from repro_torch.kernels.winograd.ops import winograd_conv_batch
from repro_torch.kernels.winograd.winograd import (
    winograd_input_transform, winograd_inverse_transform, winograd_point_gemm,
    winograd_point_gemm_batch)

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
WINO_TOL = dict(rtol=1e-3, atol=1e-3)
EPILOGUES = list(itertools.product((False, True), repeat=3))   # bias, res, relu


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# matmul (reference: kernels/matmul/matmul.py:140)
# ---------------------------------------------------------------------------

def test_variant_keys_match_reference():
    assert MM_VARIANTS == JAX_MM_VARIANTS
    from repro.kernels.im2col_gemm.ops import VARIANTS as JAX_CONV
    from repro.kernels.winograd.ops import VARIANTS as JAX_WINO
    assert CONV_VARIANTS == JAX_CONV and WINO_VARIANTS == JAX_WINO
    # every key's ceiling is a tile its CUDA launcher instantiates:
    # matmul.cu's, im2col_gemm.cu's and winograd.cu's
    legal = set(itertools.product(wino_mod.TILE_M, wino_mod.TILE_K,
                                  wino_mod.TILE_N))
    mm_legal = set(itertools.product(TILE_M, TILE_K, TILE_N))
    conv_legal = set(itertools.product(conv_mod.TILE_M, conv_mod.TILE_K,
                                       conv_mod.TILE_N))
    for table, keys, tiles in ((MM_TILES, MM_VARIANTS, mm_legal),
                               (CONV_TILES, CONV_VARIANTS, conv_legal),
                               (WINO_TILES, WINO_VARIANTS, legal),
                               (WINO_MM_TILES, MM_VARIANTS, legal)):
        assert set(table) == set(keys) and set(table.values()) <= tiles


@pytest.mark.parametrize("variant", sorted(JAX_MM_VARIANTS))
def test_matmul_every_variant_ragged(variant, rng):
    """Every mm-* key, ragged M/N/K (not multiples of any tile)."""
    x, y = _np(rng, 150, 70), _np(rng, 70, 90)
    want = jax_matmul_op(jnp.asarray(x), jnp.asarray(y), variant=variant,
                         interpret=True)
    got = matmul_op(_t(x), _t(y), variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


@pytest.mark.parametrize("bias,res,relu", EPILOGUES)
def test_matmul_epilogues_vs_fused_store(bias, res, relu, rng):
    """Every epilogue combination against the reference's in-kernel
    epilogue (``fuse_store=True``), bias -> residual -> ReLU."""
    M, K, N = 100, 77, 33
    x, y = _np(rng, M, K), _np(rng, K, N)
    b = _np(rng, M) if bias else None
    r = _np(rng, M, N) if res else None
    want = jax_matmul(jnp.asarray(x), jnp.asarray(y), bm=32, bk=32, bn=32,
                      bias=_j(b), residual=_j(r), relu=relu, interpret=True,
                      fuse_store=True)
    got = matmul(_t(x), _t(y), bias=_t(b), residual=_t(r), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


def test_matmul_rejects_what_the_kernel_cannot_take():
    x, y = torch.zeros(4, 3), torch.zeros(3, 5)
    with pytest.raises(TypeError):
        matmul(x.double(), y.double())
    with pytest.raises(ValueError):
        matmul(torch.zeros(3, 4).T, y)              # non-contiguous
    with pytest.raises(ValueError):
        matmul(x, y, bias=torch.zeros(5))
    with pytest.raises(ValueError):
        matmul(x, y.to("meta"))                     # mixed devices


def test_matmul_refuses_values_past_int32():
    """ctypes would wrap a C int past 2**31 - 1 silently: both wrappers
    refuse such a dimension, on any device. Batch strides go to the kernel
    as 64-bit, so a batch stride past 2**31 passes these checks (the meta
    tensors below are then refused for their device, not their size)."""
    big = 2 ** 31 + 5
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="int32"):
        matmul(torch.empty(big, 1, **meta), torch.empty(1, 1, **meta))
    with pytest.raises(ValueError, match="int32"):
        matmul(torch.empty(1, 1), torch.empty(1, big, **meta))
    with pytest.raises(ValueError, match="int32"):
        matmul_batch(torch.empty(big, 1, 1, **meta), torch.empty(big, 1, 1, **meta))
    with pytest.raises(ValueError, match="int32"):
        matmul_batch(torch.empty(1, 1, big, **meta), torch.empty(1, big, 1, **meta))
    x = torch.empty(2, 2 ** 16, 2 ** 16, **meta)             # batch stride 2**32
    assert x.stride(0) >= 2 ** 31
    with pytest.raises(ValueError, match="no kernel for device meta"):
        matmul_batch(x, torch.empty(2, 2 ** 16, 4, **meta))


def test_matmul_refuses_a_plan_the_kernel_has_not():
    x, y = torch.zeros(4, 40), torch.zeros(40, 5)
    with pytest.raises(ValueError, match="instantiated"):
        matmul(x, y, bm=48)
    with pytest.raises(ValueError, match="instantiated"):
        matmul(x, y, bk=8)
    with pytest.raises(ValueError, match="split_k"):
        matmul(x, y, bk=16, split_k=4)          # 3 steps of 16: a slice idles
    with pytest.raises(ValueError, match="split_k"):
        matmul_batch(x[None], y[None], split_k=0)
    assert torch.equal(matmul(x, y, bk=16, split_k=3), x @ y)


# ---------------------------------------------------------------------------
# matmul launch plans (kernels/matmul/ops.py cta_plan)
# ---------------------------------------------------------------------------

# edge_cnn's GEMMs at b=8 (M, K, N), and resnet18's as per-image GEMMs
EDGE_CNN_GEMMS = [(16, 27, 7200), (32, 144, 6272), (16, 32, 6272), (16, 288, 5408),
                  (32, 288, 4608), (32, 288, 3872), (32, 32, 5408), (48, 288, 800),
                  (48, 432, 512), (64, 48, 512), (64, 432, 288), (64, 1152, 128),
                  (64, 128, 288), (96, 576, 32)]
def smem_bytes(bm, bn, bk):
    """Dynamic shared memory of one CTA of csrc/matmul.cu (mma_tf32.cuh
    ``Tile::kSmemBytes``): 3 stages of A (bm rows of bk + 4 floats) and B
    (bk rows of bn + 8, or + 16 for an 8-wide tile)."""
    return 4 * 3 * (bm * (bk + 4) + bk * (bn + (16 if bn % 32 == 8 else 8)))


PLAN_SHAPES = ([(M, K, N, 1) for M, K, N in EDGE_CNN_GEMMS]
               + [(M, K, N, 8) for M, K, N in [(64, 147, 11881), (128, 1152, 2304),
                                               (256, 2304, 225), (512, 4608, 25),
                                               (512, 4608, 9), (512, 4608, 1)]]
               + [(1, 1, 1, 1), (3, 0, 5, 2), (4096, 4096, 4096, 1), (150, 270, 333, 3)])


@pytest.mark.parametrize("variant", sorted(MM_VARIANTS))
def test_cta_plan_rule(variant):
    """For every key, at edge_cnn's and resnet18's shapes and some edge
    cases: the plan is an instantiated tile that fits shared memory; BM and
    BN are the smallest instantiated sizes covering M and N under the
    ceiling; it fills the SMs (a CTA and WARPS_PER_SM warps on each) or
    splits K one step per slice; every slice is a whole, non-empty run of
    BK steps; no split where the grid fills."""
    cm, ck, cn = MM_TILES[variant]
    for M, K, N, batch in PLAN_SHAPES:
        bm, bn, bk, split = cta_plan(M, N, K, batch, variant)
        assert bm in TILE_M and bn in TILE_N and bk == ck
        assert smem_bytes(bm, bn, bk) <= 232448
        assert bm == min(t for t in TILE_M if t >= min(M, cm))
        assert bn == min(t for t in TILE_N if t >= min(N, cn))
        tiles = -(-M // bm) * -(-N // bn) * batch
        warps = tiles * cta_warps(bm, bn)
        steps = -(-K // bk)
        if (tiles >= SMS and warps >= SMS * WARPS_PER_SM) or steps <= 1:
            assert split == 1
        else:
            assert (tiles * split >= SMS and warps * split >= SMS * WARPS_PER_SM
                    or split == steps)
        per = -(-steps // split)                 # the kernel's slice length
        assert split == 1 or (split - 1) * per < steps <= split * per


def test_cta_plan_keeps_variants_apart_on_large_shapes():
    """Where ceiling tiles fill the card, the plan is the ceiling with no
    split: the keys with distinct ceilings (all but the two whose M block is
    capped to their 256-row twin's) launch distinct kernels."""
    plans = {v: cta_plan(4096, 4096, 4096, 1, v) for v in MM_VARIANTS}
    for v, (bm, bn, bk, split) in plans.items():
        assert (bm, bk, bn) == MM_TILES[v] and split == 1
    assert len(set(plans.values())) == len(set(MM_TILES.values())) == 6
    assert plans["mm-512x128x128"] == plans["mm-256x128x128"]
    assert plans["mm-512x256x256"] == plans["mm-256x256x256"]


def test_cta_plan_splits_the_late_layers():
    """edge_cnn's g1 (64, 1152, 128) and resnet18's last conv (512, 4608, 1
    per image, b=8) give a handful of output tiles: K is split."""
    assert cta_plan(64, 128, 1152, 1, "mm-256x256x256") == (64, 128, 32, 36)
    bm, bn, bk, split = cta_plan(512, 1, 4608, 8, "mm-128x128x128")
    assert (bm, bn, bk) == (64, 8, 16) and split > 1
    assert 512 // bm * 8 * split >= SMS
    assert 512 // bm * 8 * cta_warps(bm, bn) * split >= SMS * WARPS_PER_SM


def test_matmul_tiles_match_the_cuda_instantiations():
    """TILE_M x TILE_N x TILE_K is what csrc/matmul.cu instantiates
    (RT_FOR_EACH_MMA_TILE), so no plan names a tile the launcher refuses."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "matmul.cu").read_text()
    def body(name):            # a macro's definition, continuation lines too
        return re.search(rf"#define {name}\(.*?\)((?:.*\\\n)*.*)", src).group(1)
    bn, bm, bk = body("RT_MMA_BN"), body("RT_MMA_BM"), body("RT_FOR_EACH_MMA_TILE")
    assert tuple(int(v) for v in re.findall(r"X\(BM, (\d+), BK\)", bn)) == TILE_N
    assert tuple(int(v) for v in re.findall(r"RT_MMA_BN\(X, (\d+), BK\)", bm)) == TILE_M
    assert tuple(int(v) for v in re.findall(r"RT_MMA_BM\(X, (\d+)\)", bk)) == TILE_K


def test_winograd_mm_tiles_pinned():
    """mm-* on a Winograd base takes the matmul kernel's ceilings: one table,
    ``kernels/matmul/ops.CTA_TILES``, for both templates; wino-* keep their
    own three ceilings (the TPU (bk, bt) blocks halved, channel depth 16)."""
    from repro_torch.kernels.winograd.ops import ceiling
    assert WINO_MM_TILES is MM_TILES
    assert all(ceiling(v) == MM_TILES[v] for v in MM_VARIANTS)
    assert WINO_TILES == {"wino-128x128": (64, 16, 64), "wino-256x128": (128, 16, 64),
                          "wino-128x256": (64, 16, 128)}
    assert all(ceiling(v) == WINO_TILES[v] for v in WINO_VARIANTS)


# ---------------------------------------------------------------------------
# conv_im2col_batch (reference: kernels/im2col_gemm/im2col_gemm.py:155)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [(2, 4, 16, 8, 3, 1), (3, 4, 19, 8, 3, 2),
                                 (2, 3, 14, 32, 5, 1), (2, 8, 9, 8, 1, 1),
                                 (2, 6, 11, 12, 1, 2)])
def test_conv_im2col_batch_shapes(cfg, rng):
    """f in {1, 3, 5}, stride 1 and 2, against the Pallas kernel."""
    N, C, H, K, f, s = cfg
    x, w = _np(rng, N, C, H, H), _np(rng, K, C, f, f)
    want = jax_conv_batch(jnp.asarray(x), jnp.asarray(w), s, bk=16,
                          interpret=True)
    got = conv_im2col_batch(_t(x), _t(w), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("variant,bias,res,relu", [
    (v, *e) for v, e in zip(itertools.cycle(sorted(CONV_VARIANTS)), EPILOGUES)])
def test_conv_im2col_batch_variants_epilogues(variant, bias, res, relu, rng):
    """Every epilogue combination, cycling through every conv-bk* key,
    against the reference's in-kernel epilogue (``fuse_store=True``)."""
    N, C, H, K, f, s = 2, 5, 9, 12, 3, 2
    oh = (H - f) // s + 1
    x, w = _np(rng, N, C, H, H), _np(rng, K, C, f, f, scale=0.3)
    b = _np(rng, K) if bias else None
    r = _np(rng, N, K, oh, oh) if res else None
    want = jax_conv_batch(jnp.asarray(x), jnp.asarray(w), s, bk=8,
                          bias=_j(b), residual=_j(r), relu=relu,
                          interpret=True, fuse_store=True)
    got = conv_im2col_batch_op(_t(x), _t(w), s, variant=variant, bias=_t(b),
                               residual=_t(r), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


def test_conv_refuses_what_the_kernel_cannot_take():
    """A plan the kernel has not, and any size a C ``int`` or the kernel's
    32-bit offsets cannot hold, are refused on any device (ctypes would wrap
    2**31 + 5 silently); the meta tensors are never launched."""
    x, w = torch.zeros(2, 3, 9, 9), torch.zeros(4, 3, 3, 3)   # R = 27: 2 steps
    with pytest.raises(ValueError, match="instantiated"):
        conv_im2col_batch(x, w, bm=48)
    with pytest.raises(ValueError, match="instantiated"):
        conv_im2col(x[0], w, bn=128)
    with pytest.raises(ValueError, match="split_k"):
        conv_im2col_batch(x, w, split_k=3)
    with pytest.raises(ValueError, match="split_k"):
        conv_im2col(x[0], w, split_k=0)
    assert torch.equal(conv_im2col_batch(x, w, split_k=2), conv_im2col_batch(x, w))
    meta = dict(device="meta")
    big = 2 ** 31 + 5
    cases = [  # (x, w, the value that overflows)
        (torch.empty(1, 1, 1, 1, **meta), torch.empty(big, 1, 1, 1, **meta), "K="),
        (torch.empty(1, 2, 2 ** 15, 2 ** 15, **meta), torch.empty(1, 2, 1, 1, **meta), "x="),
        (torch.empty(2 ** 16, 1, 2 ** 8, 2 ** 8, **meta), torch.empty(1, 1, 1, 1, **meta),
         "pixels="),
        (torch.empty(1, 1, 2 ** 16, 2 ** 14, **meta), torch.empty(2, 1, 1, 1, **meta), "out="),
        (torch.empty(1, 2 ** 16, 4, 4, **meta), torch.empty(2 ** 13, 2 ** 16, 2, 2, **meta),
         "w="),
    ]
    for xm, wm, what in cases:
        with pytest.raises(ValueError, match=f"{what}.*int32"):
            conv_im2col_batch(xm, wm)
        if xm.shape[0] == 1:
            with pytest.raises(ValueError, match=f"{what}.*int32"):
                conv_im2col(xm[0], wm)


# ---------------------------------------------------------------------------
# conv launch plans (kernels/im2col_gemm/ops.py cta_plan)
# ---------------------------------------------------------------------------

# (K_out, C, H, f, s, batch): the served resnet18 / mix and edge_cnn / mix
# convs at b=8, resnet18's 20 convs on one image, and edge cases
CONV_PLAN_SHAPES = (
    [(64, 3, 224, 7, 2, 8), (128, 64, 101, 3, 2, 8), (128, 64, 101, 1, 2, 8),
     (256, 128, 44, 3, 2, 8), (256, 128, 44, 1, 2, 8), (512, 256, 15, 3, 2, 8),
     (512, 256, 15, 1, 2, 8), (16, 32, 28, 1, 1, 8), (32, 32, 26, 1, 1, 8),
     (48, 32, 22, 3, 2, 8), (64, 48, 8, 1, 1, 8), (64, 128, 6, 1, 1, 8)]
    + [(K, C, H, f, s, 1) for C, H, K, f, s in [
        (3, 224, 64, 7, 2), (64, 109, 64, 3, 1), (64, 107, 64, 3, 1),
        (64, 105, 64, 3, 1), (64, 103, 64, 3, 1), (64, 101, 128, 1, 2),
        (64, 101, 128, 3, 2), (128, 50, 128, 3, 1), (128, 48, 128, 3, 1),
        (128, 46, 128, 3, 1), (128, 44, 256, 1, 2), (128, 44, 256, 3, 2),
        (256, 21, 256, 3, 1), (256, 19, 256, 3, 1), (256, 17, 256, 3, 1),
        (256, 15, 512, 1, 2), (256, 15, 512, 3, 2), (512, 7, 512, 3, 1),
        (512, 5, 512, 3, 1), (512, 3, 512, 3, 1)]]
    + [(1, 1, 1, 1, 1, 1), (5, 3, 9, 3, 1, 2), (4096, 64, 300, 3, 1, 8)])


def _gemm_of(K_out, C, H, f, s, batch):
    """(M, N, K) of a conv's implicit GEMM."""
    oh = (H - f) // s + 1
    return K_out, batch * oh * oh, C * f * f


@pytest.mark.parametrize("variant", sorted(CONV_VARIANTS))
def test_conv_cta_plan_rule(variant):
    """For every conv-bk* key, at the served and phase-5 conv shapes and
    some edge cases: the plan is an instantiated conv tile that fits shared
    memory; BM and BN are the smallest instantiated sizes covering the
    output channels and pixels under the ceiling; it fills the SMs (a CTA
    and WARPS_PER_SM warps on each) or splits C*f*f one step per slice;
    every slice is a whole, non-empty run of BK steps; no split where the
    grid fills."""
    cm, ck, cn = CONV_TILES[variant]
    for shape in CONV_PLAN_SHAPES:
        M, N, K = _gemm_of(*shape)
        bm, bn, bk, split = conv_cta_plan(M, N, K, variant)
        assert bm in conv_mod.TILE_M and bn in conv_mod.TILE_N and bk == ck
        assert bk in conv_mod.TILE_K
        assert smem_bytes(bm, bn, bk) <= 232448
        assert bm == min(t for t in conv_mod.TILE_M if t >= min(M, cm))
        assert bn == min(t for t in conv_mod.TILE_N if t >= min(N, cn))
        tiles = -(-M // bm) * -(-N // bn)
        warps = tiles * cta_warps(bm, bn)
        steps = -(-K // bk)
        if (tiles >= SMS and warps >= SMS * WARPS_PER_SM) or steps <= 1:
            assert split == 1
        else:
            assert (tiles * split >= SMS and warps * split >= SMS * WARPS_PER_SM
                    or split == steps)
        per = -(-steps // split)
        assert split == 1 or (split - 1) * per < steps <= split * per


def test_conv_cta_plan_keeps_variants_apart_on_large_shapes():
    """Where ceiling tiles fill the card, the plan is the ceiling with no
    split: conv-bk64 and conv-bk128 launch distinct kernels, conv-bk256 its
    capped 128-row twin's."""
    M, N, K = _gemm_of(512, 128, 58, 3, 1, 8)
    plans = {v: conv_cta_plan(M, N, K, v) for v in CONV_VARIANTS}
    for v, (bm, bn, bk, split) in plans.items():
        assert (bm, bk, bn) == CONV_TILES[v] and split == 1
    assert plans["conv-bk64"] != plans["conv-bk128"] == plans["conv-bk256"]


@pytest.mark.parametrize("im", [3, 5, 7, 9])
def test_conv_cta_plan_splits_the_late_layers(im):
    """resnet18's late layers (512 -> 512, 3x3, R = 4,608) give 4 output
    tiles of N <= 49 pixels on one image and 4-28 at b=8: R is split, in
    whole steps, until the SMs are full."""
    for batch in (1, 8):
        M, N, K = _gemm_of(512, 512, im, 3, 1, batch)
        for variant in CONV_VARIANTS:
            bm, bn, bk, split = conv_cta_plan(M, N, K, variant)
            tiles = -(-M // bm) * -(-N // bn)
            assert split > 1 and tiles * split >= SMS
            assert tiles * cta_warps(bm, bn) * split >= SMS * WARPS_PER_SM
            assert (split - 1) * -(-(K // bk) // split) < K // bk


def test_conv_tiles_match_the_cuda_instantiations():
    """im2col_gemm's TILE_M x TILE_N x TILE_K is what csrc/im2col_gemm.cu
    instantiates (RT_FOR_EACH_CONV_TILE), so no plan names a tile the
    launcher refuses."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "im2col_gemm.cu").read_text()
    def body(name):            # a macro's definition, continuation lines too
        return re.search(rf"#define {name}\(.*?\)((?:.*\\\n)*.*)", src).group(1)
    bn, bm = body("RT_CONV_BN"), body("RT_FOR_EACH_CONV_TILE")
    pairs = re.findall(r"X\(BM, (\d+), (\d+)\)", bn)
    assert tuple(int(n) for n, _ in pairs) == conv_mod.TILE_N
    assert tuple(sorted({int(k) for _, k in pairs})) == conv_mod.TILE_K
    assert tuple(int(v) for v in re.findall(r"RT_CONV_BN\(X, (\d+)\)", bm)) == conv_mod.TILE_M


@pytest.mark.parametrize("sig", [(8, 64, 101, 101, 128, 1, 2), (2, 3, 9, 9, 4, 3, 2),
                                 (1, 2, 10, 11, 3, 2, 3), (1, 1, 8, 8, 1, 3, 3),
                                 (2, 3, 16, 16, 4, 7, 2), (1, 2, 7, 9, 5, 1, 1)])
def test_conv_bound_counts_the_pixels_the_windows_read(sig):
    """chip_smoke.py's conv bound reads each input once: of x, only the
    pixels some window covers (a 1x1 stride-2 conv reads a quarter of x),
    counted here by unfolding a map of pixel indices."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    work = smoke.kernel_table(torch)["conv_im2col_batch"]["work"]
    N, C, H, W, K, f, s = sig
    ids = torch.arange(H * W, dtype=torch.float64).reshape(1, 1, H, W)
    read = torch.unique(torch.nn.functional.unfold(ids, f, stride=s)).numel()
    P = N * ((H - f) // s + 1) * ((W - f) // s + 1)
    for hb, hr, relu in EPILOGUES:
        flops, nbytes = work((*sig, 128, 16, 64, 1, hb and "float32",
                              hr and "float32", relu, "mma.sync", "float32"))
        assert flops == 2 * P * K * C * f * f + P * K * (hb + hr + relu)
        assert nbytes == 4 * (N * C * read + K * C * f * f + P * K * (1 + hr) + K * hb)


# ---------------------------------------------------------------------------
# winograd_point_gemm_batch (reference: kernels/winograd/winograd.py:77)
# ---------------------------------------------------------------------------

def test_winograd_point_gemm_batch(rng):
    u, v = _np(rng, 16, 60, 48), _np(rng, 2, 16, 48, 75)
    want = jax_point_gemm(jnp.asarray(u), jnp.asarray(v), bk=32, bt=32, bc=32,
                          interpret=True)
    got = winograd_point_gemm_batch(_t(u), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


@pytest.mark.parametrize("m,variant", [(2, "wino-128x128"), (2, "wino-256x128"),
                                       (4, "wino-128x256"), (4, "mm-256x128x128")])
def test_winograd_conv_batch(m, variant, rng):
    """The full Winograd conv at m=2 and m=4 (transforms + point-GEMM +
    epilogue) against the reference's, and against the plain conv."""
    x, w = _np(rng, 2, 4, 15, 15), _np(rng, 8, 4, 3, 3)
    b, r = _np(rng, 8), _np(rng, 2, 8, 13, 13)
    want = jax_wino_conv(jnp.asarray(x), jnp.asarray(w), m=m, bias=jnp.asarray(b),
                         residual=jnp.asarray(r), relu=True, interpret=True)
    got = winograd_conv_batch(_t(x), _t(w), m=m, variant=variant, bias=_t(b),
                              residual=_t(r), relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WINO_TOL)
    plain = np.maximum(np.asarray(jax_conv_ref(jnp.asarray(x), jnp.asarray(w), 1))
                       + b[:, None, None] + r, 0.0)
    np.testing.assert_allclose(got.numpy(), plain, **WINO_TOL)


# ---------------------------------------------------------------------------
# Winograd launch plans (kernels/winograd/ops.py cta_plan) and transforms
# ---------------------------------------------------------------------------

def _winograd_signatures(net):
    """(name, C, H, K, m, variant) of every conv the kernel-mix assignment
    routes through a Winograd column on ``net``, H the actual input size."""
    import importlib.util
    from repro_torch.models import cnn_zoo
    from repro_torch.models.cnn_zoo import ConvLayer
    from repro_torch.primitives.conv import REGISTRY, split_tile
    from repro_torch.primitives.plan import producers, spatial_sizes, topo_order
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    zoo = cnn_zoo.get(net)
    asg = smoke.kernel_mix_assignment(zoo)
    size, prods = spatial_sizes(zoo), producers(zoo)
    out = []
    for i in topo_order(zoo):
        node = zoo.nodes[i]
        if not isinstance(node, ConvLayer):
            continue
        base, variant = split_tile(asg[i])
        if REGISTRY[base].family != "wino3":
            continue
        H = size[prods[i][0]] if prods[i] else node.im
        out.append((node.name, node.c, H, node.k,
                    int(REGISTRY[base].traits["tile_m"]), variant))
    return out


@pytest.mark.parametrize("net", ["resnet18", "edge_cnn"])
def test_winograd_cta_plan_rule(net):
    """At every Winograd signature of the net's kernel-mix path, served at
    b=8 and on one image, under its own variant and every other key: the
    plan is an instantiated tile, ``check_plan`` accepts its split, BM and
    BN are the smallest instantiated sizes covering K and T under the
    ceiling, and K, T, C do not fit a C int only if refused."""
    from repro_torch.kernels.common import check_plan
    from repro_torch.kernels.winograd.ops import ceiling
    sigs = _winograd_signatures(net)
    assert {m for *_, m, _ in sigs} == {2, 4}
    assert net != "resnet18" or len(sigs) == 13
    for _, C, H, K, m, variant in sigs:
        th = -(-(H - 2) // m)
        for batch in (8, 1):
            for v in sorted({variant} | set(WINO_VARIANTS) | set(MM_VARIANTS)):
                bm, bn, bk, split = wino_cta_plan(K, th * th, C, batch * (m + 2) ** 2, v)
                cm, ck, cn = ceiling(v)
                assert bk == ck and bk in wino_mod.TILE_K
                assert bm == min(t for t in wino_mod.TILE_M if t >= min(K, cm))
                assert bn == min(t for t in wino_mod.TILE_N if t >= min(th * th, cn))
                check_plan("winograd_point_gemm_batch", C, bm, bk, bn, split,
                           wino_mod.TILE_M, wino_mod.TILE_K, wino_mod.TILE_N)
                assert smem_bytes(bm, bn, bk) <= 232448


def test_winograd_cta_plan_is_the_ceiling_where_the_card_fills():
    """On a shape whose ceiling tiles fill the card (resnet18's stage-1
    layer at b=8, F(2x2): 16 points x 8 images of 64 x 2,809) the plan is
    the ceiling with no split; the 512-channel layers at T = 1 (BN = 8) and
    edge_cnn's last layer on one image split C."""
    from repro_torch.kernels.winograd.ops import ceiling
    for v in sorted(set(WINO_VARIANTS) | set(MM_VARIANTS)):
        bm, bn, bk, split = wino_cta_plan(512, 2809, 512, 8 * 16, v)
        assert (bm, bk, bn) == ceiling(v) and split == 1
    assert wino_cta_plan(64, 2809, 64, 8 * 16, "wino-128x128") == (64, 64, 16, 1)
    assert wino_cta_plan(512, 1, 512, 16, "wino-128x128") == (64, 8, 16, 6)
    assert wino_cta_plan(96, 1, 64, 16, "wino-128x128") == (64, 8, 16, 4)


def test_winograd_tiles_match_the_cuda_instantiations():
    """winograd's TILE_M x TILE_N x TILE_K is what csrc/winograd.cu
    instantiates (RT_FOR_EACH_WINO_TILE), no more tiles than matmul.cu."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "winograd.cu").read_text()
    def body(name):            # a macro's definition, continuation lines too
        return re.search(rf"#define {name}\(.*?\)((?:.*\\\n)*.*)", src).group(1)
    bn, bm, bk = body("RT_WINO_BN"), body("RT_WINO_BM"), body("RT_FOR_EACH_WINO_TILE")
    assert tuple(int(v) for v in re.findall(r"X\(BM, (\d+), BK\)", bn)) == wino_mod.TILE_N
    assert tuple(int(v) for v in re.findall(r"RT_WINO_BN\(X, (\d+), BK\)", bm)) == wino_mod.TILE_M
    assert tuple(int(v) for v in re.findall(r"RT_WINO_BM\(X, (\d+)\)", bk)) == wino_mod.TILE_K
    n_tiles = len(wino_mod.TILE_M) * len(wino_mod.TILE_N) * len(wino_mod.TILE_K)
    assert n_tiles <= len(TILE_M) * len(TILE_N) * len(TILE_K)


def _wino_np(m):
    """(A^T, B^T) of F(mxm, 3x3) as float64 numpy arrays."""
    from repro.primitives.conv import _WINO_SETS as JAX_SETS
    AT, _, BT = JAX_SETS[(m, 3)]
    return np.asarray(AT, np.float64), np.asarray(BT, np.float64)


@pytest.mark.parametrize("m,H,W", [(2, 9, 12), (2, 3, 3), (4, 11, 14), (4, 7, 6)])
def test_winograd_input_transform_per_tile(m, H, W, rng):
    """The plain input transform against B^T d B of each n x n window d at
    stride m, in numpy float64, x zero past its ragged bottom and right
    edges (the reference's pad)."""
    AT, BT = _wino_np(m)
    n = m + 2
    N, C = 2, 3
    x = _np(rng, N, C, H, W)
    th, tw = -(-(H - 2) // m), -(-(W - 2) // m)
    xp = np.zeros((N, C, (th - 1) * m + n, (tw - 1) * m + n))
    xp[:, :, :H, :W] = x
    got = winograd_input_transform(_t(x), m).numpy()
    assert got.shape == (N, n * n, C, th * tw)
    for i, j in itertools.product(range(th), range(tw)):
        d = xp[:, :, i * m:i * m + n, j * m:j * m + n]
        want = np.einsum("ap,ncpq,bq->ncab", BT, d, BT).reshape(N, C, n * n)
        np.testing.assert_allclose(got[:, :, :, i * tw + j], want.transpose(0, 2, 1),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,oh,ow", [(2, 7, 10), (2, 1, 1), (4, 9, 12), (4, 5, 4)])
@pytest.mark.parametrize("bias,res,relu", [(False, False, False), (True, True, True)])
def test_winograd_inverse_transform_per_tile(m, oh, ow, bias, res, relu, rng):
    """The plain inverse transform against A^T M A of each tile in numpy
    float64, cropped at a ragged oh x ow, then bias -> residual -> ReLU."""
    AT, _ = _wino_np(m)
    n = m + 2
    N, K = 2, 3
    th, tw = -(-oh // m), -(-ow // m)
    M = _np(rng, N, n * n, K, th * tw)
    b = _np(rng, K) if bias else None
    r = _np(rng, N, K, oh, ow) if res else None
    got = winograd_inverse_transform(_t(M), m, oh, ow, bias=_t(b), residual=_t(r),
                                     relu=relu).numpy()
    full = np.zeros((N, K, th * m, tw * m))
    for i, j in itertools.product(range(th), range(tw)):
        blk = M[:, :, :, i * tw + j].reshape(N, n, n, K).astype(np.float64)
        full[:, :, i * m:(i + 1) * m, j * m:(j + 1) * m] = np.einsum(
            "ap,npqk,bq->nkab", AT, blk, AT)
    want = full[:, :, :oh, :ow]
    if bias:
        want = want + b[:, None, None]
    if res:
        want = want + r
    if relu:
        want = np.maximum(want, 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_winograd_kernels_refuse_what_they_cannot_take():
    """A plan the point-GEMM has not, an F(mxm) without a kernel, shapes
    that do not match, and sizes past a C int are refused on any device."""
    u, v = torch.zeros(16, 5, 40), torch.zeros(2, 16, 40, 7)
    with pytest.raises(ValueError, match="instantiated"):
        winograd_point_gemm_batch(u, v, bm=48)
    with pytest.raises(ValueError, match="instantiated"):
        winograd_point_gemm(u, v[0], bk=8)
    with pytest.raises(ValueError, match="split_k"):
        winograd_point_gemm_batch(u, v, split_k=4)          # 3 steps of 16
    with pytest.raises(ValueError):
        winograd_point_gemm_batch(u, v[0])
    assert torch.equal(winograd_point_gemm_batch(u, v, split_k=3),
                       winograd_point_gemm_batch(u, v))
    x = torch.zeros(1, 2, 9, 9)
    with pytest.raises(ValueError, match="F\\(3x3"):
        winograd_input_transform(x, 3)
    with pytest.raises(ValueError, match="smaller"):
        winograd_input_transform(torch.zeros(1, 2, 2, 9), 2)
    M = winograd_input_transform(x, 2)                      # (1, 16, 2, 16)
    with pytest.raises(ValueError, match="not F"):
        winograd_inverse_transform(M, 2, 10, 10)
    with pytest.raises(ValueError, match="residual"):
        winograd_inverse_transform(M, 2, 7, 7, residual=torch.zeros(1, 2, 7, 8))
    meta = dict(device="meta")
    big = 2 ** 31 + 5
    with pytest.raises(ValueError, match="int32"):
        winograd_point_gemm_batch(torch.empty(16, big, 1, **meta),
                                  torch.empty(1, 16, 1, 1, **meta))
    with pytest.raises(ValueError, match="threads=.*int32"):
        winograd_input_transform(torch.empty(2 ** 12, 2 ** 12, 34, 34, **meta), 2)
    with pytest.raises(ValueError, match="out=.*int32"):
        winograd_inverse_transform(torch.empty(2 ** 10, 16, 2 ** 10, 1024, **meta),
                                   2, 64, 64)
