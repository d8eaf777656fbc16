"""The port's three kernels against the reference's Pallas kernels.

On the CPU each wrapper computes its plain PyTorch version (its tensors lie
on the CPU), so these tests hold the plain versions — and the wrappers'
shape/tile/epilogue plumbing — to the Pallas kernels run in interpret mode,
on the same numpy inputs. Tolerances are the reference's own: fp32
rtol=atol=1e-4 for the GEMM kernels (``tests/test_kernels.py::_TOL``) and
1e-3 for the full Winograd conv.

``tests/test_torch_gpu.py`` holds each hand-written CUDA kernel to its plain
version on the card.
"""
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
from repro_torch.kernels.im2col_gemm.im2col_gemm import conv_im2col_batch
from repro_torch.kernels.im2col_gemm.ops import CTA_TILES as CONV_TILES
from repro_torch.kernels.im2col_gemm.ops import VARIANTS as CONV_VARIANTS
from repro_torch.kernels.im2col_gemm.ops import conv_im2col_batch_op
from repro_torch.kernels.matmul.matmul import (TILE_K, TILE_M, TILE_N, cta_warps,
                                               matmul, matmul_batch)
from repro_torch.kernels.matmul.ops import CTA_TILES as MM_TILES
from repro_torch.kernels.matmul.ops import SMS, WARPS_PER_SM, cta_plan, matmul_op
from repro_torch.kernels.matmul.ops import VARIANTS as MM_VARIANTS
from repro_torch.kernels.winograd.ops import CTA_TILES as WINO_TILES
from repro_torch.kernels.winograd.ops import MM_CTA_TILES as WINO_MM_TILES
from repro_torch.kernels.winograd.ops import VARIANTS as WINO_VARIANTS
from repro_torch.kernels.winograd.ops import winograd_conv_batch
from repro_torch.kernels.winograd.winograd import winograd_point_gemm_batch

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
    # every key maps to a tile the CUDA launchers instantiate: gemm_tile.cuh's
    # for the conv and Winograd kernels, matmul.cu's for the matmul ceilings
    legal = {(bm, bk, bn) for bm in (64, 128) for bk in (8, 16) for bn in (64, 128)}
    mm_legal = set(itertools.product(TILE_M, TILE_K, TILE_N))
    for table, keys, tiles in ((MM_TILES, MM_VARIANTS, mm_legal),
                               (CONV_TILES, CONV_VARIANTS, legal),
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
    """The Winograd point-GEMM's mm-* tiles are its own (BM, BK, BN) rows,
    independent of the matmul kernel's plan rule."""
    assert WINO_MM_TILES == {
        "mm-128x128x128": (64, 8, 64), "mm-256x128x128": (128, 8, 64),
        "mm-128x128x256": (64, 8, 128), "mm-256x128x256": (128, 8, 128),
        "mm-512x128x128": (128, 8, 64), "mm-128x256x128": (64, 16, 64),
        "mm-256x256x256": (128, 16, 128), "mm-512x256x256": (128, 16, 128)}
    from repro_torch.kernels.winograd.ops import cta_tile
    assert all(cta_tile(v) == WINO_MM_TILES[v] for v in MM_VARIANTS)


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
