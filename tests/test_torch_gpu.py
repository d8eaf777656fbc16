"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at every tile the variant tables name and every epilogue combination
(the bf16 matmul's wgmma route: ``-k wgmma``, every instantiated tile on
ragged shapes, split and not, batched and broadcast, the longest K of the
LM sites, repeats bit for bit, the route rule on the card; its gathered
operands, ``-k gather``: every K and N mod 8, base offsets 0-7, batch
strides off 8, broadcasts packed and not, resnet18's 20 GEMMs; bf16 flash
attention's wgmma route the same way, ``-k flash``, with K and V read at
their own heads on every route; the bf16 implicit-GEMM convs and Winograd
point-GEMMs, ``-k bf16``, every instantiated tile split and not on aligned
and unaligned rows, resnet18's shapes, repeats bit for bit);
the selection path's performance models on the card against the CPU
(``-k select``: predictions at rtol=2e-5, the same assignments); training
and profiling on the card (``-k "train or profile"``: a card fit against
the CPU's, repeatable fits, profiled tile columns through the kernels);
the serving core on the card (``-k serve``: one stream per worker carrying
its kernels, hot_swap publishing after a device sync, the fallback on the
card, a two-worker burst against the kernel-free oracle, a plan selected
from host-CPU measurements served on the card); the process front
end on the card (``-k frontend``: page-locked slabs uploading the same bytes
as a pageable copy, unpinned at stop and pinned again by the next front end,
a kernel error failing a slab batch's tickets and recycling its slab);
the LM decode path on the card (``-k lm``: prefill attention on the flash
kernel, one launch a layer, against the port on the CPU; a failing kernel
raising out of ``prefill``; ``lm_decode.run`` on the card by default; ``-k
families``: the MLA, MoE, SSM, hybrid and encoder-decoder families' prefill
and decode against the CPU, with their flash launches; ``-k families_train``:
a full-width one-layer MoE and SSM training step against the CPU).

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels build at
first use). They carry the ``gpu`` marker and skip where no card is present;
on the card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX, so it runs where only the port is installed.
Tolerance: fp32 rtol=atol=1e-4 on unit-scale operands (sum order only),
1e-3 for a full Winograd conv against the plain convolution.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import itertools
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.flash_attention import TILES as FA_KERNEL_TILES
from repro_torch.kernels.flash_attention.flash_attention import \
    WGMMA_TILES as FA_WGMMA_TILES
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import VARIANTS as FA_VARIANTS
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.im2col_gemm import im2col_gemm as conv_mod
from repro_torch.kernels.im2col_gemm.im2col_gemm import (conv_im2col,
                                                         conv_im2col_batch,
                                                         conv_im2col_batch_plain,
                                                         conv_im2col_plain)
from repro_torch.kernels.im2col_gemm.ops import CTA_TILES as CONV_TILES
from repro_torch.kernels.im2col_gemm.ops import (conv_im2col_batch_op,
                                                 conv_im2col_op)
from repro_torch.kernels.im2col_gemm.ops import cta_plan as conv_cta_plan
from repro_torch.kernels.matmul.matmul import (TILE_K, TILE_K_BF16, TILE_M,
                                               TILE_N, WGMMA_GATHER_A_TILE,
                                               WGMMA_GATHER_TILES,
                                               WGMMA_TILES, matmul,
                                               matmul_batch, matmul_batch_plain,
                                               matmul_plain)
from repro_torch.kernels.matmul.matmul import loaders as matmul_loaders
from repro_torch.kernels.matmul.matmul import packs as matmul_packs
from repro_torch.kernels.matmul.ops import CTA_TILES as MM_TILES
from repro_torch.kernels.matmul.ops import cta_plan, matmul_batch_op, matmul_op
from repro_torch.kernels.winograd import winograd as wino_mod
from repro_torch.kernels.winograd.ops import CTA_TILES as WINO_TILES
from repro_torch.kernels.winograd.ops import cta_plan as wino_cta_plan
from repro_torch.kernels.winograd.ops import winograd_conv, winograd_conv_batch
from repro_torch.kernels.winograd.ref import conv3x3_ref
from repro_torch.kernels.winograd.winograd import (
    winograd_input_transform, winograd_input_transform_plain,
    winograd_inverse_transform, winograd_inverse_transform_plain,
    winograd_point_gemm, winograd_point_gemm_batch,
    winograd_point_gemm_batch_plain, winograd_point_gemm_plain)

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
EPILOGUES = list(itertools.product((False, True), repeat=3))   # bias, res, relu

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cuda_rand(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda")


@pytest.mark.parametrize("variant", sorted(MM_TILES))
def test_gpu_matmul_kernel_vs_plain(variant, cuda):
    gen = torch.Generator().manual_seed(0)
    M, K, N = 150, 270, 333
    x, y = _cuda_rand(gen, M, K, scale=K ** -0.5), _cuda_rand(gen, K, N)
    b, r = _cuda_rand(gen, M), _cuda_rand(gen, M, N)
    before = common.LAUNCHES["matmul"]
    for hb, hr, relu in EPILOGUES:
        ep = dict(bias=b if hb else None, residual=r if hr else None, relu=relu)
        got = matmul_op(x, y, variant=variant, **ep)
        torch.testing.assert_close(got, matmul_plain(x, y, **ep), **GEMM_TOL)
    assert common.LAUNCHES["matmul"] == before + len(EPILOGUES)


@pytest.mark.parametrize("variant", sorted(CONV_TILES))
@pytest.mark.parametrize("cfg", [(2, 3, 32, 16, 3, 1), (3, 8, 19, 20, 3, 2),
                                 (2, 5, 14, 32, 5, 1), (2, 64, 16, 130, 1, 2)])
def test_gpu_conv_kernel_vs_plain(variant, cfg, cuda):
    gen = torch.Generator().manual_seed(0)
    N, C, H, K, f, s = cfg
    oh = (H - f) // s + 1
    x, w = _cuda_rand(gen, N, C, H, H), _cuda_rand(gen, K, C, f, f, scale=(C * f * f) ** -0.5)
    b, r = _cuda_rand(gen, K), _cuda_rand(gen, N, K, oh, oh)
    for hb, hr, relu in EPILOGUES:
        ep = dict(bias=b if hb else None, residual=r if hr else None, relu=relu)
        got = conv_im2col_batch_op(x, w, s, variant=variant, **ep)
        want = conv_im2col_batch_plain(x, w, s, **ep)
        torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("variant", sorted(WINO_TILES) + sorted(MM_TILES))
def test_gpu_point_gemm_kernel_vs_plain(variant, cuda):
    """Each variant's plan at two ragged shapes (K, C, T no multiple of any
    tile; C = 70 takes 4-byte copies of U), and the same tile split."""
    gen = torch.Generator().manual_seed(0)
    for (N, P, K, C, T) in [(2, 16, 60, 48, 75), (3, 36, 130, 70, 9)]:
        u, v = _cuda_rand(gen, P, K, C, scale=C ** -0.5), _cuda_rand(gen, N, P, C, T)
        bm, bn, bk, split = wino_cta_plan(K, T, C, N * P, variant)
        for sk in {split, 2}:
            got = winograd_point_gemm_batch(u, v, bm=bm, bk=bk, bn=bn, split_k=sk)
            torch.testing.assert_close(got, winograd_point_gemm_batch_plain(u, v),
                                       **GEMM_TOL)


@pytest.mark.parametrize("variant", sorted(MM_TILES))
def test_gpu_matmul_batch_kernel_vs_plain(variant, cuda):
    """Every tile and epilogue; x broadcast over the batch (stride 0, read in
    place), then y broadcast, then neither."""
    gen = torch.Generator().manual_seed(0)
    B, M, K, N = 3, 150, 270, 333
    xs, ys = _cuda_rand(gen, M, K, scale=K ** -0.5), _cuda_rand(gen, K, N)
    xb, yb = _cuda_rand(gen, B, M, K, scale=K ** -0.5), _cuda_rand(gen, B, K, N)
    b, r = _cuda_rand(gen, M), _cuda_rand(gen, B, M, N)
    before = common.LAUNCHES["matmul_batch"]
    operands = [(xs.expand(B, M, K), yb), (xb, ys.expand(B, K, N)), (xb, yb)]
    for (x, y), (hb, hr, relu) in zip(operands * 3, EPILOGUES):
        ep = dict(bias=b if hb else None, residual=r if hr else None, relu=relu)
        got = matmul_batch_op(x, y, variant=variant, **ep)
        torch.testing.assert_close(got, matmul_batch_plain(x, y, **ep), **GEMM_TOL)
    assert common.LAUNCHES["matmul_batch"] == before + len(EPILOGUES)


# edge_cnn's GEMMs at b=8 (M, K, N), as the PBQP-selected plan runs them
EDGE_CNN_GEMMS = [(16, 27, 7200), (32, 144, 6272), (16, 32, 6272), (16, 288, 5408),
                  (32, 288, 4608), (32, 288, 3872), (32, 32, 5408), (48, 288, 800),
                  (48, 432, 512), (64, 48, 512), (64, 432, 288), (64, 1152, 128),
                  (64, 128, 288), (96, 576, 32)]


@pytest.mark.parametrize("shape", EDGE_CNN_GEMMS, ids=lambda s: "x".join(map(str, s)))
def test_gpu_matmul_edge_cnn_signatures(shape, cuda):
    """Each edge_cnn GEMM under the two variants PBQP picks for it, with no
    epilogue and with all three fused; one launch count per call."""
    gen = torch.Generator().manual_seed(0)
    M, K, N = shape
    x, y = _cuda_rand(gen, M, K, scale=K ** -0.5), _cuda_rand(gen, K, N)
    b, r = _cuda_rand(gen, M), _cuda_rand(gen, M, N)
    for variant in ("mm-256x256x256", "mm-128x256x128"):
        for ep in (dict(), dict(bias=b, residual=r, relu=True)):
            before = common.LAUNCHES["matmul"]
            got = matmul_op(x, y, variant=variant, **ep)
            assert common.LAUNCHES["matmul"] == before + 1
            torch.testing.assert_close(got, matmul_plain(x, y, **ep), **GEMM_TOL)


@pytest.mark.parametrize("n", [1, 9, 25])
def test_gpu_matmul_batch_split_k_late_layers(n, cuda):
    """resnet18's late layers as b=8 per-image GEMMs (M=512, K=4608, weights
    broadcast): the plan splits K, and every epilogue — residual and ReLU
    above all — is applied once, after the full sum."""
    gen = torch.Generator().manual_seed(0)
    B, M, K = 8, 512, 4608
    w, y = _cuda_rand(gen, M, K, scale=K ** -0.5), _cuda_rand(gen, B, K, n)
    b, r = _cuda_rand(gen, M), _cuda_rand(gen, B, M, n)
    x = w.expand(B, M, K)
    assert cta_plan(M, n, K, B, "mm-128x128x128")[3] > 1
    for hb, hr, relu in EPILOGUES:
        ep = dict(bias=b if hb else None, residual=r if hr else None, relu=relu)
        before = common.LAUNCHES["matmul_batch"]
        got = matmul_batch_op(x, y, **ep)
        assert common.LAUNCHES["matmul_batch"] == before + 1
        torch.testing.assert_close(got, matmul_batch_plain(x, y, **ep), **GEMM_TOL)


@pytest.mark.parametrize("bm", TILE_M)
@pytest.mark.parametrize("bn", TILE_N)
@pytest.mark.parametrize("bk", TILE_K)
def test_gpu_matmul_every_instantiated_tile(bm, bn, bk, cuda):
    """Every tile csrc/matmul.cu instantiates, unsplit and split three ways,
    at a ragged shape with 16-byte rows (K, N % 4 == 0) and with 4-byte
    rows (K = 27 + 16k, N = 4j + 1, 2, 3)."""
    gen = torch.Generator().manual_seed(0)
    for M, K, N in [(150, 272, 332), (150, 155, 333), (37, 91, 334), (21, 75, 335)]:
        x, y = _cuda_rand(gen, M, K, scale=K ** -0.5), _cuda_rand(gen, K, N)
        b, r = _cuda_rand(gen, M), _cuda_rand(gen, M, N)
        for split in (1, 3):
            got = matmul(x, y, bm=bm, bk=bk, bn=bn, split_k=split, bias=b,
                         residual=r, relu=True)
            want = matmul_plain(x, y, bias=b, residual=r, relu=True)
            torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("N", [7200, 7201, 7202, 7203])
def test_gpu_matmul_unaligned_rows(N, cuda):
    """edge_cnn's first conv (K = 27: 4-byte copies of A) at N = 0..3 mod 4
    (4-byte copies of B where N % 4 != 0), single and batched, and a view
    whose rows start off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(0)
    M, K = 16, 27
    x, y = _cuda_rand(gen, M, K, scale=K ** -0.5), _cuda_rand(gen, K, N)
    for variant in sorted(MM_TILES):
        torch.testing.assert_close(matmul_op(x, y, variant=variant),
                                   matmul_plain(x, y), **GEMM_TOL)
    xb, yb = _cuda_rand(gen, 3, 64, 72, scale=72 ** -0.5), _cuda_rand(gen, 3, 72, N)
    torch.testing.assert_close(matmul_batch_op(xb, yb), matmul_batch_plain(xb, yb),
                               **GEMM_TOL)
    flat = _cuda_rand(gen, 1 + 64 * 72)
    xo = flat[1:].view(64, 72)                         # 4-byte aligned only
    yo = _cuda_rand(gen, 72, N)
    torch.testing.assert_close(matmul_op(xo, yo), matmul_plain(xo, yo), **GEMM_TOL)


def test_gpu_matmul_deterministic(cuda):
    """Two calls on the same inputs give bit-identical outputs, with and
    without a split of K."""
    gen = torch.Generator().manual_seed(0)
    x, y = _cuda_rand(gen, 64, 1152, scale=1152 ** -0.5), _cuda_rand(gen, 1152, 128)
    b, r = _cuda_rand(gen, 64), _cuda_rand(gen, 64, 128)
    xb, yb = _cuda_rand(gen, 512, 4608, scale=4608 ** -0.5), _cuda_rand(gen, 8, 4608, 9)
    rb = _cuda_rand(gen, 8, 512, 9)
    calls = [lambda: matmul_op(x, y, "mm-256x256x256", bias=b, residual=r, relu=True),
             lambda: matmul(x, y, bm=64, bk=32, bn=128, bias=b, residual=r),
             lambda: matmul_batch_op(xb.expand(8, 512, 4608), yb, residual=rb,
                                     relu=True)]
    assert cta_plan(64, 128, 1152, 1, "mm-256x256x256")[3] > 1
    for call in calls:
        first, second = call(), call()
        assert torch.equal(first, second)


@pytest.mark.parametrize("variant", sorted(CONV_TILES))
@pytest.mark.parametrize("cfg", [(3, 32, 16, 3, 1), (8, 19, 20, 3, 2),
                                 (5, 14, 32, 5, 1), (64, 16, 130, 1, 2)])
def test_gpu_conv_single_kernel_vs_plain(variant, cfg, cuda):
    gen = torch.Generator().manual_seed(0)
    C, H, K, f, s = cfg
    oh = (H - f) // s + 1
    x, w = _cuda_rand(gen, C, H, H), _cuda_rand(gen, K, C, f, f, scale=(C * f * f) ** -0.5)
    b, r = _cuda_rand(gen, K), _cuda_rand(gen, K, oh, oh)
    before = common.LAUNCHES["conv_im2col"]
    for hb, hr, relu in EPILOGUES:
        ep = dict(bias=b if hb else None, residual=r if hr else None, relu=relu)
        got = conv_im2col_op(x, w, s, variant=variant, **ep)
        torch.testing.assert_close(got, conv_im2col_plain(x, w, s, **ep), **GEMM_TOL)
    assert common.LAUNCHES["conv_im2col"] == before + len(EPILOGUES)


# The conv signatures of the served paths at b=8 under the kernel-mix
# assignment, (N, C, H, K, f, s, variant): resnet18 / mix, then edge_cnn / mix
SERVED_CONVS = [(8, 3, 224, 64, 7, 2, "conv-bk128"), (8, 64, 101, 128, 3, 2, "conv-bk128"),
                (8, 64, 101, 128, 1, 2, "conv-bk64"), (8, 128, 44, 256, 3, 2, "conv-bk128"),
                (8, 128, 44, 256, 1, 2, "conv-bk64"), (8, 256, 15, 512, 3, 2, "conv-bk128"),
                (8, 256, 15, 512, 1, 2, "conv-bk64"),
                (8, 32, 28, 16, 1, 1, "conv-bk64"), (8, 32, 26, 32, 1, 1, "conv-bk64"),
                (8, 32, 22, 48, 3, 2, "conv-bk128"), (8, 48, 8, 64, 1, 1, "conv-bk64"),
                (8, 128, 6, 64, 1, 1, "conv-bk64")]
# resnet18's 20 convs on one 224x224 image (C, H, K, f, s), as phase 5 runs them
RESNET18_CONVS = [(3, 224, 64, 7, 2), (64, 109, 64, 3, 1), (64, 107, 64, 3, 1),
                  (64, 105, 64, 3, 1), (64, 103, 64, 3, 1), (64, 101, 128, 1, 2),
                  (64, 101, 128, 3, 2), (128, 50, 128, 3, 1), (128, 48, 128, 3, 1),
                  (128, 46, 128, 3, 1), (128, 44, 256, 1, 2), (128, 44, 256, 3, 2),
                  (256, 21, 256, 3, 1), (256, 19, 256, 3, 1), (256, 17, 256, 3, 1),
                  (256, 15, 512, 1, 2), (256, 15, 512, 3, 2), (512, 7, 512, 3, 1),
                  (512, 5, 512, 3, 1), (512, 3, 512, 3, 1)]


def _conv_operands(gen, N, C, H, K, f, s):
    """x, w, bias, residual of a conv; N = 0 for one (C, H, H) image."""
    oh = (H - f) // s + 1
    lead = (N,) if N else ()
    x = _cuda_rand(gen, *lead, C, H, H)
    w = _cuda_rand(gen, K, C, f, f, scale=(C * f * f) ** -0.5)
    return x, w, _cuda_rand(gen, K), _cuda_rand(gen, *lead, K, oh, oh)


@pytest.mark.parametrize("sig", SERVED_CONVS, ids=lambda s: "x".join(map(str, s)))
def test_gpu_conv_served_signatures(sig, cuda):
    """Each served conv under its variant's plan, as served (no epilogue)
    and with all three fused; one launch count per call."""
    gen = torch.Generator().manual_seed(0)
    *shape, variant = sig
    x, w, b, r = _conv_operands(gen, *shape)
    s = shape[-1]
    for ep in (dict(), dict(bias=b, residual=r, relu=True)):
        before = common.LAUNCHES["conv_im2col_batch"]
        got = conv_im2col_batch_op(x, w, s, variant=variant, **ep)
        assert common.LAUNCHES["conv_im2col_batch"] == before + 1
        torch.testing.assert_close(got, conv_im2col_batch_plain(x, w, s, **ep),
                                   **GEMM_TOL)


@pytest.mark.parametrize("sig", RESNET18_CONVS, ids=lambda s: "x".join(map(str, s)))
def test_gpu_conv_single_resnet18_signatures(sig, cuda):
    """Each resnet18 conv on one image through ``conv_im2col_op`` with bias,
    residual and ReLU fused, as phase 5 drives it, and with no epilogue."""
    gen = torch.Generator().manual_seed(0)
    x, w, b, r = _conv_operands(gen, 0, *sig)
    s = sig[-1]
    for ep in (dict(bias=b, residual=r, relu=True), dict()):
        before = common.LAUNCHES["conv_im2col"]
        got = conv_im2col_op(x, w, s, **ep)
        assert common.LAUNCHES["conv_im2col"] == before + 1
        torch.testing.assert_close(got, conv_im2col_plain(x, w, s, **ep), **GEMM_TOL)


@pytest.mark.parametrize("sig", [(0, 512, 7, 512, 3, 1), (0, 512, 5, 512, 3, 1),
                                 (0, 512, 3, 512, 3, 1), (8, 256, 15, 512, 3, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gpu_conv_split_k_late_layers(sig, cuda):
    """resnet18's late layers (R = 4,608 on one image) and its 256 -> 512
    stride-2 conv at b=8: the plan splits C*f*f, and every epilogue —
    residual and ReLU above all — is applied once, after the full sum."""
    gen = torch.Generator().manual_seed(0)
    N, C, H, K, f, s = sig
    x, w, b, r = _conv_operands(gen, *sig)
    oh = (H - f) // s + 1
    assert conv_cta_plan(K, max(N, 1) * oh * oh, C * f * f, "conv-bk128")[3] > 1
    op, plain, name = ((conv_im2col_batch_op, conv_im2col_batch_plain, "conv_im2col_batch")
                       if N else (conv_im2col_op, conv_im2col_plain, "conv_im2col"))
    for hb, hr, relu in EPILOGUES:
        ep = dict(bias=b if hb else None, residual=r if hr else None, relu=relu)
        before = common.LAUNCHES[name]
        got = op(x, w, s, **ep)
        assert common.LAUNCHES[name] == before + 1
        torch.testing.assert_close(got, plain(x, w, s, **ep), **GEMM_TOL)


@pytest.mark.parametrize("bm", conv_mod.TILE_M)
@pytest.mark.parametrize("bn", conv_mod.TILE_N)
@pytest.mark.parametrize("bk", conv_mod.TILE_K)
def test_gpu_conv_every_instantiated_tile(bm, bn, bk, cuda):
    """Every tile csrc/im2col_gemm.cu instantiates, unsplit and split (three
    ways, or two where R has two steps), batched and on one image: f in {1, 3, 7}, s in {1, 2}, R = 27 and
    147 (4-byte copies of the weights), R % 4 == 0 (16-byte copies), output
    channels and N*oh*ow pixels no multiple of any tile."""
    gen = torch.Generator().manual_seed(0)
    for sig in [(3, 3, 17, 37, 3, 1), (2, 3, 23, 70, 7, 2), (3, 20, 13, 21, 1, 1),
                (2, 36, 15, 130, 1, 2), (2, 16, 11, 45, 3, 2)]:
        N, C, H, K, f, s = sig
        x, w, b, r = _conv_operands(gen, *sig)
        for split in (1, min(3, -(-C * f * f // bk))):     # R = 20, 27: 2 steps
            ep = dict(bias=b, residual=r, relu=True)
            got = conv_im2col_batch(x, w, s, bm=bm, bk=bk, bn=bn, split_k=split, **ep)
            torch.testing.assert_close(got, conv_im2col_batch_plain(x, w, s, **ep),
                                       **GEMM_TOL)
            ep1 = dict(bias=b, residual=r[0], relu=True)
            got = conv_im2col(x[0], w, s, bm=bm, bk=bk, bn=bn, split_k=split, **ep1)
            torch.testing.assert_close(got, conv_im2col_plain(x[0], w, s, **ep1),
                                       **GEMM_TOL)


def test_gpu_conv_deterministic(cuda):
    """Two calls on the same inputs give bit-identical outputs, split (the
    late layers, conv21 at b=8, a forced split) and unsplit."""
    gen = torch.Generator().manual_seed(0)
    x1, w1, b1, r1 = _conv_operands(gen, 0, 512, 7, 512, 3, 1)
    xb, wb, bb, rb = _conv_operands(gen, 8, 256, 15, 512, 3, 2)
    xs, ws, bs, rs = _conv_operands(gen, 8, 64, 30, 128, 3, 2)
    calls = [lambda: conv_im2col_op(x1, w1, 1, bias=b1, residual=r1, relu=True),
             lambda: conv_im2col_batch_op(xb, wb, 2, residual=rb, relu=True),
             lambda: conv_im2col_batch(xs, ws, 2, bm=64, bk=16, bn=64, split_k=5,
                                       bias=bs, residual=rs),
             lambda: conv_im2col_batch_op(xs, ws, 2, bias=bs)]
    assert conv_cta_plan(512, 25, 4608, "conv-bk128")[3] > 1
    assert conv_cta_plan(512, 8 * 49, 2304, "conv-bk128")[3] > 1
    for call in calls:
        first, second = call(), call()
        assert torch.equal(first, second)


@pytest.mark.parametrize("variant", sorted(WINO_TILES) + sorted(MM_TILES))
def test_gpu_point_gemm_single_kernel_vs_plain(variant, cuda):
    gen = torch.Generator().manual_seed(0)
    for (P, K, C, T) in [(16, 60, 48, 75), (36, 130, 70, 9)]:
        u, v = _cuda_rand(gen, P, K, C, scale=C ** -0.5), _cuda_rand(gen, P, C, T)
        bm, bn, bk, split = wino_cta_plan(K, T, C, P, variant)
        for sk in {split, 2}:
            got = winograd_point_gemm(u, v, bm=bm, bk=bk, bn=bn, split_k=sk)
            torch.testing.assert_close(got, winograd_point_gemm_plain(u, v),
                                       **GEMM_TOL)


# Every conv the kernel-mix assignment routes through Winograd, (C, H, K, m,
# variant), H the actual input size: resnet18's 13 3x3 stride-1 convs, then
# edge_cnn's 9
WINO_CONVS = [(64, 109, 64, 4, "mm-128x128x128"), (64, 107, 64, 2, "wino-128x128"),
              (64, 105, 64, 2, "wino-128x128"), (64, 103, 64, 2, "wino-128x128"),
              (128, 50, 128, 2, "wino-128x128"), (128, 48, 128, 2, "wino-128x128"),
              (128, 46, 128, 2, "wino-128x128"), (256, 21, 256, 2, "wino-128x128"),
              (256, 19, 256, 2, "wino-128x128"), (256, 17, 256, 2, "wino-128x128"),
              (512, 7, 512, 2, "wino-128x128"), (512, 5, 512, 2, "wino-128x128"),
              (512, 3, 512, 2, "wino-128x128"),
              (3, 32, 16, 4, "mm-128x128x128"), (16, 30, 32, 2, "wino-128x128"),
              (32, 28, 16, 2, "wino-128x128"), (32, 26, 32, 2, "wino-128x128"),
              (32, 24, 32, 2, "wino-128x128"), (48, 10, 48, 2, "wino-128x128"),
              (48, 8, 64, 2, "wino-128x128"), (128, 6, 64, 2, "wino-128x128"),
              (64, 4, 96, 2, "wino-128x128")]


@pytest.mark.parametrize("sig", WINO_CONVS, ids=lambda s: "x".join(map(str, s)))
def test_gpu_point_gemm_served_signatures(sig, cuda):
    """Each Winograd conv's point-GEMM under its variant's plan, at b=8
    (batched, as served) and on one image (single, as the entry point runs
    it); one launch count per call."""
    gen = torch.Generator().manual_seed(0)
    C, H, K, m, variant = sig
    P, T = (m + 2) ** 2, wino_mod.tiles_of(H - 2, H - 2, m)[0] ** 2
    u = _cuda_rand(gen, P, K, C, scale=C ** -0.5)
    v = _cuda_rand(gen, 8, P, C, T)
    bm, bn, bk, split = wino_cta_plan(K, T, C, 8 * P, variant)
    before = common.LAUNCHES["winograd_point_gemm_batch"]
    got = winograd_point_gemm_batch(u, v, bm=bm, bk=bk, bn=bn, split_k=split)
    assert common.LAUNCHES["winograd_point_gemm_batch"] == before + 1
    torch.testing.assert_close(got, winograd_point_gemm_batch_plain(u, v), **GEMM_TOL)
    bm, bn, bk, split = wino_cta_plan(K, T, C, P, variant)
    got = winograd_point_gemm(u, v[0], bm=bm, bk=bk, bn=bn, split_k=split)
    torch.testing.assert_close(got, winograd_point_gemm_plain(u, v[0]), **GEMM_TOL)


@pytest.mark.parametrize("bm", wino_mod.TILE_M)
@pytest.mark.parametrize("bn", wino_mod.TILE_N)
@pytest.mark.parametrize("bk", wino_mod.TILE_K)
def test_gpu_point_gemm_every_instantiated_tile(bm, bn, bk, cuda):
    """Every tile csrc/winograd.cu instantiates, unsplit and split, batched
    and on one image: T = 1 with a ragged C (the last layers), odd T with C
    = 70 and C = 3 (4-byte copies of U), and K, C, T % 4 == 0."""
    gen = torch.Generator().manual_seed(0)
    for N, P, K, C, T in [(3, 16, 37, 70, 1), (2, 36, 21, 3, 25), (2, 16, 130, 72, 45),
                          (2, 16, 64, 96, 128)]:
        u, v = _cuda_rand(gen, P, K, C, scale=C ** -0.5), _cuda_rand(gen, N, P, C, T)
        for split in (1, min(3, -(-C // bk))):
            got = winograd_point_gemm_batch(u, v, bm=bm, bk=bk, bn=bn, split_k=split)
            torch.testing.assert_close(got, winograd_point_gemm_batch_plain(u, v),
                                       **GEMM_TOL)
            got = winograd_point_gemm(u, v[1], bm=bm, bk=bk, bn=bn, split_k=split)
            torch.testing.assert_close(got, winograd_point_gemm_plain(u, v[1]),
                                       **GEMM_TOL)


def test_gpu_point_gemm_deterministic(cuda):
    """Two calls on the same inputs give bit-identical outputs, split (the
    512-channel layers on one image, a forced split) and unsplit."""
    gen = torch.Generator().manual_seed(0)
    u = _cuda_rand(gen, 16, 512, 512, scale=512 ** -0.5)
    v1, vb = _cuda_rand(gen, 16, 512, 1), _cuda_rand(gen, 8, 16, 512, 9)
    assert wino_cta_plan(512, 1, 512, 16, "wino-128x128")[3] > 1
    calls = [lambda: winograd_point_gemm(u, v1, bm=64, bk=16, bn=8, split_k=6),
             lambda: winograd_point_gemm_batch(u, vb, bm=64, bk=16, bn=32, split_k=5),
             lambda: winograd_point_gemm_batch(u, vb, bm=128, bk=32, bn=32)]
    for call in calls:
        first, second = call(), call()
        assert torch.equal(first, second)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("shape", [(2, 5, 9, 12), (3, 70, 13, 8), (1, 4, 3, 3),
                                   (8, 64, 109, 109)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gpu_winograd_transforms_vs_plain(m, shape, cuda):
    """Both transform kernels against their plain versions: ragged bottom and
    right edges (H - 2, W - 2 no multiple of m), a single tile, resnet18's
    first stage at b=8; the inverse under every epilogue combination. The
    operands are scaled so that the outputs are unit-scale, as the GEMM
    tests scale theirs: a transform multiplies an element's variance by up
    to the largest squared row norm of its matrix, squared (B^T: 2 at
    F(2x2), 42 at F(4x4); A^T: 3 and 131)."""
    from repro_torch.primitives.conv import _WINO_SETS
    AT, _, BT = _WINO_SETS[(m, 3)]
    gain = lambda a: float((a ** 2).sum(1).max())     # noqa: E731
    gen = torch.Generator().manual_seed(0)
    N, C, H, W = shape
    x = _cuda_rand(gen, N, C, H, W, scale=1 / gain(BT))
    before = common.LAUNCHES["winograd_input_transform"]
    V = winograd_input_transform(x, m)
    assert common.LAUNCHES["winograd_input_transform"] == before + 1
    torch.testing.assert_close(V, winograd_input_transform_plain(x, m), **GEMM_TOL)
    oh, ow = H - 2, W - 2
    K = min(C, 32)
    M = _cuda_rand(gen, N, (m + 2) ** 2, K, V.shape[3], scale=1 / gain(AT))
    b, r = _cuda_rand(gen, K), _cuda_rand(gen, N, K, oh, ow)
    for hb, hr, relu in EPILOGUES:
        ep = dict(bias=b if hb else None, residual=r if hr else None, relu=relu)
        before = common.LAUNCHES["winograd_inverse_transform"]
        got = winograd_inverse_transform(M, m, oh, ow, **ep)
        assert common.LAUNCHES["winograd_inverse_transform"] == before + 1
        torch.testing.assert_close(got, winograd_inverse_transform_plain(M, m, oh, ow, **ep),
                                   **GEMM_TOL)


@pytest.mark.parametrize("m", [2, 4])
def test_gpu_winograd_transforms_as_exact_as_plain(m, cuda):
    """At unit-scale inputs, where F(4x4)'s large matrix entries amplify the
    rounding of any sum order: each transform kernel is no further from the
    float64 result than twice its plain version's distance from it."""
    gen = torch.Generator().manual_seed(0)
    x = _cuda_rand(gen, 4, 16, 37, 29)
    oh, ow = 35, 27
    M = _cuda_rand(gen, 4, (m + 2) ** 2, 16, -(-oh // m) * -(-ow // m))
    pairs = [(winograd_input_transform(x, m), winograd_input_transform_plain(x, m),
              winograd_input_transform_plain(x.double(), m)),
             (winograd_inverse_transform(M, m, oh, ow),
              winograd_inverse_transform_plain(M, m, oh, ow),
              winograd_inverse_transform_plain(M.double(), m, oh, ow))]
    for got, plain, exact in pairs:
        err = (got.double() - exact).abs().max().item()
        assert err <= 2 * (plain.double() - exact).abs().max().item() + 1e-6


WINO_COUNTERS = ("winograd_input_transform", "winograd_inverse_transform")


@pytest.mark.parametrize("m", [2, 4])
def test_gpu_winograd_conv_single_vs_conv(m, cuda):
    """The single-image Winograd conv against ``F.conv2d`` (TF32 off), with
    each of its three kernels launched once."""
    gen = torch.Generator().manual_seed(0)
    x, w = _cuda_rand(gen, 16, 30, 31), _cuda_rand(gen, 24, 16, 3, 3, scale=(16 * 9) ** -0.5)
    names = ("winograd_point_gemm", *WINO_COUNTERS)
    before = {k: common.LAUNCHES[k] for k in names}
    got = winograd_conv(x, w, m=m, variant="wino-128x128")
    assert all(common.LAUNCHES[k] == before[k] + 1 for k in names)
    torch.testing.assert_close(got, conv3x3_ref(x, w), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("variant", sorted(WINO_TILES) + ["mm-256x256x256"])
def test_gpu_winograd_conv_batch_vs_conv(m, variant, cuda):
    """The batched Winograd conv with bias, residual and ReLU against
    ``F.conv2d`` and the same epilogue (TF32 off), C = 70 and a ragged tile
    grid, with each of its three kernels launched once."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(0)
    x, w = _cuda_rand(gen, 3, 70, 17, 23), _cuda_rand(gen, 40, 70, 3, 3, scale=(70 * 9) ** -0.5)
    b, r = _cuda_rand(gen, 40), _cuda_rand(gen, 3, 40, 15, 21)
    names = ("winograd_point_gemm_batch", *WINO_COUNTERS)
    before = {k: common.LAUNCHES[k] for k in names}
    got = winograd_conv_batch(x, w, m=m, variant=variant, bias=b, residual=r, relu=True)
    assert all(common.LAUNCHES[k] == before[k] + 1 for k in names)
    want = torch.relu(F.conv2d(x, w) + b[None, :, None, None] + r)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("tile", FA_KERNEL_TILES)
def test_gpu_flash_attention_kernel_vs_plain(tile, d, cuda):
    """Every CTA tile at every head dim: causal and not, a ragged sequence
    (not a multiple of any tile), and Sq != Sk both ways."""
    gen = torch.Generator().manual_seed(0)
    bq, bkv = tile
    for (bh, sq, sk) in [(3, 256, 256), (2, 200, 200), (2, 96, 160), (2, 160, 96)]:
        q, k, v = (_cuda_rand(gen, bh, s, d) for s in (sq, sk, sk))
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tile", FA_KERNEL_TILES)
def test_gpu_flash_attention_large_scores(tile, causal, cuda):
    """Scores of large magnitude, where the running max moves by many units
    from one KV block to the next and every block rescales the output:
    inputs x4 at the default scale, and unit inputs at scale = 1."""
    gen = torch.Generator().manual_seed(1)
    bq, bkv = tile
    q, k, v = (_cuda_rand(gen, 2, 300, 64) for _ in range(3))
    for scale, x in ((None, 4.0), (1.0, 1.0)):
        got = flash_attention(q * x, k * x, v, causal=causal, scale=scale,
                              bq=bq, bkv=bkv)
        want = flash_attention_plain(q * x, k * x, v, causal=causal, scale=scale)
        torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_attention_as_exact_as_plain(causal, cuda):
    """One head at S = 4,096, d = 128, where P V sums over every key: the
    kernel is no further from the float64 result than twice its plain
    version's distance from it (no drift from the tensor cores' truncating
    adds over the long reduction)."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (_cuda_rand(gen, 1, 4096, 128) for _ in range(3))
    exact = flash_attention_plain(q.double(), k.double(), v.double(), causal=causal)
    plain = flash_attention_plain(q, k, v, causal=causal)
    for bq, bkv in FA_KERNEL_TILES:
        got = flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)
        err = (got.double() - exact).abs().max().item()
        assert err <= 2 * (plain.double() - exact).abs().max().item() + 1e-7


@pytest.mark.parametrize("tile", FA_KERNEL_TILES)
def test_gpu_flash_attention_repeats_bit_for_bit(tile, cuda):
    """No atomics and no split of the KV loop: a call repeats exactly."""
    gen = torch.Generator().manual_seed(3)
    bq, bkv = tile
    q, k, v = (_cuda_rand(gen, 4, 1000, 128) for _ in range(3))
    for causal in (True, False):
        first = flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)
        assert torch.equal(flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv),
                           first)


def test_gpu_flash_attention_refuses_a_misaligned_operand(cuda):
    """The kernel's copies are 16 bytes: an operand that starts elsewhere is
    refused, not read out of line."""
    q = torch.zeros(2 * 64 * 32 + 1, device="cuda")[1:].view(2, 64, 32)
    k = torch.zeros(2, 64, 32, device="cuda")
    with pytest.raises(ValueError):
        flash_attention(q, k, k)


@pytest.mark.parametrize("variant", sorted(FA_VARIANTS))
def test_gpu_flash_attention_op_gqa(variant, cuda):
    gen = torch.Generator().manual_seed(0)
    q = _cuda_rand(gen, 2, 256, 8, 64)
    k, v = _cuda_rand(gen, 2, 256, 2, 64), _cuda_rand(gen, 2, 256, 2, 64)
    before = common.LAUNCHES["flash_attention"]
    got = flash_attention_op(q, k, v, causal=True, variant=variant)
    assert common.LAUNCHES["flash_attention"] == before + 1
    kr, vr = k.repeat_interleave(4, dim=2), v.repeat_interleave(4, dim=2)
    fold = lambda t: t.transpose(1, 2).reshape(16, 256, 64)
    want = flash_attention_plain(fold(q), fold(kr), fold(vr), causal=True)
    torch.testing.assert_close(got, want.reshape(2, 8, 256, 64).transpose(1, 2),
                               **GEMM_TOL)


# ---------------------------------------------------------------------------
# The bf16 kernels: matmul, matmul_batch and flash attention on bf16 operands
# ---------------------------------------------------------------------------

# a whole bf16 model's outputs: the reference's _TOL[bfloat16]
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _bf16_rand(gen, *shape, scale=1.0):
    return _cuda_rand(gen, *shape, scale=scale).to(torch.bfloat16)


def _hold_bf16(got, want32, rows=False):
    """A kernel's bf16 output within one bf16 rounding (2^-8 of |result|,
    half an ulp) of ``want32``, the fp32 result on the same values, plus
    1e-4 of the largest |result| (of its row, the last dim, with ``rows``)
    for the order of the fp32 sums."""
    assert got.dtype == torch.bfloat16 and got.shape == want32.shape
    mag = want32.abs()
    scale = mag.amax(-1, keepdim=True) if rows else mag.max()
    err = (got.float() - want32).abs()
    assert (err <= 2 ** -8 * mag + 1e-4 * scale).all(), float(err.max())


@pytest.mark.parametrize("variant", sorted(MM_TILES))
def test_gpu_matmul_bf16_kernel_vs_plain(variant, cuda):
    """Every variant's bf16 plan and epilogue (bf16 bias and residual), fp32
    and bf16 outputs, at a ragged shape with 16-byte rows (K, N % 8 == 0)
    and one with unaligned rows (K = 27, N odd: the element-wise loader)."""
    gen = torch.Generator().manual_seed(0)
    common.reset_launches()
    for M, K, N in [(150, 272, 336), (150, 27, 333)]:
        x, y = _bf16_rand(gen, M, K, scale=K ** -0.5), _bf16_rand(gen, K, N)
        b, r = _bf16_rand(gen, M), _bf16_rand(gen, M, N)
        for hb, hr, relu in EPILOGUES:
            ep = dict(bias=b if hb else None, residual=r if hr else None, relu=relu)
            want = matmul_plain(x, y, out_dtype=torch.float32, **ep)
            got = matmul_op(x, y, variant=variant, out_dtype=torch.float32, **ep)
            torch.testing.assert_close(got, want, **GEMM_TOL)
            _hold_bf16(matmul_op(x, y, variant=variant, out_dtype=torch.bfloat16,
                                 **ep), want)
    assert common.LAUNCHES["matmul"] == 2 * 2 * len(EPILOGUES)
    assert {sig[-2] for sig in common.SEEN["matmul"]} == {"bfloat16"}


@pytest.mark.parametrize("bm", TILE_M)
@pytest.mark.parametrize("bn", TILE_N)
@pytest.mark.parametrize("bk", TILE_K_BF16)
def test_gpu_matmul_bf16_every_instantiated_tile(bm, bn, bk, cuda):
    """Every bf16 tile, unsplit and split three ways (K long enough that
    each slice owns a step at either depth), aligned and unaligned rows,
    fp32 output held at 1e-4 (exact products, sum order only)."""
    gen = torch.Generator().manual_seed(0)
    for M, K, N in [(150, 272, 336), (37, 331, 334), (21, 363, 335)]:
        x, y = _bf16_rand(gen, M, K, scale=K ** -0.5), _bf16_rand(gen, K, N)
        b, r = _bf16_rand(gen, M), _bf16_rand(gen, M, N)
        for split in (1, 3):
            got = matmul(x, y, bm=bm, bk=bk, bn=bn, split_k=split, bias=b,
                         residual=r, relu=True, out_dtype=torch.float32)
            want = matmul_plain(x, y, bias=b, residual=r, relu=True,
                                out_dtype=torch.float32)
            torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("variant", sorted(MM_TILES))
def test_gpu_matmul_batch_bf16_kernel_vs_plain(variant, cuda):
    """resnet18-like per-image GEMMs in bf16: weights broadcast over the
    batch, odd K and N (the element-wise loader) and 16-byte rows, the full
    epilogue, both output dtypes, and the late layers' split K."""
    gen = torch.Generator().manual_seed(0)
    for B, M, K, N in [(3, 64, 147, 333), (3, 128, 576, 784), (8, 512, 4608, 9)]:
        w = _bf16_rand(gen, M, K, scale=K ** -0.5)
        y, b, r = _bf16_rand(gen, B, K, N), _bf16_rand(gen, M), _bf16_rand(gen, B, M, N)
        x = w.expand(B, M, K)
        ep = dict(bias=b, residual=r, relu=True)
        want = matmul_batch_plain(x, y, out_dtype=torch.float32, **ep)
        torch.testing.assert_close(
            matmul_batch_op(x, y, variant=variant, out_dtype=torch.float32, **ep),
            want, **GEMM_TOL)
        _hold_bf16(matmul_batch_op(x, y, variant=variant, out_dtype=torch.bfloat16,
                                   **ep), want)


def test_gpu_matmul_bf16_deterministic(cuda):
    gen = torch.Generator().manual_seed(0)
    x, y = _bf16_rand(gen, 64, 1152, scale=1152 ** -0.5), _bf16_rand(gen, 1152, 128)
    xb, yb = _bf16_rand(gen, 512, 4608, scale=4608 ** -0.5), _bf16_rand(gen, 8, 4608, 9)
    calls = [lambda: matmul_op(x, y, "mm-256x256x256", relu=True),
             lambda: matmul_batch_op(xb.expand(8, 512, 4608), yb,
                                     out_dtype=torch.float32)]
    assert cta_plan(512, 9, 4608, 8, "mm-128x128x128", torch.bfloat16)[3] > 1
    for call in calls:
        assert torch.equal(call(), call())


@pytest.mark.parametrize("split", [1, 3])
def test_gpu_matmul_bf16_takes_an_fp32_bias_and_residual(split, cuda):
    """bf16 operands with an fp32 bias and residual, and with a bf16 bias
    beside an fp32 residual, unsplit and split, in matmul and matmul_batch:
    the kernel reads each epilogue tensor at its own dtype (fp32 output at
    1e-4 of the plain version, bf16 within one rounding of it), and the
    launch signature names those dtypes."""
    gen = torch.Generator().manual_seed(0)
    M, K, N = 150, 272, 336
    x, y = _bf16_rand(gen, M, K, scale=K ** -0.5), _bf16_rand(gen, K, N)
    b, r = _cuda_rand(gen, M), _cuda_rand(gen, M, N)
    common.reset_launches()
    for bias in (b, b.bfloat16()):
        ep = dict(bias=bias, residual=r, relu=True)
        want = matmul_plain(x, y, out_dtype=torch.float32, **ep)
        got = matmul(x, y, bm=64, bk=32, bn=64, split_k=split,
                     out_dtype=torch.float32, **ep)
        torch.testing.assert_close(got, want, **GEMM_TOL)
        _hold_bf16(matmul(x, y, bm=64, bk=32, bn=64, split_k=split, **ep), want)
        epb = dict(bias=bias, residual=torch.stack([r, r]), relu=True)
        xb, yb = x.expand(2, M, K), torch.stack([y, y])
        got = matmul_batch(xb, yb, bm=64, bk=32, bn=64, split_k=split,
                           out_dtype=torch.float32, **epb)
        torch.testing.assert_close(
            got, matmul_batch_plain(xb, yb, out_dtype=torch.float32, **epb),
            **GEMM_TOL)
    assert {sig[7:9] for sig in common.SEEN["matmul"]} == {
        ("float32", "float32"), ("bfloat16", "float32")}
    assert {sig[10:12] for sig in common.SEEN["matmul_batch"]} == {
        ("float32", "float32"), ("bfloat16", "float32")}


# ---------------------------------------------------------------------------
# The bf16 implicit-GEMM convs and Winograd point-GEMMs
# ---------------------------------------------------------------------------

def _f32(t):
    return None if t is None else t.float()


def _conv_bf16_operands(gen, N, C, H, K, f, s, ep_dtype=torch.bfloat16):
    """bf16 x and w of a conv (N = 0: one image), bias and residual of
    ``ep_dtype``."""
    x, w, b, r = _conv_operands(gen, N, C, H, K, f, s)
    return x.bfloat16(), w.bfloat16(), b.to(ep_dtype), r.to(ep_dtype)


def _split_of(K, bk):
    """The most slices, up to three, a K walk of ``bk`` steps can be split
    into with a step in each (1 where K is one step)."""
    steps = -(-K // bk)
    return next(n for n in (3, 2, 1) if n == 1 or (n - 1) * -(-steps // n) < steps)


def _hold_conv_bf16(call, plain, x, w, s, **ep):
    """``call()`` (bf16) within one bf16 rounding of the plain version's fp32
    result on the same values, and equal to its own repeat bit for bit."""
    got = call()
    ep32 = dict(ep, bias=_f32(ep.get("bias")), residual=_f32(ep.get("residual")))
    _hold_bf16(got, plain(x.float(), w.float(), s, **ep32))
    assert torch.equal(call(), got)


@pytest.mark.parametrize("bm", conv_mod.TILE_M)
@pytest.mark.parametrize("bn", conv_mod.TILE_N)
@pytest.mark.parametrize("bk", conv_mod.TILE_K_BF16)
def test_gpu_conv_bf16_every_instantiated_tile(bm, bn, bk, cuda):
    """Every bf16 tile csrc/im2col_gemm.cu instantiates, unsplit and split
    (three ways, or as many as R's steps allow), batched and on one image, bf16
    bias and residual, ReLU: R = 27 and 147 (element loads of the weights),
    R = 40, 144 and 576 (16-byte copies), R = 36 (unaligned, two steps),
    f in {1, 3, 7}, s in {1, 2}, output channels and N*oh*ow no multiple of
    any tile. Each held within one bf16 rounding of the plain version's
    fp32 result, and each repeat bit for bit."""
    gen = torch.Generator().manual_seed(0)
    for sig in [(3, 3, 17, 37, 3, 1), (2, 3, 23, 70, 7, 2), (3, 40, 13, 21, 1, 1),
                (2, 36, 15, 130, 1, 2), (2, 16, 11, 45, 3, 2), (2, 64, 9, 20, 3, 1)]:
        N, C, H, K, f, s = sig
        x, w, b, r = _conv_bf16_operands(gen, *sig)
        for split in {1, _split_of(C * f * f, bk)}:
            kw = dict(bm=bm, bk=bk, bn=bn, split_k=split)
            ep = dict(bias=b, residual=r, relu=True)
            _hold_conv_bf16(lambda: conv_im2col_batch(x, w, s, **kw, **ep),
                            conv_im2col_batch_plain, x, w, s, **ep)
            ep1 = dict(bias=b, residual=r[0], relu=True)
            _hold_conv_bf16(lambda: conv_im2col(x[0], w, s, **kw, **ep1),
                            conv_im2col_plain, x[0], w, s, **ep1)


@pytest.mark.parametrize("route", ["wgmma", "mma.sync"])
@pytest.mark.parametrize("ep_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sig", RESNET18_CONVS, ids=lambda s: "x".join(map(str, s)))
def test_gpu_conv_bf16_resnet18_signatures(sig, ep_dtype, route, cuda):
    """Each resnet18 conv in bf16 on one image and on b=2 (the late layers
    split R), bias and residual bf16 or fp32, ReLU, on each route: wgmma
    through ``conv_im2col_op`` and ``conv_im2col_batch_op`` (every resnet18
    conv has at least 64 output channels), mma.sync by explicit calls under
    ``cta_plan``'s bf16 plan of the entry points' variant. One launch a
    call, its signature naming the dtypes and the route."""
    gen = torch.Generator().manual_seed(0)
    x, w, b, r = _conv_bf16_operands(gen, 2, *sig, ep_dtype=ep_dtype)
    C, H, K, f, s = sig
    oh = (H - f) // s + 1
    if route == "wgmma":
        batch, one = conv_im2col_batch_op, conv_im2col_op
    else:
        def planned(kern, n):
            bm, bn, bk, split = conv_cta_plan(K, n * oh * oh, C * f * f, "conv-bk128",
                                              torch.bfloat16)
            return lambda *a, **kw: kern(*a, bm=bm, bk=bk, bn=bn, split_k=split,
                                         route="mma.sync", **kw)
        batch, one = planned(conv_im2col_batch, 2), planned(conv_im2col, 1)
    common.reset_launches()
    ep = dict(bias=b, residual=r, relu=True)
    _hold_conv_bf16(lambda: batch(x, w, s, **ep), conv_im2col_batch_plain, x, w, s, **ep)
    ep1 = dict(bias=b, residual=r[0], relu=True)
    _hold_conv_bf16(lambda: one(x[0], w, s, **ep1), conv_im2col_plain, x[0], w, s, **ep1)
    name = common.dtype_name(ep_dtype)
    for k in ("conv_im2col_batch", "conv_im2col"):
        assert common.LAUNCHES[k] == 2
        assert {sig[-5:] for sig in common.SEEN[k]} == {
            (name, name, True, route, "bfloat16")}


@pytest.mark.parametrize("bm", wino_mod.TILE_M)
@pytest.mark.parametrize("bn", wino_mod.TILE_N)
@pytest.mark.parametrize("bk", wino_mod.TILE_K_BF16)
def test_gpu_point_gemm_bf16_every_instantiated_tile(bm, bn, bk, cuda):
    """Every bf16 tile csrc/winograd.cu instantiates, unsplit and split,
    batched and on one image: T = 1 with a ragged C, C = 3, odd T (element
    loads), C and T % 8 == 0 (16-byte copies), and resnet18's T = 27^2 =
    729. Each held within one bf16 rounding of the fp32 product, and each
    repeat bit for bit."""
    gen = torch.Generator().manual_seed(0)
    for N, P, K, C, T in [(3, 16, 37, 70, 1), (2, 16, 21, 3, 25), (2, 16, 130, 72, 45),
                          (2, 16, 64, 96, 128), (2, 16, 64, 128, 729)]:
        u = _bf16_rand(gen, P, K, C, scale=C ** -0.5)
        v = _bf16_rand(gen, N, P, C, T)
        for split in {1, _split_of(C, bk)}:
            kw = dict(bm=bm, bk=bk, bn=bn, split_k=split)
            for call, want in (
                    (lambda: winograd_point_gemm_batch(u, v, **kw), u.float() @ v.float()),
                    (lambda: winograd_point_gemm(u, v[1], **kw), u.float() @ v[1].float())):
                got = call()
                _hold_bf16(got, want)
                assert torch.equal(call(), got)


@pytest.mark.parametrize("sig", WINO_CONVS[:13], ids=lambda s: "x".join(map(str, s)))
def test_gpu_point_gemm_bf16_resnet18_signatures(sig, cuda):
    """Each resnet18 Winograd conv's point-GEMM in bf16 under its variant's
    bf16 plan, at b=8 and on one image, against the fp32 product of the
    same values; one launch a call, its signature ending with bf16."""
    gen = torch.Generator().manual_seed(0)
    C, H, K, m, variant = sig
    P, T = (m + 2) ** 2, wino_mod.tiles_of(H - 2, H - 2, m)[0] ** 2
    u = _bf16_rand(gen, P, K, C, scale=C ** -0.5)
    v = _bf16_rand(gen, 8, P, C, T)
    common.reset_launches()
    bm, bn, bk, split = wino_cta_plan(K, T, C, 8 * P, variant, torch.bfloat16)
    _hold_bf16(winograd_point_gemm_batch(u, v, bm=bm, bk=bk, bn=bn, split_k=split),
               winograd_point_gemm_batch_plain(u.float(), v.float()))
    bm, bn, bk, split = wino_cta_plan(K, T, C, P, variant, torch.bfloat16)
    _hold_bf16(winograd_point_gemm(u, v[0], bm=bm, bk=bk, bn=bn, split_k=split),
               winograd_point_gemm_plain(u.float(), v[0].float()))
    for k in ("winograd_point_gemm_batch", "winograd_point_gemm"):
        assert common.LAUNCHES[k] == 1
        assert {sig[-1] for sig in common.SEEN[k]} == {"bfloat16"}


@pytest.mark.parametrize("m", [2, 4])
def test_gpu_winograd_conv_bf16_transforms_in_fp32(m, cuda):
    """``winograd_conv`` and ``winograd_conv_batch`` on bf16 x, w, bias and
    residual return bf16 within one bf16 rounding (plus 1e-3 of the
    largest value, the fp32 Winograd conv's tolerance) of the plain
    convolution on the same values,
    running the fp32 point-GEMM between the fp32 transforms, as the
    reference does."""
    gen = torch.Generator().manual_seed(0)
    C, H, K = 64, 30, 48
    x, w, b, r = _conv_bf16_operands(gen, 2, C, H, K, 3, 1)
    common.reset_launches()
    ep = dict(bias=b, residual=r, relu=True)
    got = winograd_conv_batch(x, w, m=m, **ep)
    want = conv_im2col_batch_plain(x.float(), w.float(), 1, bias=b.float(),
                                   residual=r.float(), relu=True)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    assert (err <= 2 ** -8 * want.abs() + 1e-3 * want.abs().max()).all()
    got1 = winograd_conv(x[0], w, m=m, bias=b, residual=r[0], relu=True)
    assert got1.dtype == torch.bfloat16
    err = (got1.float() - want[0]).abs()
    assert (err <= 2 ** -8 * want[0].abs() + 1e-3 * want[0].abs().max()).all()
    for k in ("winograd_point_gemm_batch", "winograd_point_gemm"):
        assert {sig[-1] for sig in common.SEEN[k]} == {"float32"}
    assert common.LAUNCHES["winograd_inverse_transform"] == 2


# ---------------------------------------------------------------------------
# The wgmma route of the bf16 matmul (csrc/matmul_wgmma.cu)
# ---------------------------------------------------------------------------

def _wgmma_routes():
    """{kernel: set of routes} of the matmul launches since the last reset."""
    return {k: {sig[-5] for sig in common.SEEN[k]} for k in ("matmul", "matmul_batch")}


def _loaders():
    """{kernel: set of loaders} of the matmul launches since the last reset."""
    return {k: {sig[-3] for sig in common.SEEN[k]} for k in ("matmul", "matmul_batch")}


@pytest.mark.parametrize("tile", WGMMA_TILES, ids=lambda t: "x".join(map(str, t)))
def test_gpu_wgmma_every_tile_vs_plain(tile, cuda):
    """Every wgmma tile on aligned shapes ragged against it (a pair of CTAs
    sharing B, and a single CTA), unsplit and split three ways, bias and
    residual each fp32 and bf16, ReLU: fp32 output at 1e-4 of the plain
    version, bf16 within one rounding of the plain fp32 result."""
    bm, bn, stages = tile
    gen = torch.Generator().manual_seed(0)
    common.reset_launches()
    for M, K, N in [(200, 264, 136), (72, 1032, 392)]:
        x, y = _bf16_rand(gen, M, K, scale=K ** -0.5), _bf16_rand(gen, K, N)
        b, r = _cuda_rand(gen, M), _cuda_rand(gen, M, N)
        for split, ep_dtype in itertools.product((1, 3), (torch.float32, torch.bfloat16)):
            ep = dict(bias=b.to(ep_dtype), residual=r.to(ep_dtype), relu=True)
            plan = dict(bm=bm, bn=bn, stages=stages, split_k=split, route="wgmma")
            want = matmul_plain(x, y, out_dtype=torch.float32, **ep)
            got = matmul(x, y, out_dtype=torch.float32, **plan, **ep)
            torch.testing.assert_close(got, want, **GEMM_TOL)
            _hold_bf16(matmul(x, y, **plan, **ep), want)
    assert _wgmma_routes()["matmul"] == {"wgmma"}


@pytest.mark.parametrize("bcast", ["x", "y", "none"])
@pytest.mark.parametrize("tile", [(128, 256, 4), (64, 128, 8), (128, 128, 3)],
                         ids=lambda t: "x".join(map(str, t)))
def test_gpu_wgmma_batched_and_broadcast(tile, bcast, cuda):
    """matmul_batch on the wgmma route: weights (x) or patches (y) broadcast
    over the batch (read in place through a batch of one), or neither;
    unsplit and split; the full epilogue; both output dtypes."""
    bm, bn, stages = tile
    gen = torch.Generator().manual_seed(1)
    B, M, K, N = 3, 128, 576, 784
    x = (_bf16_rand(gen, M, K, scale=K ** -0.5).expand(B, M, K) if bcast == "x"
         else _bf16_rand(gen, B, M, K, scale=K ** -0.5))
    y = _bf16_rand(gen, K, N).expand(B, K, N) if bcast == "y" else _bf16_rand(gen, B, K, N)
    ep = dict(bias=_bf16_rand(gen, M), residual=_bf16_rand(gen, B, M, N), relu=True)
    want = matmul_batch_plain(x, y, out_dtype=torch.float32, **ep)
    common.reset_launches()
    for split in (1, 3):
        plan = dict(bm=bm, bn=bn, stages=stages, split_k=split, route="wgmma")
        torch.testing.assert_close(
            matmul_batch(x, y, out_dtype=torch.float32, **plan, **ep), want, **GEMM_TOL)
        _hold_bf16(matmul_batch(x, y, **plan, **ep), want)
    assert _wgmma_routes()["matmul_batch"] == {"wgmma"}


@pytest.mark.parametrize("tile", [(128, 256, 4), (128, 128, 4)],
                         ids=lambda t: "x".join(map(str, t)))
def test_gpu_wgmma_longest_site_k(tile, cuda):
    """The longest K of the LM sites (16,384: qwen3's and mixtral's
    (65,536, 16,384, 1,024)) with M cut to 1,024: a 128 x 256 tile sums
    all of K in its accumulator, a 128 x 128 tile promotes every 256 deep;
    both within 1e-4 of the largest |plain| (fp32 output) and within one
    rounding of it (bf16)."""
    bm, bn, stages = tile
    gen = torch.Generator().manual_seed(2)
    M, K, N = 1024, 16384, 1024
    x, y = _bf16_rand(gen, M, K), _bf16_rand(gen, K, N)
    want = matmul_plain(x, y, out_dtype=torch.float32)
    plan = dict(bm=bm, bn=bn, stages=stages, route="wgmma")
    got = matmul(x, y, out_dtype=torch.float32, **plan)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    _hold_bf16(matmul(x, y, **plan), want)


@pytest.mark.parametrize("shape", [(64, 8, 8), (64, 16, 24), (72, 8, 200), (130, 40, 56)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gpu_wgmma_smallest_aligned_shapes(shape, cuda):
    """The smallest calls the route rule sends to wgmma (M = 64, K or N = 8):
    TMA boxes wider and deeper than the operands, zero-filled, under every
    variant's plan (split where the plan splits), both output dtypes."""
    M, K, N = shape
    gen = torch.Generator().manual_seed(5)
    x, y = _bf16_rand(gen, M, K, scale=K ** -0.5), _bf16_rand(gen, K, N)
    ep = dict(bias=_bf16_rand(gen, M), residual=_cuda_rand(gen, M, N), relu=True)
    want = matmul_plain(x, y, out_dtype=torch.float32, **ep)
    common.reset_launches()
    for variant in sorted(MM_TILES):
        torch.testing.assert_close(
            matmul_op(x, y, variant, out_dtype=torch.float32, **ep), want, **GEMM_TOL)
        _hold_bf16(matmul_op(x, y, variant, **ep), want)
    assert _wgmma_routes()["matmul"] == {"wgmma"}


def test_gpu_wgmma_deterministic(cuda):
    """Two identical calls are bit-equal: unsplit, split (the fp32 partials
    added in split order), batched with a broadcast operand."""
    gen = torch.Generator().manual_seed(3)
    x, y = _bf16_rand(gen, 256, 4608, scale=4608 ** -0.5), _bf16_rand(gen, 4608, 256)
    calls = [lambda: matmul_op(x, y, "mm-256x256x256", relu=True),
             lambda: matmul(x, y, bm=64, bn=128, stages=8, split_k=6, route="wgmma",
                            out_dtype=torch.float32),
             lambda: matmul_batch_op(x.expand(4, 256, 4608), torch.stack([y] * 4),
                                     "mm-128x128x256", out_dtype=torch.float32)]
    for call in calls:
        assert torch.equal(call(), call())


def test_gpu_wgmma_route_rule_on_the_card(cuda):
    """matmul_op takes wgmma on aligned bf16 operands (both by TMA) and on a
    view one element off a 16-byte boundary (A gathered), both held to
    plain; M < 64 takes mma.sync, and an explicit wgmma call there raises
    without launching."""
    gen = torch.Generator().manual_seed(4)
    x, y = _bf16_rand(gen, 200, 264, scale=264 ** -0.5), _bf16_rand(gen, 264, 136)
    flat = torch.empty(200 * 264 + 1, dtype=torch.bfloat16, device="cuda")
    xv = flat[1:].view(200, 264)
    xv.copy_(x)
    common.reset_launches()
    want = matmul_plain(x, y, out_dtype=torch.float32)
    torch.testing.assert_close(matmul_op(x, y, out_dtype=torch.float32), want, **GEMM_TOL)
    assert _wgmma_routes()["matmul"] == {"wgmma"} and _loaders()["matmul"] == {"tma/tma"}
    common.reset_launches()
    torch.testing.assert_close(matmul_op(xv, y, out_dtype=torch.float32), want, **GEMM_TOL)
    assert _wgmma_routes()["matmul"] == {"wgmma"} and _loaders()["matmul"] == {"gather/tma"}
    common.reset_launches()
    torch.testing.assert_close(matmul_op(x[:63], y, out_dtype=torch.float32),
                               want[:63], **GEMM_TOL)
    assert _wgmma_routes()["matmul"] == {"mma.sync"}
    with pytest.raises(ValueError, match="wgmma route takes"):
        matmul(x[:63], y, bm=64, bn=64, route="wgmma")
    assert common.LAUNCHES["matmul"] == 1


# ---------------------------------------------------------------------------
# The wgmma route's gathered operands (csrc/matmul_wgmma.cu's
# matmul_gather_kernel): rows TMA cannot address
# ---------------------------------------------------------------------------

def _view(t, off):
    """A copy of ``t`` that starts ``off`` elements into a fresh allocation
    (16-byte aligned), contiguous."""
    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    v = flat[off:].view(t.shape)
    v.copy_(t)
    return v


def _hold_gathered(call, want32, out_dtype):
    """The call's output held to the plain fp32 result (fp32 at 1e-4, bf16
    within one rounding) and bit-equal on a repeat."""
    got = call()
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want32, **GEMM_TOL)
    else:
        _hold_bf16(got, want32)
    assert torch.equal(call(), got)


@pytest.mark.parametrize("r", range(8))
def test_gpu_gather_k_and_n_every_residue(r, cuda):
    """K = 320 + r and N = 136 + 3 r mod 8 (every residue of each over the
    eight cases: A and B gathered), A's gathered tile, unsplit and split
    three ways, bias and residual bf16 or fp32, both output dtypes; r = 0
    is aligned, so its A is a view one element off (A gathered, B by TMA);
    B alone gathered on every tile (A aligned at K = 320)."""
    M, K, N = 200, 320 + r, 136 + 3 * r % 8
    gen = torch.Generator().manual_seed(10 + r)
    x, y = _bf16_rand(gen, M, K, scale=K ** -0.5), _bf16_rand(gen, K, N)
    if r == 0:
        x = _view(x, 1)
    b, res = _cuda_rand(gen, M), _cuda_rand(gen, M, N)
    xa = _bf16_rand(gen, M, 320, scale=320 ** -0.5)         # A by TMA
    ya = _bf16_rand(gen, 320, N)
    calls = [(x, y, WGMMA_GATHER_A_TILE)] + [(xa, ya, t) for t in WGMMA_GATHER_TILES]
    for (xx, yy, (bm, bn, st)), split in itertools.product(calls, (1, 3)):
        common.reset_launches()
        for ep_dtype, out_dtype in ((torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)):
            ep = dict(bias=b.to(ep_dtype), residual=res.to(ep_dtype), relu=True)
            want = matmul_plain(xx, yy, out_dtype=torch.float32, **ep)
            _hold_gathered(lambda: matmul(xx, yy, bm=bm, bn=bn, stages=st, split_k=split,
                                          route="wgmma", out_dtype=out_dtype, **ep),
                           want, out_dtype)
        assert _wgmma_routes()["matmul"] == {"wgmma"}
        want_how = ("tma/tma" if r == 0 else "tma/gather") if xx is xa else (
            "gather/tma" if r == 0 else "gather/gather")
        assert _loaders()["matmul"] == {want_how}


@pytest.mark.parametrize("shape", [(65, 150, 99), (137, 200, 7), (64, 9, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gpu_gather_odd_outputs_split(shape, cuda):
    """M N odd, so each split's fp32 partial starts on an odd element of
    the workspace (its pairs stored element by element where they would
    be off 8 bytes), and N of 7 and 1 (a row of one column): split and
    unsplit, fp32 and bf16 outputs, held to plain and bit-equal on a
    repeat."""
    M, K, N = shape
    gen = torch.Generator().manual_seed(50)
    x, y = _bf16_rand(gen, M, K, scale=K ** -0.5), _bf16_rand(gen, K, N)
    ep = dict(bias=_cuda_rand(gen, M), residual=_bf16_rand(gen, M, N), relu=True)
    want = matmul_plain(x, y, out_dtype=torch.float32, **ep)
    steps = -(-K // 64)
    common.reset_launches()
    for split in sorted({1, min(3, steps), steps}):
        if split > 1 and (split - 1) * -(-steps // split) >= steps:
            continue
        for out_dtype in (torch.float32, torch.bfloat16):
            for bm, bn, st in ({WGMMA_GATHER_A_TILE} if K % 8 else set(WGMMA_GATHER_TILES)):
                _hold_gathered(lambda: matmul(x, y, bm=bm, bn=bn, stages=st, split_k=split,
                                              route="wgmma", out_dtype=out_dtype, **ep),
                               want, out_dtype)
    assert _wgmma_routes()["matmul"] == {"wgmma"}


@pytest.mark.parametrize("off", range(8))
def test_gpu_gather_base_offsets(off, cuda):
    """A, B and the residual each starting ``off`` (B: off + 3, residual:
    off + 5, mod 8) elements into their allocation, rows of K = 150 and N =
    99, so the output's rows start at every offset mod 8 too: the gathered
    loaders, held to plain, bit-equal on a repeat, bf16 and fp32 residual
    and output."""
    M, K, N = 136, 150, 99
    gen = torch.Generator().manual_seed(20 + off)
    x = _view(_bf16_rand(gen, M, K, scale=K ** -0.5), off)
    y = _view(_bf16_rand(gen, K, N), (off + 3) % 8)
    b = _bf16_rand(gen, M)
    common.reset_launches()
    for res_dtype, out_dtype in ((torch.bfloat16, torch.bfloat16),
                                 (torch.float32, torch.float32)):
        res = _view(_cuda_rand(gen, M, N).to(res_dtype), (off + 5) % 8)
        ep = dict(bias=b, residual=res, relu=True)
        want = matmul_plain(x, y, out_dtype=torch.float32, **ep)
        _hold_gathered(lambda: matmul_op(x, y, out_dtype=out_dtype, **ep), want, out_dtype)
    assert _loaders()["matmul"] == {"gather/gather"}


@pytest.mark.parametrize("case", ["a_stride_off_8", "b_stride_off_8", "a_broadcast_packed",
                                  "a_broadcast_wide", "b_broadcast", "none"])
def test_gpu_gather_batched(case, cuda):
    """matmul_batch with gathered operands: a batch stride 4 elements off a
    multiple of 8 (A, then B), A broadcast over the batch with B's short
    rows packed across the entries (N = 9) or not (N = 99), B broadcast,
    neither; every gathered tile, unsplit and split, the full epilogue,
    both output dtypes, each bit-equal on a repeat."""
    B, M, K = 3, 136, 312           # five 64-deep steps: split three ways
    # the stride cases keep the other operand aligned (N = 96, by TMA)
    N = 9 if case == "a_broadcast_packed" else 96 if "stride" in case else 99
    gen = torch.Generator().manual_seed(30)
    if case == "a_stride_off_8":
        flat = _bf16_rand(gen, B * (M * K + 4), scale=K ** -0.5)
        x = flat.as_strided((B, M, K), (M * K + 4, K, 1))
    elif case.startswith("a_broadcast"):
        x = _bf16_rand(gen, M, K, scale=K ** -0.5).expand(B, M, K)
    else:
        x = _bf16_rand(gen, B, M, K, scale=K ** -0.5)
    if case == "b_stride_off_8":
        flat = _bf16_rand(gen, B * (K * N + 4))
        y = flat.as_strided((B, K, N), (K * N + 4, N, 1))
    elif case == "b_broadcast":
        y = _bf16_rand(gen, K, N).expand(B, K, N)
    else:
        y = _bf16_rand(gen, B, K, N)
    ep = dict(bias=_bf16_rand(gen, M), residual=_bf16_rand(gen, B, M, N), relu=True)
    want = matmul_batch_plain(x, y, out_dtype=torch.float32, **ep)
    common.reset_launches()
    how = matmul_loaders(x, y)
    tiles = (WGMMA_GATHER_A_TILE,) if how.startswith("gather") else WGMMA_GATHER_TILES
    for (bm, bn, st), split in itertools.product(tiles, (1, 3)):
        for out_dtype in (torch.float32, torch.bfloat16):
            _hold_gathered(lambda: matmul_batch(x, y, bm=bm, bn=bn, stages=st,
                                                split_k=split, route="wgmma",
                                                out_dtype=out_dtype, **ep),
                           want, out_dtype)
    assert _wgmma_routes()["matmul_batch"] == {"wgmma"}
    assert matmul_loaders(x, y) == ("gather/tma" if case == "a_stride_off_8" else "tma/gather")
    assert matmul_packs(x, y, matmul_loaders(x, y)) == (case == "a_broadcast_packed")


def test_gpu_gather_resnet18_gemms(cuda):
    """resnet18's 20 convs as per-image GEMMs at 224 x 224, b = 2 (the
    shapes of chip_smoke.py's phase 5: weights broadcast, unfolded
    patches, bf16 bias and residual, ReLU) through matmul_batch_op: every
    one on wgmma, 17 with B gathered (conv0 A too), each within one
    rounding of the fp32 result and bit-equal on a repeat."""
    import torch.nn.functional as F
    layers = [(3, 224, 64, 7, 2), (64, 109, 64, 3, 1), (64, 107, 64, 3, 1),
              (64, 105, 64, 3, 1), (64, 103, 64, 3, 1), (64, 101, 128, 1, 2),
              (64, 101, 128, 3, 2), (128, 50, 128, 3, 1), (128, 48, 128, 3, 1),
              (128, 46, 128, 3, 1), (128, 44, 256, 1, 2), (128, 44, 256, 3, 2),
              (256, 21, 256, 3, 1), (256, 19, 256, 3, 1), (256, 17, 256, 3, 1),
              (256, 15, 512, 1, 2), (256, 15, 512, 3, 2), (512, 7, 512, 3, 1),
              (512, 5, 512, 3, 1), (512, 3, 512, 3, 1)]
    gen = torch.Generator().manual_seed(40)
    common.reset_launches()
    for C, H, K, f, s in layers:
        oh = (H - f) // s + 1
        x = _bf16_rand(gen, 2, C, H, H)
        w = _bf16_rand(gen, K, C * f * f, scale=(C * f * f) ** -0.5)
        cols = F.unfold(x, f, stride=s)
        ep = dict(bias=_bf16_rand(gen, K), residual=_bf16_rand(gen, 2, K, oh * oh),
                  relu=True)
        wb = w.expand(2, *w.shape)
        want = matmul_batch_plain(wb, cols, out_dtype=torch.float32, **ep)
        _hold_gathered(lambda: matmul_batch_op(wb, cols, **ep), want, torch.bfloat16)
    assert _wgmma_routes()["matmul_batch"] == {"wgmma"}
    how = [sig[-3] for sig in common.SEEN["matmul_batch"].elements()]
    assert len(how) == 40
    assert sorted(set(how)) == ["gather/gather", "tma/gather", "tma/tma"]
    assert how.count("tma/tma") == 2 * 3 and how.count("gather/gather") == 2 * 1


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("tile", FA_KERNEL_TILES)
def test_gpu_flash_attention_bf16_kernel_vs_plain(tile, d, cuda):
    """Every mma.sync tile and head dim on bf16 q, k, v (causal and not,
    ragged, Sq != Sk), the route named (bf16 at d = 64 and 128 would take
    wgmma by default): a bf16 output within the bf16 tolerance of the plain
    version, and within one bf16 rounding (2^-8 relative) plus 1e-4 of the
    fp32 attention on the same values, so P's two bf16 parts keep it near
    fp32; the launch signature carries the dtype."""
    gen = torch.Generator().manual_seed(0)
    bq, bkv = tile
    common.reset_launches()
    for (bh, sq, sk) in [(3, 256, 256), (2, 200, 200), (2, 96, 160), (2, 160, 96)]:
        q, k, v = (_bf16_rand(gen, bh, s, d) for s in (sq, sk, sk))
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv,
                                  force_route="mma.sync")
            assert got.dtype == torch.bfloat16
            want32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal=causal)
            torch.testing.assert_close(got.float(), want32, rtol=2 ** -8, atol=1e-4)
            _hold_bf16(got, want32, rows=True)
    assert {sig[-1] for sig in common.SEEN["flash_attention"]} == {"bfloat16"}


@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_attention_bf16_long_and_large_scores(causal, cuda):
    """S = 4,096 at d = 128 and scores of large magnitude (inputs x4): the
    mma.sync kernel's bf16 output within one bf16 rounding of the fp32
    attention on the same values, and a call repeats bit for bit."""
    gen = torch.Generator().manual_seed(2)
    for S, x in ((4096, 1.0), (300, 4.0)):
        q, k, v = (_bf16_rand(gen, 1, S, 128, scale=x) for _ in range(3))
        want32 = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        for bq, bkv in FA_KERNEL_TILES:
            got = flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv,
                                  force_route="mma.sync")
            torch.testing.assert_close(got.float(), want32, rtol=2 ** -8, atol=1e-4)
            assert torch.equal(flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv,
                                               force_route="mma.sync"), got)


@pytest.mark.parametrize("variant", sorted(FA_VARIANTS))
def test_gpu_flash_attention_op_bf16_gqa(variant, cuda):
    gen = torch.Generator().manual_seed(0)
    q = _bf16_rand(gen, 2, 256, 8, 64)
    k, v = _bf16_rand(gen, 2, 256, 2, 64), _bf16_rand(gen, 2, 256, 2, 64)
    before = common.LAUNCHES["flash_attention"]
    got = flash_attention_op(q, k, v, causal=True, variant=variant)
    assert common.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16
    kr, vr = k.repeat_interleave(4, dim=2), v.repeat_interleave(4, dim=2)
    fold = lambda t: t.transpose(1, 2).reshape(16, 256, 64)
    want = flash_attention_plain(fold(q).float(), fold(kr).float(),
                                 fold(vr).float(), causal=True)
    _hold_bf16(got, want.reshape(2, 8, 256, 64).transpose(1, 2), rows=True)


# ---------------------------------------------------------------------------
# bf16 flash attention on wgmma (csrc/flash_wgmma.cu), and K / V read in place
# ---------------------------------------------------------------------------

def _flash_routes():
    """{(route, rep)} of the flash launches since the last reset."""
    return {(sig[-3], sig[7]) for sig in common.SEEN["flash_attention"]}


@pytest.mark.parametrize("tile", FA_WGMMA_TILES, ids=lambda t: "x".join(map(str, t)))
def test_gpu_flash_wgmma_every_tile_vs_plain(tile, cuda):
    """Every wgmma tile at its head dim, causal and not, on the ragged
    shapes of the mma.sync test (a length no tile divides, Sq != Sk both
    ways): within one bf16 rounding plus 1e-4 of the fp32 attention on the
    same values, row by row; each call on the wgmma route."""
    gen = torch.Generator().manual_seed(0)
    bq, bkv, d = tile
    common.reset_launches()
    for (bh, sq, sk) in [(3, 256, 256), (2, 200, 200), (2, 96, 160), (2, 160, 96)]:
        q, k, v = (_bf16_rand(gen, bh, s, d) for s in (sq, sk, sk))
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)
            want32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal=causal)
            _hold_bf16(got, want32, rows=True)
    assert _flash_routes() == {("wgmma", 1)}
    assert common.LAUNCHES["flash_attention"] == 8


@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_wgmma_long_and_large_scores(causal, cuda):
    """S = 4,096 at d = 128 (Q K^T over all of d in one wgmma chain, O
    accumulated in place over 4,096 keys) and inputs x4, under every d =
    128 tile: within one bf16 rounding of the fp32 attention, no further
    from the float64 result than twice the plain version, and a repeat bit
    for bit."""
    gen = torch.Generator().manual_seed(2)
    for S, x in ((4096, 1.0), (300, 4.0)):
        q, k, v = (_bf16_rand(gen, 1, S, 128, scale=x) for _ in range(3))
        want32 = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        exact = flash_attention_plain(q.double(), k.double(), v.double(), causal=causal)
        plain = flash_attention_plain(q, k, v, causal=causal)
        bound = 2 * (plain.double() - exact).abs().max().item()
        for bq, bkv, d in FA_WGMMA_TILES:
            if d != 128:
                continue
            got = flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv,
                                  force_route="wgmma")
            _hold_bf16(got, want32, rows=True)
            assert (got.double() - exact).abs().max().item() <= bound
            assert torch.equal(flash_attention(q, k, v, causal=causal, bq=bq,
                                               bkv=bkv, force_route="wgmma"), got)


@pytest.mark.parametrize("rep", [2, 7, 16])
def test_gpu_flash_rep_on_every_route(rep, cuda):
    """K and V of BH / rep heads, query row bh on KV row bh // rep, on the
    wgmma route (bf16 d = 64 and 128), the bf16 mma.sync route and the fp32
    kernel: each against the plain version on K and V repeated to the query
    rows; the signatures carry rep."""
    gen = torch.Generator().manual_seed(rep)
    common.reset_launches()
    for d in (64, 128):
        q = _cuda_rand(gen, 2 * rep, 130, d)
        k, v = _cuda_rand(gen, 2, 150, d), _cuda_rand(gen, 2, 150, d)
        kr, vr = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
        for causal in (True, False):
            want = flash_attention_plain(q, kr, vr, causal=causal)
            got = flash_attention(q, k, v, causal=causal, rep=rep)
            torch.testing.assert_close(got, want, **GEMM_TOL)
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            want32 = flash_attention_plain(qb.float(), kb.float().repeat_interleave(
                rep, 0), vb.float().repeat_interleave(rep, 0), causal=causal)
            for r in ("wgmma", "mma.sync"):
                _hold_bf16(flash_attention(qb, kb, vb, causal=causal, rep=rep, force_route=r),
                           want32, rows=True)
    assert _flash_routes() == {("wgmma", rep), ("mma.sync", rep)}
    assert common.LAUNCHES["flash_attention"] == 12


def test_gpu_flash_wgmma_refuses_a_misaligned_base(cuda):
    """A bf16 operand 2 bytes off a 16-byte boundary is refused before any
    launch: named on the wgmma route, and on the route the rule gives it
    (mma.sync, whose copies are 16 bytes too)."""
    q = torch.zeros(2 * 64 * 64 + 1, device="cuda", dtype=torch.bfloat16)[1:].view(2, 64, 64)
    k = torch.zeros(2, 64, 64, device="cuda", dtype=torch.bfloat16)
    before = dict(common.LAUNCHES)
    for args in ((q, k, k), (k, q, k), (k, k, q)):
        with pytest.raises(ValueError, match="wgmma route takes"):
            flash_attention(*args, force_route="wgmma")
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention(*args)
    assert dict(common.LAUNCHES) == before


def test_gpu_flash_route_of_d32_and_fp32_is_mma_sync(cuda):
    """A bf16 call at d = 32 and an fp32 call at d = 128 run mma.sync; a
    bf16 call at d = 64 and 128 runs wgmma, and flash_attention_op gives
    the kernel K and V with their own heads."""
    from repro_torch.kernels.flash_attention.flash_attention import route
    gen = torch.Generator().manual_seed(4)
    common.reset_launches()
    b32 = _bf16_rand(gen, 2, 64, 32)
    f128 = _cuda_rand(gen, 2, 64, 128)
    assert route(b32, b32, b32) == "mma.sync" and route(f128, f128, f128) == "mma.sync"
    flash_attention(b32, b32, b32)
    flash_attention(f128, f128, f128)
    assert {sig[-3] for sig in common.SEEN["flash_attention"]} == {"mma.sync"}
    for d in (64, 128):
        b = _bf16_rand(gen, 2, 64, d)
        assert route(b, b, b) == "wgmma"
    q = _bf16_rand(gen, 1, 256, 32, 128)
    kv = _bf16_rand(gen, 1, 256, 2, 128)
    common.reset_launches()
    flash_attention_op(q, kv, kv, causal=True)
    (sig,) = common.SEEN["flash_attention"]
    assert sig[:3] == (32, 256, 256) and sig[7:9] == (16, "wgmma")


def test_gpu_bf16_kernels_refuse_fp16_and_the_conv_kernels_bf16(cuda):
    """On the card too: fp16 and mixed dtypes raise before any launch, a
    bf16 conv with fp32 weights among them, and the Winograd transforms
    take fp32 only."""
    h = torch.zeros(16, 32, device="cuda", dtype=torch.float16)
    before = dict(common.LAUNCHES)
    with pytest.raises(TypeError):
        matmul(h, h.T.contiguous())
    with pytest.raises(TypeError):
        matmul(h.bfloat16(), h.T.contiguous().float())
    with pytest.raises(TypeError):
        flash_attention(h[None], h[None], h[None])
    x = torch.zeros(4, 8, 8, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(4, 4, 3, 3, device="cuda")
    for xx, ww in ((x, w), (x.half(), w.half())):
        with pytest.raises(TypeError):
            conv_im2col(xx, ww, 1, bm=16, bn=8)
    with pytest.raises(TypeError):
        winograd_point_gemm(torch.zeros(16, 1, 4, device="cuda", dtype=torch.bfloat16),
                            torch.zeros(16, 4, 9, device="cuda"), bm=16, bn=8)
    with pytest.raises(TypeError):
        winograd_input_transform(x[None], 2)
    assert dict(common.LAUNCHES) == before


# ---------------------------------------------------------------------------
# The selection path: the committed perf models on the card
# ---------------------------------------------------------------------------

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"
SELECT_MODELS = sorted(p.name for p in (ARTIFACTS / "models").iterdir())
SELECT_PRED_TOL = dict(rtol=2e-5, atol=0.0)


def _select_pool(n_outputs):
    from repro_torch.profiler.dataset import (simulate_dlt_dataset,
                                              simulate_primitive_dataset)
    ds = (simulate_primitive_dataset("arm", max_triplets=60) if n_outputs == 49
          else simulate_dlt_dataset("arm"))
    return ds.feats


@pytest.mark.parametrize("name", SELECT_MODELS)
def test_gpu_select_predictions_match_cpu(name, cuda):
    """Every committed model predicts on the card what it predicts on the
    CPU, over the whole arm pool, with TF32 switched on globally around the
    call (prediction runs in plain fp32 regardless)."""
    from repro_torch.core.perfmodel import PerfModel
    path = str(ARTIFACTS / "models" / name / "model.npz")
    card, host = PerfModel.load(path), PerfModel.load(path, device="cpu")
    feats = _select_pool(host.n_outputs)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = card.predict(feats)
    finally:
        torch.set_float32_matmul_precision(prev)
    want = host.predict(feats)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **SELECT_PRED_TOL)
    assert card.fingerprint() == host.fingerprint()


@pytest.fixture
def select_models(cuda):
    from repro_torch.core.perfmodel import PerfModel
    load = lambda n, d: PerfModel.load(str(ARTIFACTS / "models" / n / "model.npz"), d)
    return {d: (load("a84acd505b89b475", d), load("b55b99f51ffb3e50", d))
            for d in ("cuda", "cpu")}


@pytest.mark.parametrize("net", ["alexnet", "edge_cnn", "vgg11", "vgg13", "vgg16",
                                 "vgg19", "resnet18", "resnet34", "resnet50",
                                 "googlenet", "squeezenet", "mobilenet",
                                 "densenet121", "shufflenet_v2", "inception_v3",
                                 "resnet101", "resnet152"])
def test_gpu_select_assignments_match_cpu(net, cuda, select_models):
    """``select`` under the committed arm pair on the card gives the CPU's
    assignment, over all 49 columns and over the runnable ones."""
    from repro_torch.core.selection import ModelProvider, select
    from repro_torch.models import cnn_zoo
    from repro_torch.service.pipeline import _executable_columns
    spec = cnn_zoo.get(net)
    for cols in (None, _executable_columns(select_models["cpu"][0])):
        got = select(spec, ModelProvider(*select_models["cuda"], columns=cols))
        want = select(spec, ModelProvider(*select_models["cpu"], columns=cols))
        assert got.assignment == want.assignment
        assert abs(got.solver_cost - want.solver_cost) <= 1e-5 * want.solver_cost


def test_gpu_select_models_hold_cuda_tensors(cuda, tmp_path):
    """A store on ``cuda`` (the default) warm-loads its models onto the
    card, and ``optimise`` selects with them there."""
    from repro_torch.core.perfmodel import factor_correct
    from repro_torch.service import ArtifactStore, optimise
    shutil.copytree(ARTIFACTS / "models", tmp_path / "models")
    opt = optimise("edge_cnn", "arm", store=ArtifactStore(str(tmp_path)),
                   max_triplets=60, max_iters=2000, executable=True)
    assert opt.warm_models and not opt.warm_selection
    for model in (opt.models.prim, opt.models.dlt):
        assert all(t.is_cuda for layer in model.params for t in layer.values())
        assert model.to("cpu").device.type == "cpu" and model.device.type == "cuda"
    sample = opt.platform.measure_sample(16)
    fixed = factor_correct(opt.models.prim, sample.feats, sample.times)
    assert fixed.device.type == "cuda"


# ---------------------------------------------------------------------------
# Training and profiling on the card
# ---------------------------------------------------------------------------

def _train_surface(seed=1, n=400):
    """The reference test's monomial surface (``tests/test_perfmodel.py``)."""
    rng = np.random.default_rng(seed)
    feats = np.exp(rng.uniform(0, 3, (n, 5)))
    times = np.exp(np.log(feats) @ rng.uniform(0.5, 2.0, (5, 3))) * 1e-6
    times *= np.exp(rng.normal(0, 0.02, times.shape))
    times[rng.random((n, 3)) < 0.1] = np.nan
    return feats, times


def test_gpu_train_fit_matches_cpu_band(cuda):
    """The same nn2 fit (seed, initial parameters, minibatches) on the card
    and on the CPU: both under the reference test's 0.2 and within 1.5x +
    0.02 of each other's MdRAE."""
    from repro_torch.core.perfmodel import fit_perf_model
    f, t = _train_surface()
    args = (f[:300], t[:300], f[300:350], t[300:350])
    card = fit_perf_model("nn2", *args, max_iters=1500, patience=150)
    host = fit_perf_model("nn2", *args, max_iters=1500, patience=150, device="cpu")
    assert card.device.type == "cuda"
    got, want = card.mdrae(f[350:], t[350:]), host.mdrae(f[350:], t[350:])
    assert got < 0.2 and want < 0.2
    assert got <= 1.5 * want + 0.02 and want <= 1.5 * got + 0.02, (got, want)


def test_gpu_train_same_seed_same_fingerprint(cuda):
    """Two same-seed fits on the card are bit for bit the same model: no
    atomics in the forward, backward or update, TF32 off throughout."""
    from repro_torch.core.perfmodel import fit_perf_model
    f, t = _train_surface()
    args = (f[:300], t[:300], f[300:350], t[300:350])
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")     # training ignores it
    try:
        a, b = (fit_perf_model(kind, *args, max_iters=300)
                for kind in ("nn2", "nn2"))
        c, d = (fit_perf_model("nn1", *args, max_iters=100) for _ in range(2))
    finally:
        torch.set_float32_matmul_precision(prev)
    assert a.fingerprint() == b.fingerprint()
    assert c.fingerprint() == d.fingerprint()


def _profile_config(col):
    """One applicable config per tile column, at edge_cnn-like widths."""
    from repro_torch.primitives.conv import resolve
    fam = resolve(col).family
    return {"c1x1": (32, 32, 26, 1, 1), "wino3": (32, 32, 24, 1, 3)}.get(
        fam, (48, 32, 22, 2, 3))


def test_gpu_profile_tile_columns_launch_the_kernels(cuda):
    """Profiling tile columns on the card launches the matmul, the
    implicit-GEMM conv and the Winograd point-GEMM with its transforms;
    every time is finite and positive, device times included."""
    from repro_torch.core.autotune import pallas_columns
    from repro_torch.profiler.device import profile_primitive_batch
    cols = pallas_columns()
    cfgs = sorted({_profile_config(c) for c in cols})
    common.reset_launches()
    t = profile_primitive_batch(cfgs, cols, repeats=3)
    for k in ("matmul", "conv_im2col_batch", "winograd_point_gemm_batch",
              "winograd_input_transform", "winograd_inverse_transform"):
        assert common.LAUNCHES[k] > 0, k
    for k in ("matmul_batch", "conv_im2col", "winograd_point_gemm", "flash_attention"):
        assert common.LAUNCHES[k] == 0, k
    ok = np.isfinite(t.wall)
    assert ok.sum() >= len(cols) and np.array_equal(ok, np.isfinite(t.device))
    assert (t.wall[ok] > 0).all() and (t.device[ok] > 0).all()


def test_gpu_profile_tile_column_output_matches_base(cuda):
    """Every profiled tile column computes its base primitive's output
    within 1e-3 on one config (the kernel route against plain torch)."""
    from repro_torch.core.autotune import pallas_columns
    from repro_torch.primitives.conv import run_primitive, split_tile
    from repro_torch.profiler.device import column_callable
    gen = torch.Generator().manual_seed(0)
    for col in pallas_columns():
        k, c, im, s, f = _profile_config(col)
        x = _cuda_rand(gen, c, im, im)
        w = _cuda_rand(gen, k, c, f, f, scale=(c * f * f) ** -0.5)
        torch.testing.assert_close(column_callable(col, s)(x, w),
                                   run_primitive(split_tile(col)[0], x, w, s),
                                   rtol=1e-3, atol=1e-3)


def test_gpu_profile_platform_persists_on_the_card(cuda, tmp_path):
    """A small GpuPlatform on the card: profiled once into the store, warm
    on a second instance, models trained there, factor calibration from a
    base over plain primitives onto its tile columns."""
    from repro_torch.core.autotune import pallas_columns
    from repro_torch.service import ArtifactStore, GpuPlatform, get_platform
    store = ArtifactStore(str(tmp_path))
    cols = ["im2col-copy-ab-ki", "direct-sum2d"] + pallas_columns()[:6]
    pool = [(16, 3, 32, 1, 3), (32, 16, 30, 1, 3), (32, 32, 26, 1, 1), (48, 32, 22, 2, 3)]
    pairs = [(3, 32), (16, 30), (32, 26), (32, 22), (48, 10), (64, 8)]
    mk = lambda: GpuPlatform(configs=pool, dlt_pairs=pairs, primitives=cols,
                             repeats=3, store=store)
    gpu = mk()
    ds = gpu.primitive_dataset()
    assert np.isfinite(ds.times).any() and ds.platform == "gpu"
    assert gpu.fingerprint().startswith("gpu/r=3/cols=")
    again = mk()
    assert again.primitive_dataset().fingerprint() == ds.fingerprint()
    base = get_platform("arm", max_triplets=4).pretrain("lin", store=store)
    models = again.calibrate(base, 2, mode="factor", store=store)
    assert list(models.prim.columns) == cols and models.dlt.device.type == "cuda"


# ---------------------------------------------------------------------------
# The serving core on the card (-k serve)
# ---------------------------------------------------------------------------

def _smoke():
    import importlib.util
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_net(name="edge_cnn", rule="pbqp"):
    """(opt, weights, chip_smoke): edge_cnn under the PBQP tile assignment
    (the matmul kernel) or the kernel mix, weights on the card."""
    from repro_torch.models import cnn_zoo
    from repro_torch.primitives.executor import make_weights
    from repro_torch.service import OptimisedNetwork
    smoke = _smoke()
    spec = cnn_zoo.get("edge_cnn")
    asg = (smoke.kernel_mix_assignment(spec) if rule == "mix" else
           {i: smoke.EDGE_CNN_PBQP.get(i, "chw") for i in range(len(spec.nodes))})
    opt = OptimisedNetwork.from_assignment(spec, asg, net=name,
                                           predicted_cost_s=1e-3)
    return opt, make_weights(spec, 0, device="cuda"), smoke


def _serve_net(**kw):
    """(server, opt, weights, chip_smoke): edge_cnn / PBQP registered on a
    server on the card."""
    from repro_torch.service import OptimisedServer
    opt, weights, smoke = _card_net()
    server = OptimisedServer(max_batch=8, max_wait_ms=0.0, device="cuda", **kw)
    server.register(opt, weights=weights)
    return server, opt, weights, smoke


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 3, 32, 32)).astype(np.float32)


def test_gpu_serve_workers_launch_on_their_own_streams(cuda, monkeypatch):
    """Each worker slot owns a non-default stream; every kernel a dispatch
    launches goes on the stream of the worker that runs it."""
    from repro_torch.kernels.matmul import matmul as mm_mod
    seen = []
    real = mm_mod.stream_of

    def recording(t):
        s = real(t)
        seen.append((s, torch.cuda.current_stream().cuda_stream))
        return s
    monkeypatch.setattr(mm_mod, "stream_of", recording)
    server, opt, weights, _ = _serve_net(workers=2)
    try:
        streams = server._pool.streams
        handles = {s.cuda_stream for s in streams}
        default = torch.cuda.default_stream().cuda_stream
        assert len(handles) == 2 and default not in handles
        seen.clear()
        outs = server.serve(opt.net, list(_images(16)))
        assert len(outs) == 16 and seen
        assert {s for s, _ in seen} <= handles
        assert all(s == cur for s, cur in seen)
    finally:
        server.stop()


def test_gpu_serve_hot_swap_publishes_after_a_device_sync(cuda, monkeypatch):
    """hot_swap (with and without a canary) synchronises the device after
    the candidate's last work on the swapping thread and before it commits."""
    from repro_torch.service import OptimisedNetwork
    server, opt, weights, smoke = _serve_net(canary_slowdown=1e3)
    syncs = [0]
    real_sync = torch.cuda.synchronize

    def counting(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)
    monkeypatch.setattr(torch.cuda, "synchronize", counting)
    marks = {}
    real_gate, real_commit = server._canary_gate, server._commit_swap_locked

    def gate(*a, **k):
        ok = real_gate(*a, **k)
        marks["canary_done"] = syncs[0]
        return ok

    def commit(*a, **k):
        marks.setdefault("commits", []).append(syncs[0])
        return real_commit(*a, **k)
    server._canary_gate, server._commit_swap_locked = gate, commit
    mix = OptimisedNetwork.from_assignment(
        opt.spec, smoke.kernel_mix_assignment(opt.spec), net=opt.net,
        predicted_cost_s=1e-3)
    before = syncs[0]
    assert server.hot_swap(opt.net, mix, canary=False)
    assert marks["commits"][0] > before
    assert server.hot_swap(opt.net, opt, canary=True)
    assert marks["commits"][1] > marks["canary_done"]
    assert server.stats(opt.net)["generation"] == 2
    assert len(server.serve(opt.net, list(_images(3)))) == 3


def test_gpu_serve_fallback_output_lies_on_cuda(cuda):
    """A persistent fault: every ticket is served degraded by the safe plan
    on the card (its output tensor on cuda), within 1e-3 of the oracle, and
    no hand-written kernel runs for it."""
    from repro_torch.service import Fault, FaultInjector
    server, opt, weights, smoke = _serve_net(
        faults=FaultInjector([Fault("raise", net="edge_cnn")]))
    devices = []
    real = server._fallback_forward

    def spy(*a):
        y = real(*a)
        devices.append(y.device.type)
        return y
    server._fallback_forward = spy
    xs = _images(5, seed=1)
    tickets = [server.submit(opt.net, x) for x in xs]
    common.reset_launches()
    server.pump()
    assert not any(common.LAUNCHES.values())
    assert devices == ["cuda"] * 5
    assert all(t.degraded and t.error is None for t in tickets)
    smoke.check_responses(opt, weights, [xs], [[t.result for t in tickets]])
    st = server.stats(opt.net)
    assert st["fallback_images"] == 5 and st["failures"] == {"fault": 1}


def test_gpu_serve_two_worker_burst_matches_the_oracle(cuda):
    """Two workers, two client threads, edge_cnn / PBQP and the kernel mix:
    every response within 1e-3 of the kernel-free oracle, no failed or
    degraded dispatch, the path's kernels launched."""
    import threading
    server, opt, weights, smoke = _serve_net(workers=2)
    mix, mix_w, _ = _card_net(name="edge_cnn_mix", rule="mix")
    server.register(mix, weights=mix_w)
    xs = _images(48, seed=2)
    tickets = {}

    def client(c):
        for i in range(c, 48, 2):
            net = (opt if i % 2 else mix).net
            tickets[i] = server.submit(net, xs[i])
    common.reset_launches()
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert all(t.wait(60.0) for t in tickets.values())
    finally:
        server.stop()
    want = smoke.routed_kernels(opt.assignment) | smoke.routed_kernels(mix.assignment)
    assert all(common.LAUNCHES[k] > 0 for k in want)
    for o, w, idx in ((opt, weights, range(1, 48, 2)), (mix, mix_w, range(0, 48, 2))):
        smoke.check_responses(o, w, [xs[list(idx)]],
                              [[tickets[i].result for i in idx]])
        st = server.stats(o.net)
        assert st["failed_dispatches"] == 0 and st["fallback_images"] == 0
        assert st["images"] == 24


def test_gpu_serve_broken_kernel_fails_tickets_not_degraded(cuda, monkeypatch):
    """A kernel whose launch fails (its launcher returns a CUDA error):
    register refuses the plan, and a registered plan's dispatch fails its
    tickets with the kernel's error — the safe plan serves none of them."""
    from repro_torch.kernels.common import KernelError
    from repro_torch.kernels.matmul import matmul as mm_mod
    from repro_torch.service import OptimisedServer
    server, opt, weights, _ = _serve_net()
    broken = lambda *a, **k: (lambda *args: 98)   # cudaErrorInvalidDeviceFunction
    monkeypatch.setattr(mm_mod, "bind", broken)
    with pytest.raises(KernelError, match="cudaError 98"):
        OptimisedServer(max_batch=8, device="cuda").register(opt, weights=weights)
    xs = _images(5, seed=3)
    tickets = [server.submit(opt.net, x) for x in xs]
    server.pump()
    assert all(t.error is not None and "cudaError 98" in t.error
               and not t.degraded and t.result is None for t in tickets)
    st = server.stats(opt.net)
    assert st["fallback_images"] == 0 and st["failed_tickets"] == 5
    assert st["failures"] == {"kernel": 1}


def test_gpu_serve_probe_waits_on_its_own_stream(cuda):
    """A probe on one worker's stream while the other worker's stream is
    busy for about a second: the probe waits for its own work only."""
    import threading
    from repro_torch.models.cnn_zoo import ConvLayer
    server, opt, weights, _ = _serve_net(workers=2)
    try:
        busy_stream, probe_stream = server._pool.streams
        i = next(i for i, n in enumerate(opt.spec.nodes)
                 if isinstance(n, ConvLayer) and "@" in opt.assignment[i])
        cfg, col = opt.spec.nodes[i].config, opt.assignment[i]
        took = {}

        def probe():
            with torch.cuda.stream(probe_stream):
                t0 = time.perf_counter()
                took["per_image"] = server._run_probe(opt, cfg, col)
                took["wall"] = time.perf_counter() - t0
        probe()                                  # warm: build, load, allocate
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(busy_stream):
            start.record()
            torch.cuda._sleep(2_000_000_000)     # ~1 s of one busy SM
            end.record()
        t = threading.Thread(target=probe)
        t.start()
        t.join(60.0)
        torch.cuda.synchronize()
        busy_s = start.elapsed_time(end) * 1e-3
        assert busy_s > 0.5, busy_s
        assert 0 < took["per_image"] < 0.1 and took["wall"] < 0.4 * busy_s, took
    finally:
        server.stop()


def test_gpu_serve_host_selected_plan_matches_the_oracle(cuda):
    """``HostPlatform`` measures the CPU because the caller named it; the
    plan selected from its costs (calibrated from a simulated intel model
    trained on the card) serves on the card, every response within 1e-3 of
    the kernel-free oracle, and its base columns launch no kernel."""
    from repro_torch.models import cnn_zoo
    from repro_torch.models.cnn_zoo import ConvLayer
    from repro_torch.primitives.executor import make_weights
    from repro_torch.service import (HostPlatform, OptimisedServer,
                                     get_platform, optimise)
    smoke = _smoke()
    spec = cnn_zoo.get("edge_cnn")
    host = HostPlatform(configs=sorted({n.config for n in spec.nodes
                                        if isinstance(n, ConvLayer)}), repeats=1)
    base = get_platform("intel", max_triplets=5).pretrain(
        max_iters=150, patience=40, device="cuda")
    opt = optimise("edge_cnn", host, base=base, budget=28, executable=True,
                   device="cuda")
    assert opt.models.prim.device.type == "cuda" and opt.models.mode == "factor"
    assert host.primitive_dataset().platform == "host-cpu"
    weights = make_weights(spec, 0, device="cuda")
    server = OptimisedServer(max_batch=8, latency_budget_ms=float("inf"),
                             device="cuda")
    server.register(opt, weights=weights)
    xs = _images(8, seed=4)
    common.reset_launches()
    outs = server.serve(opt.net, list(xs))
    assert not any(common.LAUNCHES.values())
    smoke.check_responses(opt, weights, [xs], [outs])


# ---------------------------------------------------------------------------
# The process front end on the card (-k frontend)
# ---------------------------------------------------------------------------

def _frontend_server(**kw):
    """(server, opt, weights, chip_smoke): edge_cnn / PBQP on a two-worker
    card server with one intake process, the front end started."""
    server, opt, weights, smoke = _serve_net(workers=2, frontend_procs=1,
                                             frontend_slots=2, **kw)
    server.frontend()
    return server, opt, weights, smoke


def test_gpu_frontend_pinned_slab_uploads_the_same_bytes(cuda):
    """A page-locked slab's asynchronous upload brings the same bytes as a
    pageable copy of it, and the ingest path serves them within 1e-3 of
    the kernel-free oracle."""
    server, opt, weights, smoke = _frontend_server()
    try:
        pool = server._frontend._pools[opt.net]
        h = pool.alloc(8)
        slab = pool.view(h)
        slab[:] = _images(8, seed=4)
        assert server._is_pinned(slab) and torch.from_numpy(slab).is_pinned()
        pageable = np.array(slab)
        assert not server._is_pinned(pageable)
        got = torch.from_numpy(slab).to("cuda", non_blocking=True)
        want = torch.from_numpy(pageable).to("cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        pool.free(h)
        xs = _images(8, seed=5)
        tickets = server._frontend.ingest(opt.net, xs)
        assert all(t.wait(60.0) for t in tickets)
        assert all(t.error is None and not t.degraded for t in tickets)
        smoke.check_responses(opt, weights, [xs], [[t.result for t in tickets]])
    finally:
        server.stop()


def test_gpu_frontend_stop_unpins_and_the_next_front_end_pins(cuda):
    server, opt, weights, _ = _frontend_server()
    try:
        first = list(server._pinned)
        pool = server._frontend._pools[opt.net]
        assert first and sorted(first) == sorted(pool.segments())
        view = pool.view(pool.alloc(1))
        server.stop()
        assert server._pinned == [] and server._frontend is None
        assert not torch.from_numpy(view).is_pinned()
        fe = server.frontend()
        assert server._pinned and all(
            torch.from_numpy(p.view(p.alloc(1))).is_pinned()
            for p in fe._pools.values())
        xs = _images(4, seed=6)
        assert all(t.wait(60.0) and t.error is None
                   for t in fe.ingest(opt.net, xs))
    finally:
        server.stop()
    assert server._pinned == []


def test_gpu_frontend_kernel_error_fails_the_slab_batch(cuda, monkeypatch):
    """A slab batch whose kernel launch fails: its tickets fail with the
    kernel's error (never degraded), and its slab goes back to the ring."""
    from repro_torch.kernels.matmul import matmul as mm_mod
    server, opt, weights, _ = _frontend_server()
    try:
        pool = server._frontend._pools[opt.net]
        free = pool.available(8)
        monkeypatch.setattr(mm_mod, "bind",
                            lambda *a, **k: (lambda *args: 98))
        tickets = server._frontend.ingest(opt.net, _images(8, seed=7))
        assert all(t.wait(60.0) for t in tickets)
        assert all(t.error is not None and "cudaError 98" in t.error
                   and not t.degraded and t.result is None for t in tickets)
        deadline = time.time() + 30.0
        while pool.available(8) != free and time.time() < deadline:
            time.sleep(0.01)
        assert pool.available(8) == free
        st = server.stats(opt.net)
        assert st["fallback_images"] == 0 and st["failed_tickets"] == 8
        # the intake's window is 0 ms here: as many batches as arrived apart
        assert st["failures"] == {"kernel": st["failed_dispatches"]}
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The LM decode path: prefill attention on the flash attention kernel
# ---------------------------------------------------------------------------

def _lm_model(head_dim=64):
    """chatglm3_6b reduced with head dim 64 (a dim the kernel instantiates,
    so its prefill attention takes the kernel route), fp32 weights from a
    CPU generator, on the CPU and on the card."""
    import dataclasses
    from repro_torch.configs import base as cb
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(cb.get("chatglm3_6b").reduced(), head_dim=head_dim)
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, cpu, T.map_params(lambda a: a.to("cuda"), cpu)


def test_gpu_lm_prefill_on_the_kernel_matches_cpu(cuda):
    """Prefill (a ragged 45 tokens) launches flash attention once a layer
    and gives the CPU port's logits and cache; two decode steps follow on
    both, within 1e-4."""
    from repro_torch.launch.lm_decode import grow_cache
    from repro_torch.models import transformer as T
    cfg, cpu, card = _lm_model()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 47)))
    before = common.LAUNCHES["flash_attention"]
    got, cache = T.prefill(card, cfg, tokens[:, :45].cuda())
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == before + cfg.n_layers
    want, wcache = T.prefill(cpu, cfg, tokens[:, :45])
    torch.testing.assert_close(got.cpu(), want, **GEMM_TOL)
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name].cpu(), wcache[name], **GEMM_TOL)
    cache, wcache = grow_cache(cache, 2), grow_cache(wcache, 2)
    for i in (45, 46):
        got, cache = T.decode_step(card, cfg, cache, tokens[:, i:i + 1].cuda(), i)
        want, wcache = T.decode_step(cpu, cfg, wcache, tokens[:, i:i + 1], i)
        torch.testing.assert_close(got.cpu(), want, **GEMM_TOL)
    assert common.LAUNCHES["flash_attention"] == before + cfg.n_layers


def test_gpu_lm_failing_kernel_raises_out_of_prefill(cuda, monkeypatch):
    """A flash attention launch that fails (its launcher returns a CUDA
    error) raises KernelError out of prefill; nothing computes the
    attention another way (the plain version would raise here)."""
    from repro_torch.kernels.common import KernelError
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.models import transformer as T
    cfg, _, card = _lm_model()
    monkeypatch.setattr(fa_mod, "bind", lambda *a, **k: (lambda *args: 98))
    monkeypatch.setattr(fa_mod, "flash_attention_plain",
                        lambda *a, **k: pytest.fail("plain attention ran"))
    before = common.LAUNCHES["flash_attention"]
    with pytest.raises(KernelError, match="cudaError 98"):
        T.prefill(card, cfg, torch.zeros((2, 16), dtype=torch.long, device="cuda"))
    assert common.LAUNCHES["flash_attention"] == before


def test_gpu_lm_decode_run_defaults_to_the_card(cuda):
    """``lm_decode.run`` with no device runs on cuda, its prefill on the
    kernel."""
    from repro_torch.launch import lm_decode
    cfg, _, card = _lm_model()
    before = common.LAUNCHES["flash_attention"]
    r = lm_decode.run(cfg, 2, 16, 4, params=card)
    assert r.tokens.is_cuda and r.tokens.shape == (2, 4)
    assert common.LAUNCHES["flash_attention"] == before + cfg.n_layers


def test_gpu_lm_bf16_prefill_runs_the_kernel_in_bf16(cuda, monkeypatch):
    """A bf16 prefill sends bf16 q, k and v to the kernel (the launch
    signature's dtype), once a layer, and its logits are those of the same
    bf16 prefill on the card with the route off (the plain bf16 attention)
    within the bf16 tolerance."""
    import dataclasses
    from repro_torch.models import components as C
    from repro_torch.models import transformer as T
    cfg, cpu, _ = _lm_model()
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    card = T.map_params(lambda a: a.to("cuda", torch.bfloat16)
                        if a.is_floating_point() else a.to("cuda"), cpu)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 45)))
    common.reset_launches()
    got, _ = T.prefill(card, cfg, tokens.cuda())
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == cfg.n_layers
    assert {sig[-1] for sig in common.SEEN["flash_attention"]} == {"bfloat16"}
    monkeypatch.setattr(C, "flash_routed", lambda *a, **k: False)
    want, _ = T.prefill(card, cfg, tokens.cuda())
    assert common.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


# ---------------------------------------------------------------------------
# The LM families' serving path on the card
# ---------------------------------------------------------------------------

# each family's reduced config at its registered head dim, cut to 2 layers
# (zamba2: 2 groups); flash attention launches a prefill: one a routed
# self-attention layer (MoE at head dim 128; Whisper's 2 encoder and 2
# decoder layers at 64), none for MLA, SSM and zamba2's head dim 80
FAMILY_FLASH = {"minicpm3_4b": 0, "mixtral_8x7b": 2, "qwen3_moe_30b_a3b": 2,
                "mamba2_2_7b": 0, "zamba2_2_7b": 0, "whisper_medium": 4}


@pytest.mark.parametrize("arch", sorted(FAMILY_FLASH))
def test_gpu_lm_families_card_matches_cpu(arch, cuda):
    """Prefill 16 tokens (Whisper over 16 frames) on the card with its
    flash launches, then two decode steps launching nothing: logits and
    every cache leaf within 1e-4 of the port on the CPU, and for MoE the
    same expert choices."""
    import dataclasses
    from repro_torch.configs import base as cb
    from repro_torch.launch.lm_decode import grow_cache
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    full = cb.get(arch)
    red = full.reduced()
    cfg = dataclasses.replace(red, n_layers=2 * (red.hybrid_attn_every or 1),
                              head_dim=full.head_dim or red.head_dim)
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg)
    card = T.map_params(lambda a: a.to("cuda"), cpu)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 18)))
    enc = (torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
           if cfg.kind == "encdec" else None)
    card_enc = None if enc is None else enc.cuda()
    before = common.LAUNCHES["flash_attention"]
    got, cache = T.prefill(card, cfg, tokens[:, :16].cuda(), enc_embeds=card_enc)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == before + FAMILY_FLASH[arch]
    want, wcache = T.prefill(cpu, cfg, tokens[:, :16], enc_embeds=enc)
    torch.testing.assert_close(got.cpu(), want, **GEMM_TOL)
    assert sorted(cache) == sorted(wcache)
    for name in cache:
        torch.testing.assert_close(cache[name].cpu(), wcache[name], **GEMM_TOL)
    cache, wcache = grow_cache(cache, 2), grow_cache(wcache, 2)
    for i in (16, 17):
        got, cache = T.decode_step(card, cfg, cache, tokens[:, i:i + 1].cuda(), i)
        want, wcache = T.decode_step(cpu, cfg, wcache, tokens[:, i:i + 1], i)
        torch.testing.assert_close(got.cpu(), want, **GEMM_TOL)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == before + FAMILY_FLASH[arch]
    if cfg.moe is not None:
        x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(2))
        layer = T.map_params(lambda a: a[0], card["layers"])["moe"]
        idx = M._route(layer, x.cuda(), cfg.moe)[0]
        want_idx = M._route(T.map_params(lambda a: a[0], cpu["layers"])["moe"], x,
                            cfg.moe)[0]
        assert torch.equal(idx.cpu(), want_idx)


# ---------------------------------------------------------------------------
# The LM training path on the card
# ---------------------------------------------------------------------------

def _full_width_cut(dtype=torch.float32):
    """chatglm3_6b at full width cut to 1 layer, its weights from a seeded
    generator on the card."""
    import dataclasses
    from repro_torch.configs import base as cb
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(cb.get("chatglm3_6b"), n_layers=1, param_dtype=dtype)
    return cfg, T.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)


def test_gpu_lm_train_step_full_width_matches_cpu(cuda):
    """One train step of chatglm3_6b at full width (1 layer, fp32, TF32
    off, B=1, S=256) on the card and on the CPU port, held as
    ``chip_smoke.py`` phase 11 (a) holds it: the loss within 1e-3, each
    gradient leaf within 1e-4 of its own max |g|, and each parameter's step
    under AdamW (``optimizer_for``) and Adafactor from the CPU's gradients
    within 1e-2 lr; every attention gradient nonzero; ``make_train_step``
    on the card launches no flash attention (its kernel has no backward)."""
    from repro_torch.data.lm import make_batch
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.train import optim
    smoke = _smoke()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, card = _full_width_cut()
        cpu = T.map_params(lambda a: a.to("cpu"), card)
        batch, hbatch = (make_batch(cfg, 1, 256, 1, device=d) for d in ("cuda", "cpu"))
        before = common.LAUNCHES["flash_attention"]
        _, grads = ST.value_and_grad(card, cfg, batch)
        wloss, wgrads = ST.value_and_grad(cpu, cfg, hbatch)
        assert all(bool((g != 0).any()) for g in optim.tree_leaves(grads["layers"]["attn"]))
        assert smoke.train_grad_err(grads, wgrads) <= smoke.TRAIN_GRAD_RTOL
        del grads
        shared = optim.tree_map(lambda g: g.cuda(), wgrads)
        errs = {}
        for name, opt in (("adamw", ST.optimizer_for(cfg)[1]),
                          ("adafactor", optim.make_optimizer("adafactor", ST.DEFAULT_LR))):
            got, _ = opt.update(card, shared, opt.init(card))
            want, _ = opt.update(cpu, wgrads, opt.init(cpu))
            errs[name] = smoke.train_step_err(card, got, cpu, want, ST.DEFAULT_LR)
            del got, want
        del shared
        _, opt = ST.optimizer_for(cfg)
        stepped, _, loss = ST.make_train_step(cfg, opt)(card, opt.init(card), batch)
        torch.cuda.synchronize()
        assert common.LAUNCHES["flash_attention"] == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert abs(float(loss) - float(wloss)) <= smoke.TRAIN_CPU_TOL
    assert all(bool(p.isfinite().all()) for p in optim.tree_leaves(stepped))
    assert max(errs.values()) <= smoke.TRAIN_STEP_TOL, errs


def test_gpu_lm_train_flash_launches_only_without_grad(cuda):
    """A prefill launches flash attention once a layer under
    ``torch.no_grad()`` and never when the parameters require grad; the
    two agree."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optim import tree_map
    cfg, card = _lm_model()[::2]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).cuda()
    before = common.LAUNCHES["flash_attention"]
    with torch.no_grad():
        fast, _ = T.prefill(card, cfg, tokens)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == before + cfg.n_layers
    plain, _ = T.prefill(tree_map(lambda a: a.detach().requires_grad_(True), card), cfg, tokens)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == before + cfg.n_layers
    assert plain.requires_grad
    torch.testing.assert_close(fast, plain.detach(), **GEMM_TOL)


def test_gpu_lm_train_flash_kernel_refuses_grad_operands(cuda):
    """The kernel has no backward: operands that require grad raise
    KernelError with grad enabled and launch under ``torch.no_grad()``."""
    from repro_torch.kernels.common import KernelError
    q = torch.randn((2, 64, 64), device="cuda", requires_grad=True)
    before = common.LAUNCHES["flash_attention"]
    with pytest.raises(KernelError, match="no backward"):
        flash_attention(q, q, q)
    assert common.LAUNCHES["flash_attention"] == before
    with torch.no_grad():
        out = flash_attention(q, q, q)
    assert common.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out, flash_attention_plain(q.detach(), q.detach(), q.detach()),
                               **GEMM_TOL)


def test_gpu_lm_train_launcher_defaults_to_the_card(cuda, tmp_path):
    """``launch.train.main`` with no device trains on cuda, and resumes."""
    from repro_torch.launch import train
    args = ["--arch", "chatglm3_6b", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    run = train.main(args + ["--steps", "2"])
    assert run.params["embed"]["emb"].is_cuda and len(run.losses) == 2
    again = train.main(args + ["--steps", "3"])
    assert again.start == 2 and again.steps == [3]
    assert again.opt_state["m"]["embed"]["emb"].is_cuda


def test_gpu_lm_train_full_width_checkpoint_round_trip(cuda, tmp_path):
    """chatglm3_6b at full width (1 layer, bf16) with its AdamW state saved
    and restored onto the card bit for bit."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import steps as ST
    cfg, params = _full_width_cut(torch.bfloat16)
    _, opt = ST.optimizer_for(cfg)
    state = (params, opt.init(params))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    back = mgr.restore(1, state)
    assert back[1]["step"] == 0
    from repro_torch.train.optim import tree_named_leaves
    for (k, a), (_, b) in zip(tree_named_leaves(state), tree_named_leaves(back)):
        if isinstance(a, int):
            assert a == b, k
        else:
            assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b), k


# ---------------------------------------------------------------------------
# The LM families' training path on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral_8x7b", "mamba2_2_7b"])
def test_gpu_lm_families_train_unit_full_width_matches_cpu(arch, cuda):
    """One MoE and one SSM config at full width cut to one layer (fp32,
    TF32 off, B=1, S=256, MoE at the registered capacity 1.25), held as
    ``chip_smoke.py`` phase 13 (a) holds it: ``steps.value_and_grad`` on the
    card against the CPU port, the loss within 1e-3, each gradient leaf
    within 1e-4 of its own max |g|, every leaf nonzero on the CPU nonzero on
    the card, one AdamW step from the CPU's gradients within 1e-2 lr, the
    same top-k expert sets, and no kernel launched."""
    smoke = _smoke()

    def run(path, fn):
        before = dict(common.LAUNCHES)
        result = fn()
        torch.cuda.synchronize()
        assert dict(common.LAUNCHES) == before, path
        return result

    r = smoke.family_grad_check(torch, arch, 0, run)
    assert r["loss_abs_err"] <= smoke.TRAIN_CPU_TOL, r
    assert r["grad_rel_err"] <= smoke.TRAIN_GRAD_RTOL, r
    assert r["step_err_over_lr"] <= smoke.TRAIN_STEP_TOL, r
    assert not r["lost_on_card"] and r["nonzero_leaves"] > 0, r
    if arch == "mixtral_8x7b":
        assert r["aux"] > 0 and r["topk_sets_differ"]["tokens"] == 0, r


# ---------------------------------------------------------------------------
# The examples and the matmul-site autotune on the card
# ---------------------------------------------------------------------------

def test_gpu_examples_serve_against_the_oracle(cuda):
    """``examples/torch_serve_optimized_cnn.py`` with two workers on the
    card: ``GpuPlatform`` profiles on the card, every sampled response (two
    sequential measurements, the concurrent one) equals the kernel-free
    oracle at 1e-3, no ticket fails."""
    smoke = _smoke()
    out = smoke.example("serve_optimized_cnn").run(requests=2, batch=8, workers=2,
                                                   max_iters=200)
    assert out["device"] == "cuda" and out["concurrent"]["failed"] == 0
    assert len(out["samples"]) == 4
    for net, xs, ys in out["samples"]:
        assert smoke.check_responses(net, out["weights"], [xs], [ys]) <= smoke.SERVE_TOL["atol"]


def test_gpu_examples_train_lm_resumes_on_the_card(tmp_path, cuda):
    """``examples/torch_train_lm.py`` on the card (its default device):
    reduced mixtral_8x7b, 4 steps and a resume to 6 equal an uninterrupted
    6-step run's losses, all finite."""
    lm = _smoke().example("train_lm")
    whole = lm.run("mixtral_8x7b", 6, batch=2, seq=32, ckpt_dir=str(tmp_path / "a"))
    lm.run("mixtral_8x7b", 4, batch=2, seq=32, ckpt_dir=str(tmp_path / "b"))
    resumed = lm.run("mixtral_8x7b", 6, batch=2, seq=32, ckpt_dir=str(tmp_path / "b"))
    assert resumed["start"] == 4 and resumed["losses"] == whole["losses"][4:]
    assert np.isfinite(whole["losses"]).all()
    assert whole["params"]["embed"]["emb"].device.type == "cuda"


def test_gpu_autotune_on_measured_costs(cuda):
    """``MeasuredCost`` times ``matmul_op`` on the card (each variant once,
    then from its memory without a launch); ``build_dataset`` at a small
    token count, ``train_cost_model`` on the card and ``autotune_arch``
    priced by the same measurements: the selection never beats the per-site
    best, and the matmul kernel ran."""
    from repro_torch.configs import base as cb
    from repro_torch.core import autotune as AT
    cost = AT.MeasuredCost()
    before = common.LAUNCHES["matmul"]
    t = cost(256, 512, 384, "mm-128x128x128")
    launched = common.LAUNCHES["matmul"] - before
    assert t > 0 and launched == AT.GEMM_WARMUP + AT.GEMM_REPEATS
    assert cost(256, 512, 384, "mm-128x128x128") == t
    assert common.LAUNCHES["matmul"] - before == launched
    cfg = cb.get("chatglm3_6b")
    data = AT.build_dataset(cost, configs=[cfg], batch_tokens=1024, sample_rows=16,
                            max_flops=1e9)
    assert data.n_sites == 5 and len(data.feats) == 21 and (data.times > 0).all()
    model = AT.train_cost_model(data, max_iters=200)
    assert model.device.type == "cuda"
    res = AT.autotune_arch(cfg, model, batch_tokens=1024, cost_fn=cost)
    assert res.predicted_s >= res.oracle_s * (1 - 1e-9) and res.default_s >= res.oracle_s
    assert set(res.assignment.values()) <= set(data.names)


def test_gpu_autotune_times_bf16_gemms(cuda):
    """``MeasuredCost`` times bf16 operands by default (the matmul kernel's
    launch signature says so) and fp32 when asked; ``build_dataset``
    records the dtype."""
    from repro_torch.core import autotune as AT
    from repro_torch.configs import base as cb
    for dtype in (torch.bfloat16, torch.float32):
        cost = AT.MeasuredCost() if dtype == torch.bfloat16 else AT.MeasuredCost(dtype=dtype)
        common.reset_launches()
        assert cost(512, 256, 384, "mm-256x256x256") > 0
        assert {sig[-2] for sig in common.SEEN["matmul"]} == {str(dtype)[6:]}
    data = AT.build_dataset(AT.MeasuredCost(), configs=[cb.get("chatglm3_6b")],
                            batch_tokens=256, sample_rows=0)
    assert data.dtype == torch.bfloat16 and (data.times > 0).all()
