"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at every tile the variant tables name and every epilogue combination.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels build at
first use). They carry the ``gpu`` marker and skip where no card is present;
on the card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX, so it runs where only the port is installed.
Tolerance: fp32 rtol=atol=1e-4 on unit-scale operands (sum order only).
"""
import itertools

import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.im2col_gemm.im2col_gemm import conv_im2col_batch_plain
from repro_torch.kernels.im2col_gemm.ops import CTA_TILES as CONV_TILES
from repro_torch.kernels.im2col_gemm.ops import conv_im2col_batch_op
from repro_torch.kernels.matmul.matmul import matmul_plain
from repro_torch.kernels.matmul.ops import CTA_TILES as MM_TILES
from repro_torch.kernels.matmul.ops import matmul_op
from repro_torch.kernels.winograd.ops import CTA_TILES as WINO_TILES
from repro_torch.kernels.winograd.winograd import (
    winograd_point_gemm_batch, winograd_point_gemm_batch_plain)

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
    from repro_torch.kernels.winograd.ops import cta_tile
    gen = torch.Generator().manual_seed(0)
    bm, bk, bn = cta_tile(variant)
    for (N, P, K, C, T) in [(2, 16, 60, 48, 75), (3, 36, 130, 70, 9)]:
        u, v = _cuda_rand(gen, P, K, C, scale=C ** -0.5), _cuda_rand(gen, N, P, C, T)
        got = winograd_point_gemm_batch(u, v, bm=bm, bk=bk, bn=bn)
        torch.testing.assert_close(got, winograd_point_gemm_batch_plain(u, v),
                                   **GEMM_TOL)
