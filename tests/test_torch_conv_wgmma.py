"""The wgmma route of the bf16 implicit-GEMM conv (``csrc/conv_wgmma.cu``)
against its plain PyTorch version on the card: every instantiated tile,
unsplit and split, on weights TMA loads (R % 8 == 0) and weights the
producer gathers (R = 27, 36, 147), pixel counts ragged against every BN,
one image and batches, stride 1 and 2, f = 1, 3 and 7, bias and residual
in bf16 and in fp32 with ReLU; resnet18's largest signature repeated 20
times (a stage read before its gathered patches reach the async proxy
shows as a repeat that differs); and the route rule on the card.

Each bf16 output is held within one bf16 rounding of the plain version's
fp32 result on the same values, plus 1e-4 of its largest |value| for the
order of the fp32 sums (``chip_smoke.hold_bf16``'s rule), and equals its
own repeat bit for bit (no atomics, split or not).

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels build at
first use); they carry the ``gpu`` marker and skip where no card is
present: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_conv_wgmma.py``. This file imports no JAX.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.im2col_gemm.im2col_gemm import (WGMMA_BK, WGMMA_TILES,
                                                         conv_im2col,
                                                         conv_im2col_batch,
                                                         conv_im2col_batch_plain,
                                                         conv_im2col_plain)
from repro_torch.kernels.im2col_gemm.ops import (conv_im2col_batch_op,
                                                 conv_im2col_op, plan)

pytestmark = pytest.mark.gpu

# (N, C, H, K, f, s): R = C f f of 147 and 27 (weights gathered: rows off 16
# bytes), 36 (gathered, one 64-deep step), 40 and 576 and 4,608 (TMA);
# output channels and N oh ow pixels no multiple of any tile
SHAPES = [(2, 3, 23, 70, 7, 2), (1, 3, 17, 130, 3, 1), (3, 36, 15, 96, 1, 2),
          (2, 40, 11, 72, 1, 1), (8, 64, 13, 64, 3, 1), (1, 512, 7, 200, 3, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m gpu)")
    return torch.device("cuda")


def _operands(gen, N, C, H, K, f, s, ep_dtype):
    """bf16 x (N, C, H, H) and w, bias and residual of ``ep_dtype``."""
    oh = (H - f) // s + 1

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda")
    x = rnd(N, C, H, H).bfloat16()
    w = rnd(K, C, f, f, scale=(C * f * f) ** -0.5).bfloat16()
    return x, w, rnd(K).to(ep_dtype), rnd(N, K, oh, oh).to(ep_dtype)


def _split_of(R):
    """The most slices, up to three, of R's 64-deep steps with a step in
    each (1 where R is one step)."""
    steps = -(-R // WGMMA_BK)
    return next(n for n in (3, 2, 1) if n == 1 or (n - 1) * -(-steps // n) < steps)


def _hold(call, plain, x, w, s, **ep):
    """``call()`` within one bf16 rounding of the plain version's fp32 result
    on the same values, and equal to its own repeat bit for bit."""
    got = call()
    ep32 = dict(ep, bias=ep["bias"].float(), residual=ep["residual"].float())
    want = plain(x.float(), w.float(), s, **ep32)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    mag = want.abs()
    err = (got.float() - want).abs()
    assert (err <= 2 ** -8 * mag + 1e-4 * mag.max()).all(), float(err.max())
    assert torch.equal(call(), got)


@pytest.mark.parametrize("ep_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_ep", "fp32_ep"])
@pytest.mark.parametrize("tile", WGMMA_TILES, ids=lambda t: "x".join(map(str, t)))
def test_gpu_conv_wgmma_every_tile_vs_plain(tile, ep_dtype, cuda):
    """Every wgmma tile on every shape of ``SHAPES``, unsplit and split,
    batched and (the first image) through the single-image wrapper, bias
    and residual of ``ep_dtype``, ReLU; every launch on the wgmma route."""
    bm, bn = tile
    gen = torch.Generator().manual_seed(0)
    common.reset_launches()
    for sig in SHAPES:
        N, C, H, K, f, s = sig
        x, w, b, r = _operands(gen, *sig, ep_dtype)
        for split in sorted({1, _split_of(C * f * f)}):
            kw = dict(bm=bm, bn=bn, split_k=split, route="wgmma")
            ep = dict(bias=b, residual=r, relu=True)
            _hold(lambda: conv_im2col_batch(x, w, s, **kw, **ep),
                  conv_im2col_batch_plain, x, w, s, **ep)
            ep1 = dict(bias=b, residual=r[0], relu=True)
            _hold(lambda: conv_im2col(x[0], w, s, **kw, **ep1),
                  conv_im2col_plain, x[0], w, s, **ep1)
    for k in ("conv_im2col_batch", "conv_im2col"):
        assert {sig[-2] for sig in common.SEEN[k]} == {"wgmma"}


def test_gpu_conv_wgmma_no_epilogue_and_bias_alone(cuda):
    """The epilogue's other combinations on one tile, unsplit and split: no
    bias, residual or ReLU; bias alone; residual alone with ReLU."""
    gen = torch.Generator().manual_seed(1)
    N, C, H, K, f, s = 2, 64, 12, 128, 3, 1
    x, w, b, r = _operands(gen, N, C, H, K, f, s, torch.bfloat16)
    want = conv_im2col_batch_plain(x.float(), w.float(), s)
    for split in (1, 3):
        kw = dict(bm=128, bn=64, split_k=split, route="wgmma")
        for ep in (dict(), dict(bias=b), dict(residual=r, relu=True)):
            got = conv_im2col_batch(x, w, s, **kw, **ep)
            ep32 = {key: (v.float() if torch.is_tensor(v) else v) for key, v in ep.items()}
            want = conv_im2col_batch_plain(x.float(), w.float(), s, **ep32)
            err = (got.float() - want).abs()
            assert (err <= 2 ** -8 * want.abs() + 1e-4 * want.abs().max()).all()
            assert torch.equal(conv_im2col_batch(x, w, s, **kw, **ep), got)


def test_gpu_conv_wgmma_largest_signature_repeats(cuda):
    """resnet18's largest conv of phase 5's b = 8 pass (64 -> 64 channels,
    3x3 on 109 x 109, R = 576) through ``conv_im2col_batch_op`` on the
    wgmma route, held once to the plain version and repeated 20 times bit
    for bit: a patch stage that wgmma read before the producers' stores
    reached the async proxy would differ between runs."""
    gen = torch.Generator().manual_seed(2)
    x, w, b, r = _operands(gen, 8, 64, 109, 64, 3, 1, torch.bfloat16)
    assert plan(8, x, w, 1, "conv-bk128")["route"] == "wgmma"
    common.reset_launches()
    call = lambda: conv_im2col_batch_op(x, w, 1, bias=b, residual=r, relu=True)  # noqa: E731
    _hold(call, conv_im2col_batch_plain, x, w, 1, bias=b, residual=r, relu=True)
    first = call()
    for _ in range(20):
        assert torch.equal(call(), first)
    assert {sig[-2] for sig in common.SEEN["conv_im2col_batch"]} == {"wgmma"}


def test_gpu_conv_wgmma_route_rule_on_the_card(cuda):
    """The entry points take wgmma for bf16 with K >= 64 and mma.sync for
    fp32 and for bf16 with K < 64, as the launch signatures record; an
    explicit wgmma call on fp32 or on K < 64 raises without launching."""
    gen = torch.Generator().manual_seed(3)
    x, w, b, r = _operands(gen, 1, 16, 12, 64, 3, 1, torch.bfloat16)
    x63, w63 = x, w[:63].contiguous()
    common.reset_launches()
    conv_im2col_op(x[0], w, 1, bias=b, residual=r[0], relu=True)
    conv_im2col_op(x63[0], w63, 1)
    conv_im2col_op(x[0].float(), w.float(), 1)
    assert [sig[-2:] for sig in common.SEEN["conv_im2col"]] == [
        ("wgmma", "bfloat16"), ("mma.sync", "bfloat16"), ("mma.sync", "float32")]
    for xx, ww in ((x.float(), w.float()), (x63, w63)):
        with pytest.raises(ValueError, match="wgmma route takes"):
            conv_im2col_batch(xx, ww, 1, bm=64, bn=128, route="wgmma")
    assert common.LAUNCHES["conv_im2col_batch"] == 0

