"""The wgmma route of the bf16 Winograd point-GEMM
(``csrc/winograd_wgmma.cu``) against its plain PyTorch version on the card:
every instantiated tile; T of every residue mod 8 (1, 4,
9 and 2,916 among them), so V's rows start at every misalignment and, where
T is odd, at a different one from row to row; C no multiple of 64; K ragged
against BM; a V that is a view at an odd element offset; one image and
batches of 1 and 8; resnet18's largest point-GEMM repeated 20 times (a
stage read before its gathered rows reach the async proxy shows as a
repeat that differs); and the route rule on the card.

Each bf16 output is held within one bf16 rounding of the plain version's
fp32 result on the same values, plus 1e-4 of its largest |value| for the
order of the fp32 sums (``chip_smoke.hold_bf16``'s rule), and equals its
own repeat bit for bit (no atomics, C never split).

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels build at
first use); they carry the ``gpu`` marker and skip where no card is
present: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_winograd_wgmma.py``. This file imports no JAX.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.winograd.ops import plan
from repro_torch.kernels.winograd.winograd import (WGMMA_TILES,
                                                   winograd_point_gemm,
                                                   winograd_point_gemm_batch,
                                                   winograd_point_gemm_batch_plain,
                                                   winograd_point_gemm_plain)

pytestmark = pytest.mark.gpu

# (N, P, K, C, T): T = 1, 4, 9, 10, 19, 37, 64, 70, 135, 2,916 cover every
# residue mod 8; C = 8, 72, 200 no multiple of 64; K = 64, 70, 130, 200
# ragged against BM = 128 (and 70, 200 against 64)
SHAPES = [(8, 16, 64, 64, 2916), (1, 16, 70, 72, 135), (2, 4, 130, 200, 9),
          (3, 16, 64, 8, 37), (1, 36, 200, 128, 1), (2, 16, 128, 136, 70),
          (8, 16, 512, 512, 4), (1, 4, 96, 64, 19), (2, 6, 64, 192, 10),
          (1, 16, 128, 128, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m gpu)")
    return torch.device("cuda")


def _operands(gen, N, P, K, C, T, offset=0):
    """bf16 u (P, K, C) and v (N, P, C, T), v starting ``offset`` elements
    into its buffer (a contiguous view)."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda")
    u = rnd(P, K, C, scale=C ** -0.5).bfloat16()
    v = rnd(N, P, C, T).bfloat16()
    if offset:
        buf = torch.empty(v.numel() + offset, dtype=v.dtype, device=v.device)
        buf[offset:].copy_(v.reshape(-1))
        v = buf[offset:].view(v.shape)
    return u, v


def _hold(call, plain, u, v):
    """``call()`` within one bf16 rounding of the plain version's fp32 result
    on the same values, and equal to its own repeat bit for bit."""
    got = call()
    want = plain(u.float(), v.float())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    mag = want.abs()
    err = (got.float() - want).abs()
    assert (err <= 2 ** -8 * mag + 1e-4 * mag.max()).all(), float(err.max())
    assert torch.equal(call(), got)


@pytest.mark.parametrize("tile", WGMMA_TILES, ids=lambda t: "x".join(map(str, t)))
def test_gpu_winograd_wgmma_every_tile_vs_plain(tile, cuda):
    """Every wgmma tile on every shape of ``SHAPES``, batched and (the
    first image) through the single-image wrapper; every launch on the
    wgmma route."""
    bm, bn = tile
    gen = torch.Generator().manual_seed(0)
    common.reset_launches()
    for sig in SHAPES:
        u, v = _operands(gen, *sig)
        kw = dict(bm=bm, bn=bn, route="wgmma")
        _hold(lambda: winograd_point_gemm_batch(u, v, **kw),
              winograd_point_gemm_batch_plain, u, v)
        _hold(lambda: winograd_point_gemm(u, v[0], **kw),
              winograd_point_gemm_plain, u, v[0])
    for k in ("winograd_point_gemm_batch", "winograd_point_gemm"):
        assert {sig[-2] for sig in common.SEEN[k]} == {"wgmma"}


@pytest.mark.parametrize("offset", [1, 3, 5])
def test_gpu_winograd_wgmma_v_at_odd_offsets(offset, cuda):
    """V as a contiguous view 1, 3 or 5 elements into its buffer (off 16
    bytes differently from every other view), on every tile, T odd and
    even: the producers realign each row from where it starts, and a first
    window before V's start stays in its 16-byte block."""
    gen = torch.Generator().manual_seed(offset)
    for sig in ((2, 16, 64, 64, 2809), (1, 16, 130, 200, 9), (8, 4, 64, 72, 4)):
        u, v = _operands(gen, *sig, offset=offset)
        assert v.data_ptr() % 16 == 2 * offset and v.is_contiguous()
        for bm, bn in WGMMA_TILES:
            _hold(lambda: winograd_point_gemm_batch(u, v, bm=bm, bn=bn, route="wgmma"),
                  winograd_point_gemm_batch_plain, u, v)


def test_gpu_winograd_wgmma_plans_at_resnet18_shapes(cuda):
    """``ops.plan`` on resnet18's 13 F(2x2) point-GEMMs, one image and b = 8,
    each held to the plain version: every call on the wgmma route but the
    one-image calls of T = 4 and 1 (fewer than 8 columns), on mma.sync."""
    gen = torch.Generator().manual_seed(4)
    common.reset_launches()
    for C, T in ((64, 2916), (64, 2809), (64, 2704), (64, 2601), (128, 576),
                 (128, 529), (128, 484), (256, 100), (256, 81), (256, 64),
                 (512, 9), (512, 4), (512, 1)):
        u, v = _operands(gen, 8, 16, C, C, T)
        for vv, fn, plain in ((v[0], winograd_point_gemm, winograd_point_gemm_plain),
                              (v, winograd_point_gemm_batch,
                               winograd_point_gemm_batch_plain)):
            kw = plan(u, vv)
            assert kw["route"] == ("wgmma" if vv.dim() == 4 or T >= 8 else "mma.sync")
            _hold(lambda: fn(u, vv, **kw), plain, u, vv)
    assert {sig[-2] for sig in common.SEEN["winograd_point_gemm_batch"]} == {"wgmma"}
    assert sum(n for sig, n in common.SEEN["winograd_point_gemm"].items()
               if sig[-2] == "mma.sync") == 4       # held once, repeated once


def test_gpu_winograd_wgmma_largest_signature_repeats(cuda):
    """resnet18's largest point-GEMM of phase 5's b = 8 pass (conv1: K = C =
    64, T = 2,916, T = 4 mod 8) through ``ops.plan`` on the wgmma route,
    held once to the plain version and repeated 20 times bit for bit."""
    gen = torch.Generator().manual_seed(2)
    u, v = _operands(gen, 8, 16, 64, 64, 2916)
    kw = plan(u, v)
    assert kw["route"] == "wgmma"
    common.reset_launches()
    call = lambda: winograd_point_gemm_batch(u, v, **kw)  # noqa: E731
    _hold(call, winograd_point_gemm_batch_plain, u, v)
    first = call()
    for _ in range(20):
        assert torch.equal(call(), first)
    assert {sig[-2] for sig in common.SEEN["winograd_point_gemm_batch"]} == {"wgmma"}


def test_gpu_winograd_wgmma_route_rule_on_the_card(cuda):
    """``ops.plan`` gives wgmma for bf16 with K >= 64, C % 8 == 0, an
    aligned u and 8 columns or more, and mma.sync for fp32, K < 64, C % 8
    != 0, a u off 16 bytes and a single column, as the launch signatures
    record; an explicit wgmma call on the first four raises without
    launching (the narrow call runs on wgmma when named)."""
    gen = torch.Generator().manual_seed(3)
    u, v = _operands(gen, 1, 16, 64, 24, 9)
    u63 = u[:, :63].contiguous()
    u20, v20 = _operands(gen, 1, 16, 64, 20, 9)
    buf = torch.empty(u.numel() + 1, dtype=u.dtype, device=u.device)
    buf[1:].copy_(u.reshape(-1))
    uoff = buf[1:].view(u.shape)
    cases = [(u, v, "wgmma", "bfloat16"), (u63, v, "mma.sync", "bfloat16"),
             (u20, v20, "mma.sync", "bfloat16"), (uoff, v, "mma.sync", "bfloat16"),
             (u.float(), v.float(), "mma.sync", "float32"),
             (u, v[..., :1].contiguous(), "mma.sync", "bfloat16")]
    common.reset_launches()
    for uu, vv, _, _ in cases:
        winograd_point_gemm(uu, vv[0], **plan(uu, vv[0]))
    assert [sig[-2:] for sig in common.SEEN["winograd_point_gemm"]] == [
        (rt, dt) for *_, rt, dt in cases]
    for uu, vv, *_ in cases[1:-1]:
        with pytest.raises(ValueError, match="wgmma route takes"):
            winograd_point_gemm_batch(uu, vv, bm=64, bn=64, route="wgmma")
    assert common.LAUNCHES["winograd_point_gemm_batch"] == 0
    u1, v1 = cases[-1][:2]
    _hold(lambda: winograd_point_gemm(u1, v1[0], bm=64, bn=64, route="wgmma"),
          winograd_point_gemm_plain, u1, v1[0])
