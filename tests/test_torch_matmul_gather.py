"""The bf16 matmul's gathered operands on the CPU: the wgmma route takes
every bf16 call of at least 64 rows whatever its alignment, loading each
operand by TMA where TMA can address it and gathering it otherwise
(``kernels/matmul/matmul.loaders``), in ``csrc/matmul_wgmma.cu``'s
``matmul_gather_kernel``.

Held here: the route and the loaders of each of resnet18's 20 GEMMs as
``chip_smoke.py``'s phase 5 gives them (weights broadcast over b = 8,
``F.unfold``'s patches), the gathered plans (B's short rows packed across
the batch, tiles counted over the packed columns), the gathered tiles
against the ``.cu``'s instantiations, and bf16 ``matmul_op`` /
``matmul_batch_op`` on unaligned shapes against the reference's Pallas
``matmul`` / ``matmul_batch`` in interpret mode, with bias, residual and
ReLU. On the CPU the wrappers compute their plain versions, so this holds
the routing, planning and epilogue plumbing; ``tests/test_torch_gpu.py -k
gather`` holds the kernel itself on the card.

Tolerance: the reference's ``_TOL`` (``tests/test_kernels.py:19-20``),
bf16 output 5e-2, fp32 output 1e-4 (products of bf16 values are exact in
fp32, only the order of the sums differs).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.matmul import matmul as ref_matmul
from repro.kernels.matmul.matmul import matmul_batch as ref_matmul_batch
from repro.kernels.matmul.ops import VARIANTS as REF_VARIANTS
from repro_torch.kernels.matmul.matmul import (WGMMA_GATHER_A_TILE,
                                               WGMMA_GATHER_STAGES,
                                               WGMMA_GATHER_TILES, WGMMA_PACK_N,
                                               loaders, matmul, matmul_batch,
                                               packs, wgmma_tiles)
from repro_torch.kernels.matmul.ops import (SMS, VARIANTS, matmul_batch_op,
                                            matmul_op, plan, route, wgmma_plan,
                                            wgmma_split)

BF = torch.bfloat16
F32_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py::_TOL[float32]
BF16_TOL = dict(rtol=5e-2, atol=5e-2)     # tests/test_kernels.py::_TOL[bfloat16]
CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "matmul_wgmma.cu"
BATCH = 8
# (name, M, C f f, oh ow) of resnet18's 20 convs at 224 x 224 as GEMMs
# (chip_smoke.conv_layers), and the loaders each takes
RESNET18 = [
    ("conv0", 64, 147, 11881, "gather/gather"), ("conv1", 64, 576, 11449, "tma/gather"),
    ("conv2", 64, 576, 11025, "tma/gather"), ("conv4", 64, 576, 10609, "tma/gather"),
    ("conv5", 64, 576, 10201, "tma/gather"), ("down9", 128, 64, 2601, "tma/gather"),
    ("conv7", 128, 576, 2500, "tma/gather"), ("conv8", 128, 1152, 2304, "tma/tma"),
    ("conv11", 128, 1152, 2116, "tma/gather"), ("conv12", 128, 1152, 1936, "tma/tma"),
    ("down16", 256, 128, 484, "tma/gather"), ("conv14", 256, 1152, 441, "tma/gather"),
    ("conv15", 256, 2304, 361, "tma/gather"), ("conv18", 256, 2304, 289, "tma/gather"),
    ("conv19", 256, 2304, 225, "tma/gather"), ("down23", 512, 256, 64, "tma/tma"),
    ("conv21", 512, 2304, 49, "tma/gather"), ("conv22", 512, 4608, 25, "tma/gather"),
    ("conv25", 512, 4608, 9, "tma/gather"), ("conv26", 512, 4608, 1, "tma/gather")]


def _meta(*shape):
    """A bf16 tensor with no storage (its address reads 0, 16-byte
    aligned): the route rule on full-size shapes."""
    return torch.empty(*shape, dtype=BF, device="meta")


def test_resnet18_gemms_are_the_zoo_convs():
    """The table above is resnet18's convs as chip_smoke.py's phase 5
    drives them (the zoo's valid convolutions at 224 x 224)."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.models import cnn_zoo
    got = [(n.split("/")[-1], K, C * f * f, ((H - f) // s + 1) ** 2)
           for n, C, H, K, f, s in chip_smoke.conv_layers(cnn_zoo.get("resnet18"))]
    assert got == [r[:4] for r in RESNET18]


@pytest.mark.parametrize("layer", RESNET18, ids=lambda r: r[0])
def test_resnet18_gemm_route_and_loaders(layer):
    """Every one of the 20 takes wgmma (bf16, M >= 64): A (the broadcast
    weights, rows of C f f) by TMA except conv0's K = 147; B (the patches,
    rows of oh ow) gathered except where oh ow is a multiple of 8 (conv8,
    conv12, down23, which keep the TMA kernel and its plan); B's rows
    packed across the 8 images where N < 64 beside a TMA A."""
    _, M, K, N, how = layer
    x, y = _meta(M, K).expand(BATCH, M, K), _meta(BATCH, K, N)
    assert route(x, y) == "wgmma" and loaders(x, y) == how
    assert packs(x, y, how) == (how == "tma/gather" and N < WGMMA_PACK_N)
    p = plan(x, y, "mm-128x128x128")
    assert p["route"] == "wgmma" and (p["bm"], p["bn"], p["stages"]) in wgmma_tiles(how)
    if how == "tma/tma":       # the aligned kernel's plan, unchanged
        assert p == dict(zip(("bm", "bn", "bk", "stages", "split_k"),
                             wgmma_plan(M, N, K, BATCH, "mm-128x128x128")), route="wgmma")


@pytest.mark.parametrize("layer", [r for r in RESNET18 if r[3] < WGMMA_PACK_N and r[4] != "tma/tma"],
                         ids=lambda r: r[0])
def test_packed_plans_count_packed_columns(layer):
    """resnet18's conv21, conv22, conv25, conv26 (N = 49, 25, 9, 1; M =
    512): the plan's tiles run over the 8 N packed columns, one walk for
    all images, and K is split until one wave is full (``wgmma_split``):
    fewer slices than the unpacked count of tiles would give."""
    _, M, K, N, how = layer
    bm, bn, bk, stages, split = wgmma_plan(M, N, K, BATCH, "mm-128x128x128", how, True)
    assert (bm, bn, stages) == WGMMA_GATHER_TILES[-1] and bk == 64
    packed = -(-M // bm) * -(-(N * BATCH) // bn)
    unpacked = -(-M // bm) * -(-N // bn) * BATCH
    assert packed < unpacked and packed < SMS
    assert split == wgmma_split(packed, K) > 1
    assert split >= wgmma_plan(M, N, K, BATCH, "mm-128x128x128", how, False)[4]
    per = -(-(-(-K // 64)) // split)
    assert (split - 1) * per < -(-K // 64) <= split * per


def test_gathered_plans_pick_bm_by_m_whatever_the_variant():
    """A call with B gathered takes 64 x 64 where M <= 64 and 128 x 64
    above it under every variant; a gathered A takes its one tile."""
    for v in VARIANTS:
        assert wgmma_plan(64, 11449, 576, 8, v, "tma/gather")[:4] == (64, 64, 64, 4)
        assert wgmma_plan(100, 2500, 576, 8, v, "tma/gather")[:4] == (128, 64, 64, 4)
        assert wgmma_plan(512, 441, 1152, 8, v, "tma/gather")[:4] == (128, 64, 64, 4)
        assert wgmma_plan(512, 441, 147, 8, v, "gather/gather")[:4] == (64, 64, 64, 4)
        assert wgmma_plan(512, 440, 147, 8, v, "gather/tma")[:4] == (64, 64, 64, 4)


def test_gathered_tiles_match_the_cuda_instantiations():
    """WGMMA_GATHER_TILES, WGMMA_GATHER_A_TILE, the stages and the packing
    bound are what csrc/matmul_wgmma.cu instantiates (RT_FOR_EACH_GATHER_TILE,
    kGatherABM / kGatherABN, kGatherStages, kPackN)."""
    src = CU.read_text()
    body = re.search(r"#define RT_FOR_EACH_GATHER_TILE\(X\)(.*)", src).group(1)
    tiles = [tuple(int(v) for v in t) for t in re.findall(r"X\((\d+), (\d+)\)", body)]
    stages = int(re.search(r"constexpr int kGatherStages = (\d+);", src).group(1))
    assert [(bm, bn, stages) for bm, bn in tiles] == list(WGMMA_GATHER_TILES)
    am, an = (int(v) for v in re.search(
        r"constexpr int kGatherABM = (\d+), kGatherABN = (\d+);", src).groups())
    assert WGMMA_GATHER_A_TILE == (am, an, stages) and stages == WGMMA_GATHER_STAGES
    assert int(re.search(r"constexpr int kPackN = (\d+);", src).group(1)) == WGMMA_PACK_N


def test_explicit_gathered_calls_refuse_other_tiles():
    """A gathered call takes only its loaders' tiles: the TMA kernel's
    (128, 256, 3) on B gathered, 128 x 64 on A gathered, and a split whose
    slices do not all own a step, raise ``ValueError``; M < 64 and fp32
    still refuse the route."""
    x, y = torch.zeros(128, 64, dtype=BF), torch.zeros(64, 99, dtype=BF)
    with pytest.raises(ValueError, match="instantiated wgmma tile for loaders tma/gather"):
        matmul(x, y, bm=128, bn=256, stages=3, route="wgmma")
    xa = torch.zeros(128, 61, dtype=BF)
    with pytest.raises(ValueError, match="loaders gather/gather"):
        matmul(xa, torch.zeros(61, 99, dtype=BF), bm=128, bn=64, stages=4, route="wgmma")
    with pytest.raises(ValueError, match="split_k"):
        matmul(x, y, bm=64, bn=64, stages=4, split_k=2, route="wgmma")
    for bad in (x[:63], x.float()):
        with pytest.raises(ValueError, match="wgmma route takes"):
            matmul(bad, y if bad.dtype == BF else y.float(), bm=64, bn=64, route="wgmma")
    assert matmul(x, y, bm=64, bn=64, stages=4, route="wgmma").shape == (128, 99)


# ---------------------------------------------------------------------------
# Against the reference, on unaligned shapes at small widths
# ---------------------------------------------------------------------------

def _bf16(rng, *shape, scale=1.0):
    """(JAX array, torch tensor) holding the same bf16 values."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(BF)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _offset(t, off):
    """``t`` as a contiguous view ``off`` elements into a larger tensor."""
    flat = torch.zeros(t.numel() + off, dtype=t.dtype)
    v = flat[off:].view(t.shape)
    v.copy_(t)
    return v


OUT = {"f32": (jnp.float32, torch.float32, F32_TOL), "bf16": (jnp.bfloat16, BF, BF16_TOL)}
# (M, K, N, A's offset, B's offset) with the loaders they give
MATMUL_CASES = [(64, 147, 99, 0, 0, "gather/gather"), (72, 96, 61, 0, 0, "tma/gather"),
                (130, 60, 136, 0, 0, "gather/tma"), (96, 128, 128, 3, 0, "gather/tma"),
                (100, 200, 76, 0, 5, "tma/gather")]


@pytest.mark.parametrize("out", sorted(OUT))
@pytest.mark.parametrize("case", MATMUL_CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_gathered_matmul_op_matches_reference(case, out):
    """bf16 ``matmul_op`` with K or N off 8, or an operand at an odd
    offset: the wgmma route under the case's loaders, equal to the
    reference's ``matmul`` (interpret mode, the variant's TPU blocks) with
    bias, residual and ReLU, in either output dtype."""
    jdt, tdt, tol = OUT[out]
    m, k, n, xo, yo, how = case
    variant = sorted(VARIANTS)[MATMUL_CASES.index(case) % len(VARIANTS)]
    rng = np.random.default_rng(MATMUL_CASES.index(case))
    (jx, x), (jy, y) = _bf16(rng, m, k, scale=k ** -0.5), _bf16(rng, k, n)
    (jb, b), (jr, r) = _bf16(rng, m), _bf16(rng, m, n)
    x, y = _offset(x, xo), _offset(y, yo)
    assert route(x, y) == "wgmma" and loaders(x, y) == how
    bm, bk, bn = REF_VARIANTS[variant]
    want = ref_matmul(jx, jy, bm=bm, bk=bk, bn=bn, bias=jb, residual=jr, relu=True,
                      out_dtype=jdt, interpret=True)
    got = matmul_op(x, y, variant, bias=b, residual=r, relu=True, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# (B, M, K, N, A broadcast, A's batch stride off 8) with the loaders
BATCH_CASES = [(3, 64, 27, 169, True, False, "gather/gather"),
               (3, 128, 64, 9, True, False, "tma/gather"),      # packed
               (2, 96, 72, 25, True, False, "tma/gather"),      # packed
               (2, 64, 64, 100, False, True, "gather/gather"),
               (3, 72, 32, 49, False, False, "tma/gather")]


@pytest.mark.parametrize("case", BATCH_CASES, ids=lambda c: "x".join(map(str, c[:4])))
def test_gathered_matmul_batch_op_matches_reference(case):
    """bf16 ``matmul_batch_op`` on resnet18-like per-image GEMMs cut to
    small widths (weights broadcast or not, patches of N off 8, short rows
    packed across the batch, a batch stride off 8): the wgmma route under
    the case's loaders, equal to the reference's ``matmul_batch`` with
    bias, residual and ReLU, bf16 output."""
    B, M, K, N, bcast, stride_off, how = case
    rng = np.random.default_rng(100 + BATCH_CASES.index(case))
    if bcast:
        jx1, x1 = _bf16(rng, M, K, scale=K ** -0.5)
        jx, x = jnp.broadcast_to(jx1, (B, M, K)), x1.expand(B, M, K)
    else:
        jx, x = _bf16(rng, B, M, K, scale=K ** -0.5)
        if stride_off:
            flat = torch.zeros(B * (M * K + 4), dtype=BF)
            xs = flat.as_strided((B, M, K), (M * K + 4, K, 1))
            xs.copy_(x)
            x = xs
    (jy, y), (jb, b), (jr, r) = _bf16(rng, B, K, N), _bf16(rng, M), _bf16(rng, B, M, N)
    assert route(x, y) == "wgmma" and loaders(x, y) == how
    assert packs(x, y, how) == (bcast and how == "tma/gather" and N < WGMMA_PACK_N)
    want = ref_matmul_batch(jx, jy, bm=128, bk=128, bn=128, bias=jb, residual=jr,
                            relu=True, out_dtype=jnp.bfloat16, interpret=True)
    got = matmul_batch_op(x, y, "mm-128x128x128", bias=b, residual=r, relu=True)
    assert got.dtype == BF and got.shape == (B, M, N)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_every_gathered_tile_explicit_call_on_the_cpu():
    """Every gathered tile named explicitly on a B-gathered call, split or
    not, and the A-gathering tile on an A-gathered call: the CPU computes
    the plain version (fp32 sum, epilogue, one cast)."""
    rng = np.random.default_rng(11)
    _, x = _bf16(rng, 200, 264, scale=264 ** -0.5)
    _, y = _bf16(rng, 264, 137)
    _, xa = _bf16(rng, 200, 263, scale=263 ** -0.5)
    want, want_a = x.float() @ y.float(), xa.float() @ y[:263].float()
    calls = [(x, y, t, want) for t in WGMMA_GATHER_TILES]
    calls.append((xa, y[:263], WGMMA_GATHER_A_TILE, want_a))
    for xx, yy, (bm, bn, st), w in calls:
        for split in (1, 3):
            got = matmul(xx, yy, bm=bm, bn=bn, stages=st, split_k=split, route="wgmma",
                         out_dtype=torch.float32)
            torch.testing.assert_close(got, w, **F32_TOL)
    out = matmul_batch(x.expand(3, 200, 264), torch.stack([y[:, :9]] * 3), bm=128, bn=64,
                       stages=4, route="wgmma", out_dtype=torch.float32)
    torch.testing.assert_close(out, (x.float() @ y[:, :9].float()).expand(3, 200, 9), **F32_TOL)
