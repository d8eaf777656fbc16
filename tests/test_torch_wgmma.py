"""The wgmma route of the bf16 matmul (``csrc/matmul_wgmma.cu``) on the CPU:
the rule that picks it, its plan table, its instantiated tiles, and bf16
``matmul_op`` / ``matmul_batch_op`` on the shapes it serves against the
reference's Pallas kernels in interpret mode.

``kernels/matmul/ops.route`` sends bf16 operands with M >= 64 to the wgmma
kernel whatever their alignment (each operand by TMA where TMA can address
it, else gathered: ``matmul.loaders``) and everything else to the mma.sync
kernels of ``csrc/matmul.cu``, from the call alone; a call that names the
wgmma route on operands it cannot take raises. On the CPU either route computes the
wrapper's plain version, so the reference comparison holds the routing,
planning and epilogue plumbing; ``tests/test_torch_gpu.py -k wgmma`` holds
the kernel itself to that plain version on the card.

Tolerances: the reference's ``_TOL`` (``tests/test_kernels.py:19-20``):
fp32 output rtol=atol=1e-4 (products of bf16 values are exact in fp32, only
the order of the sums differs), bf16 output 5e-2.
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
from repro_torch.configs import base as cb
from repro_torch.core import autotune as AT
from repro_torch.kernels import common
from repro_torch.kernels.matmul.matmul import (MMA_STAGES, WGMMA_BK,
                                               WGMMA_GATHER_A_TILE, WGMMA_TILE_M,
                                               WGMMA_TILE_N, WGMMA_TILES, loaders,
                                               matmul, matmul_batch, takes_wgmma,
                                               wgmma_tiles)
from repro_torch.kernels.matmul.ops import (SMS, VARIANTS, WGMMA_CEILINGS,
                                            cta_plan, matmul_batch_op, matmul_op,
                                            plan, route, wgmma_plan)

F32_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py::_TOL[float32]
BF16_TOL = dict(rtol=5e-2, atol=5e-2)     # tests/test_kernels.py::_TOL[bfloat16]
SMEM = 232448                             # shared memory one H100 block can use
CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "matmul_wgmma.cu"
BF = torch.bfloat16


def _meta(*shape, dtype=BF):
    """A tensor with no storage (its address reads 0): shapes of the size
    the LM sites have, for the route rule alone."""
    return torch.empty(*shape, dtype=dtype, device="meta")


def _smem(bm: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of a wgmma tile, as WgTile::kSmemBytes counts
    it: 1,024 bytes of alignment, the ring of stages x (BM + BN) rows of 64
    bf16, two 8-byte barriers a stage."""
    return 1024 + stages * (bm + bn) * WGMMA_BK * 2 + 2 * stages * 8


# ---------------------------------------------------------------------------
# The route rule
# ---------------------------------------------------------------------------

def test_every_autotune_site_takes_wgmma():
    """All 39 distinct LM GEMM sites of the registered configs: bf16, M >=
    5,120, K and N multiples of 8: the wgmma route under every variant."""
    sites = AT.site_shapes(cb.all_assigned())
    assert len(sites) == 39
    for m, k, n in sites:
        x, y = _meta(m, k), _meta(k, n)
        assert route(x, y) == "wgmma", (m, k, n)
        assert {plan(x, y, v)["route"] for v in VARIANTS} == {"wgmma"}


@pytest.mark.parametrize("case", ["m_below_64", "odd_k", "odd_n", "k_not_8",
                                  "offset_view", "fp32", "batch_stride"])
def test_route_rule_and_loaders(case):
    """M < 64 and fp32 operands take mma.sync, and an explicit wgmma call on
    them raises ``ValueError`` rather than run the other route. Every other
    bf16 call takes wgmma whatever its alignment, each operand TMA cannot
    address gathered: K or N not a multiple of 8 (odd or 4 off), a view one
    element off a 16-byte boundary (A), a batch stride off 8 elements (A);
    the result is the plain one."""
    x, y = torch.zeros(128, 64, dtype=BF), torch.zeros(64, 96, dtype=BF)
    gathered = {"odd_k": "gather/tma", "odd_n": "tma/gather",
                "k_not_8": "gather/tma", "offset_view": "gather/tma",
                "batch_stride": "gather/tma"}.get(case)
    rng = np.random.default_rng(3)
    if case == "m_below_64":
        x = x[:63]
    elif case == "odd_k":
        x, y = torch.zeros(128, 147, dtype=BF), torch.zeros(147, 96, dtype=BF)
    elif case == "odd_n":
        y = torch.zeros(64, 333, dtype=BF)
    elif case == "k_not_8":
        x, y = torch.zeros(128, 60, dtype=BF), torch.zeros(60, 96, dtype=BF)
    elif case == "offset_view":
        x = torch.zeros(128 * 64 + 1, dtype=BF)[1:].view(128, 64)
        assert x.is_contiguous() and x.data_ptr() % 16 == 2
    elif case == "fp32":
        x, y = x.float(), y.float()
    x.copy_(torch.from_numpy(rng.standard_normal(tuple(x.shape), dtype=np.float32)))
    y.copy_(torch.from_numpy(rng.standard_normal(tuple(y.shape), dtype=np.float32)))
    if case == "batch_stride":
        # three matrices of (128, 64) every 8,196 elements: each one
        # contiguous, the batch stride 4 elements off a multiple of 8
        flat = torch.from_numpy(rng.standard_normal(3 * 8196, dtype=np.float32)).to(BF)
        x = flat.as_strided((3, 128, 64), (8196, 64, 1))
        y = torch.from_numpy(rng.standard_normal((3, 64, 96), dtype=np.float32)).to(BF)
        assert route(x, y) == "wgmma" and takes_wgmma(x, y)
        assert loaders(x, y) == gathered
        p = plan(x, y, "mm-256x256x256")
        assert (p["bm"], p["bn"], p["stages"]) == WGMMA_GATHER_A_TILE
        out = matmul_batch(x, y, route="wgmma", out_dtype=torch.float32,
                           **{k: v for k, v in p.items() if k != "route"})
        torch.testing.assert_close(out, x.float() @ y.float(), **F32_TOL)
        out = matmul_batch_op(x, y, "mm-256x256x256", out_dtype=torch.float32)
        torch.testing.assert_close(out, x.float() @ y.float(), **F32_TOL)
        return
    if gathered is None:
        assert route(x, y) == "mma.sync" and not takes_wgmma(x, y)
        assert plan(x, y, "mm-256x256x256")["route"] == "mma.sync"
        with pytest.raises(ValueError, match="wgmma route takes"):
            matmul(x, y, bm=128, bn=128, route="wgmma")
    else:
        assert route(x, y) == "wgmma" and takes_wgmma(x, y)
        assert loaders(x, y) == gathered
        p = plan(x, y, "mm-256x256x256")
        assert p["route"] == "wgmma"
        assert (p["bm"], p["bn"], p["stages"]) in wgmma_tiles(gathered)
        # an aligned tile named on a gathered call is not instantiated there
        with pytest.raises(ValueError, match="instantiated wgmma tile"):
            matmul(x, y, bm=128, bn=256, stages=3, route="wgmma")
    out = matmul_op(x, y, "mm-256x256x256", out_dtype=torch.float32)
    torch.testing.assert_close(out, x.float() @ y.float(), **F32_TOL)


def test_route_takes_aligned_batches_and_broadcasts():
    """A contiguous batch, and an operand broadcast over the batch (stride
    0, read in place), take wgmma; so does M = 64 exactly."""
    x, y = torch.zeros(3, 64, 576, dtype=BF), torch.zeros(3, 576, 784, dtype=BF)
    assert route(x, y) == "wgmma"
    assert route(x[0].expand(3, 64, 576), y) == "wgmma"
    assert route(x, y[0].expand(3, 576, 784)) == "wgmma"
    assert route(x[0], y[0]) == "wgmma"


def test_explicit_plans_refuse_unknown_tiles_and_routes():
    """The wgmma route takes only its instantiated (BM, BN, stages) tiles,
    64 deep, and a split whose slices each own a 64-deep step; mma.sync
    keeps its 3-stage ring; an unknown route name raises."""
    x, y = torch.zeros(128, 256, dtype=BF), torch.zeros(256, 128, dtype=BF)
    for bad in (dict(bm=32, bn=128), dict(bm=128, bn=128, stages=5),
                dict(bm=128, bn=128, bk=32), dict(bm=128, bn=128, split_k=5)):
        with pytest.raises(ValueError):
            matmul(x, y, route="wgmma", **bad)
    with pytest.raises(ValueError, match="mma.sync ring"):
        matmul(x, y, bm=64, bn=64, stages=4)
    with pytest.raises(ValueError, match="route must be"):
        matmul(x, y, route="tma")
    assert matmul(x, y, bm=128, bn=128, split_k=4, route="wgmma").shape == (128, 128)


# ---------------------------------------------------------------------------
# The plan table and the instantiated tiles
# ---------------------------------------------------------------------------

def test_wgmma_ceilings_keep_six_kernels_for_eight_keys():
    """BM half the TPU's bm capped at 128, BN the TPU's bn capped at 256,
    more stages for the TPU's bk = 256 than for 128: six distinct ceilings
    for the eight keys (the two capped keys share their 256-row twins'),
    each instantiated and within a block's shared memory."""
    assert set(WGMMA_CEILINGS) == set(VARIANTS)
    for v, (bm, bn, stages) in WGMMA_CEILINGS.items():
        tbm, tbk, tbn = REF_VARIANTS[v]
        assert (bm, bn) == (min(tbm // 2, 128), min(tbn, 256)), v
        assert (bm, bn, stages) in WGMMA_TILES
    assert len(set(WGMMA_CEILINGS.values())) == 6
    assert WGMMA_CEILINGS["mm-512x128x128"] == WGMMA_CEILINGS["mm-256x128x128"]
    assert WGMMA_CEILINGS["mm-512x256x256"] == WGMMA_CEILINGS["mm-256x256x256"]


@pytest.mark.parametrize("tile", WGMMA_TILES, ids=lambda t: "x".join(map(str, t)))
def test_wgmma_tile_fits_shared_memory(tile):
    bm, bn, stages = tile
    assert bm in WGMMA_TILE_M and bn in WGMMA_TILE_N and stages >= 3
    assert _smem(bm, bn, stages) <= SMEM


def test_wgmma_tiles_match_the_cuda_instantiations():
    """WGMMA_TILES is what csrc/matmul_wgmma.cu instantiates
    (RT_FOR_EACH_WGMMA_TILE), so no plan names a tile the launcher
    refuses, and every plan of every variant over many shapes is one of
    them."""
    src = CU.read_text()
    body = re.search(r"#define RT_FOR_EACH_WGMMA_TILE\(X\)((?:.*\\\n)*.*)", src).group(1)
    tiles = tuple(tuple(int(v) for v in t)
                  for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", body))
    assert sorted(tiles) == sorted(WGMMA_TILES) and len(set(tiles)) == len(tiles)
    planned = {(bm, bn, stages) for bm, bn, _, stages, _ in
               (wgmma_plan(M, N, 512, 1, v) for v in VARIANTS
                for M in (64, 100, 128, 5000) for N in (8, 64, 72, 128, 200, 256, 856))}
    assert planned == set(WGMMA_TILES)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_wgmma_plan_splits_only_to_fill_the_card(variant):
    """The wgmma plan at the LM sites is the variant's ceiling (BN fitted
    to a narrower N), unsplit; fewer output tiles than SMs split K, in
    whole 64-deep steps, into as many slices as one wave of CTAs holds
    (or one step per slice), every slice owning a step; the
    plan is one ``common.check_plan`` accepts."""
    cm, cn, cs = WGMMA_CEILINGS[variant]
    for m, k, n in AT.site_shapes(cb.all_assigned()):
        bm, bn, bk, stages, split = wgmma_plan(m, n, k, 1, variant)
        assert (bm, stages, bk, split) == (cm, cs, WGMMA_BK, 1)
        assert bn == min(t for t in WGMMA_TILE_N if t >= min(n, cn))
    for M, N, K, batch in [(64, 64, 4608, 1), (128, 256, 1152, 2), (512, 9, 4608, 8),
                           (64, 784, 576, 8), (200, 136, 264, 1)]:
        bm, bn, bk, stages, split = wgmma_plan(M, N, K, batch, variant)
        tiles = -(-M // bm) * -(-N // bn) * batch
        steps = -(-K // WGMMA_BK)
        per = -(-steps // split)
        if tiles >= SMS or steps <= 1:
            assert split == 1
        else:      # as many slices as one wave of CTAs holds
            assert tiles * split <= SMS
            assert per == -(-steps // min(steps, SMS // tiles))
        assert split == 1 or (split - 1) * per < steps <= split * per
        common.check_plan("matmul", K, bm, bk, bn, split, WGMMA_TILE_M,
                          (WGMMA_BK,), WGMMA_TILE_N)


def test_mma_sync_plans_record_their_ring():
    """A call on the mma.sync route (bf16 of M < 64) plans as before and
    records the 3-stage ring; its fp32 plans are those of ``cta_plan``."""
    x, y = torch.zeros(50, 27, dtype=BF), torch.zeros(27, 333, dtype=BF)
    p = plan(x, y, "mm-256x128x256")
    assert p == dict(zip(("bm", "bn", "bk", "split_k"),
                         cta_plan(50, 333, 27, 1, "mm-256x128x256", BF)),
                     route="mma.sync")
    assert MMA_STAGES == 3
    x32, y32 = torch.zeros(64, 1152), torch.zeros(1152, 128)
    bm, bn, bk, split = cta_plan(64, 128, 1152, 1, "mm-256x256x256")
    assert plan(x32, y32, "mm-256x256x256") == dict(bm=bm, bk=bk, bn=bn,
                                                    split_k=split, route="mma.sync")


# ---------------------------------------------------------------------------
# Against the reference, on site-like shapes cut to a small M
# ---------------------------------------------------------------------------

def _bf16(rng, *shape, scale=1.0):
    """(JAX array, torch tensor) holding the same bf16 values."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    t = t.to(BF)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


# (M, K, N): LM site (K, N) pairs of core/autotune.site_shapes, M cut
SITE_LIKE = [(64, 896, 128), (72, 128, 896), (96, 304, 896), (128, 768, 240),
             (200, 256, 1024)]
OUT = {"f32": (jnp.float32, torch.float32, F32_TOL),
       "bf16": (jnp.bfloat16, BF, BF16_TOL)}


@pytest.mark.parametrize("out", sorted(OUT))
@pytest.mark.parametrize("shape", SITE_LIKE, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_matmul_op_matches_reference(shape, out):
    """bf16 ``matmul_op`` on a site-like shape takes the wgmma route and
    equals the reference's ``matmul`` (interpret mode, the variant's TPU
    blocks), with the full epilogue, in either output dtype."""
    jdt, tdt, tol = OUT[out]
    m, k, n = shape
    variant = sorted(VARIANTS)[SITE_LIKE.index(shape) % len(VARIANTS)]
    rng = np.random.default_rng(SITE_LIKE.index(shape))
    (jx, x), (jy, y) = _bf16(rng, m, k, scale=k ** -0.5), _bf16(rng, k, n)
    (jb, b), (jr, r) = _bf16(rng, m), _bf16(rng, m, n)
    assert plan(x, y, variant)["route"] == "wgmma"
    bm, bk, bn = REF_VARIANTS[variant]
    want = ref_matmul(jx, jy, bm=bm, bk=bk, bn=bn, bias=jb, residual=jr,
                      relu=True, out_dtype=jdt, interpret=True)
    got = matmul_op(x, y, variant, bias=b, residual=r, relu=True, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("bcast", ["x", "y", "none"])
def test_wgmma_matmul_batch_op_matches_reference(bcast):
    """bf16 ``matmul_batch_op`` on resnet18's aligned per-image GEMMs cut to
    two images (M = 64, K = 576, N = 784), weights or patches broadcast over
    the batch or neither: the wgmma route, equal to the reference's
    ``matmul_batch`` with the full epilogue (fp32 output)."""
    B, M, K, N = 2, 64, 576, 784
    rng = np.random.default_rng(7)
    if bcast == "x":
        jx1, x1 = _bf16(rng, M, K, scale=K ** -0.5)
        jx, x = jnp.broadcast_to(jx1, (B, M, K)), x1.expand(B, M, K)
    else:
        jx, x = _bf16(rng, B, M, K, scale=K ** -0.5)
    if bcast == "y":
        jy1, y1 = _bf16(rng, K, N)
        jy, y = jnp.broadcast_to(jy1, (B, K, N)), y1.expand(B, K, N)
    else:
        jy, y = _bf16(rng, B, K, N)
    (jb, b), (jr, r) = _bf16(rng, M), _bf16(rng, B, M, N)
    assert plan(x, y, "mm-256x128x256")["route"] == "wgmma"
    want = ref_matmul_batch(jx, jy, bm=128, bk=128, bn=256, bias=jb, residual=jr,
                            relu=True, out_dtype=jnp.float32, interpret=True)
    got = matmul_batch_op(x, y, "mm-256x128x256", bias=b, residual=r, relu=True,
                          out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("tile", WGMMA_TILES, ids=lambda t: "x".join(map(str, t)))
def test_every_wgmma_tile_explicit_call_on_the_cpu(tile):
    """Every wgmma tile named explicitly, split or not: the CPU computes
    the plain version (fp32 sum, epilogue, one cast), so the explicit
    route's checks accept every instantiated tile."""
    bm, bn, stages = tile
    rng = np.random.default_rng(11)
    _, x = _bf16(rng, 200, 264, scale=264 ** -0.5)
    _, y = _bf16(rng, 264, 136)
    want = x.float() @ y.float()
    for split in (1, 3):
        got = matmul(x, y, bm=bm, bn=bn, stages=stages, split_k=split,
                     route="wgmma", out_dtype=torch.float32)
        torch.testing.assert_close(got, want, **F32_TOL)


@pytest.fixture
def fake_launch(monkeypatch):
    """matmul's wrappers as on the card, with the C entry points replaced by
    a recorder: {symbol: [argument tuples]}; the launch counters count."""
    from repro_torch.kernels.matmul import matmul as mm
    calls = {}

    def bind(lib, symbol, *counts, **kw):
        return lambda *args: calls.setdefault(symbol, []).append(args) or 0
    monkeypatch.setattr(mm, "on_cpu", lambda *a, **k: False)
    monkeypatch.setattr(mm, "bind", bind)
    monkeypatch.setattr(mm, "stream_of", lambda t: 0)
    common.reset_launches()
    yield calls
    common.reset_launches()


def test_launch_records_the_route_and_its_entry_point(fake_launch):
    """Each route calls its own C entry point with its full argument list
    (wgmma: ``rt_matmul_wgmma_bf16``, 6 pointers, 14 ints, 2 strides and
    the stream; mma.sync as before), and the launch signature records the
    route, its ring and the loaders (None on mma.sync) after bias, residual
    and ReLU, so ``sig[-2]`` stays the operand dtype; both count under
    ``matmul`` / ``matmul_batch``."""
    x, y = torch.zeros(128, 256, dtype=BF), torch.zeros(256, 128, dtype=BF)
    b = torch.zeros(128)
    matmul_op(x, y, "mm-256x256x256", bias=b)
    matmul(x, y, bm=64, bk=32, bn=64)
    matmul_batch_op(x.expand(2, 128, 256), torch.zeros(2, 256, 128, dtype=BF))
    matmul_batch_op(x.expand(2, 128, 256), torch.zeros(2, 256, 9, dtype=BF))
    assert len(fake_launch["rt_matmul_wgmma_bf16"]) == 3
    assert all(len(a) == 23 for a in fake_launch["rt_matmul_wgmma_bf16"])
    assert len(fake_launch["rt_matmul_bf16"][0]) == 18
    bm, bn, bk, stages, split = wgmma_plan(128, 128, 256, 1, "mm-256x256x256")
    assert (bm, bn, stages, split) == (128, 128, 4, 4)    # one tile: K split
    sigs = sorted(common.SEEN["matmul"], key=repr)
    assert sigs == sorted([
        (128, 256, 128, 128, 64, 128, 4, "float32", False, False, "wgmma", 4,
         "tma/tma", "bfloat16", "bfloat16"),
        (128, 256, 128, 64, 32, 64, 1, False, False, False, "mma.sync", 3, None,
         "bfloat16", "bfloat16")], key=repr)
    bsigs = sorted(common.SEEN["matmul_batch"], key=lambda s: s[3])
    assert [s[3] for s in bsigs] == [9, 128]
    assert all(s[4:6] == (True, False) for s in bsigs)
    assert bsigs[1][-5:] == ("wgmma", 4, "tma/tma", "bfloat16", "bfloat16")
    # N = 9 off 8, the weights broadcast: B gathered, packed across the two
    # entries (tiles counted over 18 columns, so K is split)
    assert bsigs[0][-5:] == ("wgmma", 4, "tma/gather", "bfloat16", "bfloat16")
    bm, bn, _, _, split = wgmma_plan(128, 9, 256, 2, "mm-128x128x128", "tma/gather", True)
    assert (bm, bn) == (128, 64) and bsigs[0][6:10] == (bm, 64, bn, split)
    args = fake_launch["rt_matmul_wgmma_bf16"][1]
    assert args[6:10] == (2, 128, 128, 256) and args[-3:-1] == (0, 256 * 128)
    assert args[18:20] == (0, 0)                          # no operand gathered
    assert fake_launch["rt_matmul_wgmma_bf16"][2][18:20] == (0, 1)
    assert common.LAUNCHES["matmul"] == 2 and common.LAUNCHES["matmul_batch"] == 2
