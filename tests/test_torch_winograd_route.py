"""The two routes of the bf16 Winograd point-GEMM on the CPU: the route
rule (``winograd/ops.route``, ``winograd.takes_wgmma``), the wgmma plan
(``ops.wgmma_plan``) on resnet18's 13 F(2x2) point-GEMMs, the tiles
``csrc/winograd_wgmma.cu`` instantiates, the refusals of a wgmma call on
operands it cannot take, the launch signature's route field and
chip_smoke.py's reading of it, and both routes' wrappers against the JAX
reference.

Inputs are numpy normals from a seed, rounded once to bf16; the same bf16
values go through the reference's ``winograd_point_gemm`` /
``winograd_point_gemm_batch`` in interpret mode and through the port's CPU
path (each wrapper's plain version, whichever route the call names).
Tolerance: the reference's ``_TOL[bfloat16]`` (5e-2 relative and absolute,
``tests/test_kernels.py:19-20``). On the card the wgmma kernel is held to
the plain version in ``tests/test_torch_winograd_wgmma.py`` and
``chip_smoke.py``.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.winograd.winograd import winograd_point_gemm as ref_point_gemm
from repro.kernels.winograd.winograd import (
    winograd_point_gemm_batch as ref_point_gemm_batch)
from repro_torch.kernels import common
from repro_torch.kernels.matmul.ops import VARIANTS as MM_VARIANTS
from repro_torch.kernels.winograd import winograd as wino_mod
from repro_torch.kernels.winograd.ops import VARIANTS as WINO_VARIANTS
from repro_torch.kernels.winograd.ops import (columns, cta_plan, plan, route,
                                              wgmma_plan)
from repro_torch.kernels.winograd.winograd import (ROUTES, TILE_N, WGMMA_BK,
                                                   WGMMA_BN, WGMMA_MIN_COLS,
                                                   WGMMA_MIN_K, WGMMA_PACK_T,
                                                   WGMMA_TILE_M, WGMMA_TILES,
                                                   takes_wgmma,
                                                   winograd_point_gemm,
                                                   winograd_point_gemm_batch)

ROOT = Path(__file__).resolve().parents[1]
WINO_WGMMA_CU = ROOT / "src" / "repro_torch" / "csrc" / "winograd_wgmma.cu"
SMEM = 232448                             # shared memory one H100 block can use
BF16_TOL = dict(rtol=5e-2, atol=5e-2)     # tests/test_kernels.py::_TOL[bfloat16]
VARIANTS = sorted(WINO_VARIANTS) + sorted(MM_VARIANTS)
# (C, T) of resnet18's 13 3x3 stride-1 convs at F(2x2) (K = C), as phase 5
# of chip_smoke.py drives them: T = ceil((H - 2) / 2)^2 tiles of an image
RESNET18 = [(64, 2916), (64, 2809), (64, 2704), (64, 2601), (128, 576),
            (128, 529), (128, 484), (256, 100), (256, 81), (256, 64),
            (512, 9), (512, 4), (512, 1)]


def _pair(rng, *shape, scale=1.0):
    """(JAX array, torch tensor) holding the same bf16 values: numpy
    normals rounded once to bf16."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    t = t.to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _hold(got, want):
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **BF16_TOL)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _offset(t, offset):
    """A contiguous copy of ``t`` starting ``offset`` elements into a
    buffer of its dtype (a view off 16 bytes)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype)
    buf[offset:].copy_(t.reshape(-1))
    return buf[offset:].view(t.shape)


# ---------------------------------------------------------------------------
# The route rule and the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["bf16", "fp32", "k63", "c20", "u_off",
                                  "v_off"])
def test_point_gemm_route_rule(case):
    """bf16 u and v with K >= 64, C % 8 == 0 and u 16-byte aligned take
    wgmma, whatever T and wherever v starts; fp32, K < 64, C % 8 != 0 and a
    u off 16 bytes take mma.sync, under every variant, one image and b =
    8."""
    rng = np.random.default_rng(0)
    u = _pair(rng, 16, 64, 24)[1]
    v = _pair(rng, 2, 16, 24, 9)[1]
    if case == "fp32":
        u, v = u.float(), v.float()
    elif case == "k63":
        u = u[:, :63].contiguous()
    elif case == "c20":
        u, v = u[:, :, :20].contiguous(), v[:, :, :20].contiguous()
    elif case == "u_off":
        u = _offset(u, 1)
    elif case == "v_off":
        v = _offset(v, 3)
    want = "wgmma" if case in ("bf16", "v_off") else "mma.sync"
    assert route(u, v) == want and takes_wgmma(u, v) == (want == "wgmma")
    assert {plan(u, vv, var)["route"] for var in VARIANTS
            for vv in (v, v[0])} == {want}


@pytest.mark.parametrize("N,T,want", [
    (1, 1, "mma.sync"), (1, 4, "mma.sync"), (1, 7, "mma.sync"), (1, 8, "wgmma"),
    (1, 9, "wgmma"), (3, 1, "mma.sync"), (4, 2, "wgmma"), (8, 1, "wgmma"),
    (2, 100, "wgmma")])
def test_point_gemm_route_rule_columns(N, T, want):
    """A bf16 call the wgmma kernel can take goes to it only with at
    least ``WGMMA_MIN_COLS`` (mma.sync's narrowest tile, 8) output columns:
    T on one image, the images' T together where rows shorter than
    ``WGMMA_PACK_T`` are packed. ``takes_wgmma`` still accepts the narrow
    calls (an explicit wgmma call runs them)."""
    assert WGMMA_MIN_COLS == TILE_N[0] == 8
    u, v = _meta(16, 64, 64), _meta(N, 16, 64, T)
    vv = v[0] if N == 1 else v
    assert columns(T, N) == ((N * T, 1) if N > 1 and T < WGMMA_PACK_T else (T, N))
    assert route(u, vv) == plan(u, vv)["route"] == want
    assert takes_wgmma(u, vv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_point_gemm_route_rule_on_resnet18(dtype):
    """resnet18's 13 F(2x2) point-GEMMs (U at the allocator's alignment):
    in bf16 all 13 take wgmma at b = 8 and 11 on one image (the last two
    convs, T = 4 and 1, have too few columns), none in fp32; the mma.sync
    ones keep the plan ``cta_plan`` gives."""
    for C, T in RESNET18:
        u = _meta(16, C, C, dtype=dtype)
        for v in (_meta(16, C, T, dtype=dtype), _meta(8, 16, C, T, dtype=dtype)):
            got = plan(u, v)
            wide = v.dim() == 4 or T >= 8
            assert got["route"] == ("wgmma" if dtype == torch.bfloat16 and wide
                                    else "mma.sync")
            if got["route"] == "mma.sync":
                n = 16 * (1 if v.dim() == 3 else 8)
                bm, bn, bk, split = cta_plan(C, T, C, n, "wino-128x128", dtype)
                assert got == dict(bm=bm, bk=bk, bn=bn, split_k=split, route="mma.sync")
            else:
                bm, bn = wgmma_plan(C, T, 16 * v.shape[0] if v.dim() == 4 else 16,
                                    1 if v.dim() == 3 else v.shape[0])
                assert got == dict(bm=bm, bk=WGMMA_BK, bn=bn, split_k=1, route="wgmma")


@pytest.mark.parametrize("n", [1, 8])
def test_point_gemm_wgmma_plan_on_resnet18(n):
    """The wgmma plan of resnet18's 13 point-GEMMs, on one image and at b =
    8: an instantiated tile, ``WGMMA_BN`` (64) t-values wide; BM the
    smallest covering K (128 above), or 64 where 128 would leave half the
    SMs idle, counting the columns T, or the images' T together where rows
    are shorter than ``WGMMA_PACK_T``. The route runs it ``WGMMA_BK`` deep
    and unsplit."""
    for C, T in RESNET18:
        K, batch = C, 16 * n
        cols, runs = columns(T, n)
        bm, bn = wgmma_plan(K, T, batch, n)
        assert (bm, bn) in WGMMA_TILES and bn == WGMMA_BN
        top = 64 if K <= 64 else 128
        tiles = -(-K // top) * -(-cols // bn) * 16 * runs
        assert bm == (top if 2 * tiles >= common.SMS else 64)
        common.check_plan("point-GEMM", C, bm, WGMMA_BK, bn, 1, WGMMA_TILE_M,
                          (WGMMA_BK,), (WGMMA_BN,))
    # the 64-channel layers on one consumer warpgroup; the 128-channel
    # layers on two; the 256- and 512-channel layers of one image on one
    # (2-4 column tiles a point); b = 8's short rows packed (T = 4: 32
    # columns, one tile a point, so BM drops to 64)
    assert wgmma_plan(64, 2916, 16 * n, n) == (64, 64)
    assert wgmma_plan(128, 576, 16 * n, n) == (128, 64)
    assert wgmma_plan(256, 100, 16 * n, n) == ((64, 64) if n == 1 else (128, 64))
    assert wgmma_plan(512, 4, 16 * n, n) == (64, 64)
    assert wgmma_plan(512, 9, 16 * n, n) == ((64, 64) if n == 1 else (128, 64))
    # K past 128 keeps BM 128 while the tiles fill the card
    assert wgmma_plan(1024, 2916, 16, 1)[0] == 128


def test_point_gemm_wgmma_tiles_match_the_cuda_instantiations():
    """WGMMA_TILES is what csrc/winograd_wgmma.cu instantiates
    (RT_FOR_EACH_WINO_WGMMA_BM by ``kBN`` columns), each within a block's
    shared memory at the kernel's ring depth (the ring, the consumers'
    epilogue staging rows and the barriers), the 64 x 64 tile twice on one
    H100 SM; and the plan packs rows at the kernel's length (``kPackT``:
    one 64-wide box)."""
    src = WINO_WGMMA_CU.read_text()
    body = re.search(r"#define RT_FOR_EACH_WINO_WGMMA_BM\(X\)(.*)", src).group(1)
    bms = tuple(int(v) for v in re.findall(r"X\((\d+)\)", body))
    bn = int(re.search(r"constexpr int kBN = (\d+);", src).group(1))
    assert WGMMA_TILES == tuple((bm, bn) for bm in bms) and bms == WGMMA_TILE_M
    stages = int(re.search(r"constexpr int kStages = (\d+);", src).group(1))
    row = int(re.search(r"constexpr int kStageRow = (\d+);", src).group(1))
    pack = int(re.search(r"constexpr int kPackT = (\d+);", src).group(1))
    assert pack == WGMMA_PACK_T == WGMMA_BN == bn
    assert stages >= 4
    smem = {}
    for bm, bn in WGMMA_TILES:
        staging = bm // 64 * 4 * 16 * row * 4         # each consumer warp's rows
        smem[bm] = 1024 + stages * (bm + bn) * WGMMA_BK * 2 + staging + 16 * stages
        assert smem[bm] <= SMEM
    assert 2 * smem[64] <= 228 * 1024                 # an H100 SM's shared memory
    assert ROUTES == ("mma.sync", "wgmma") and WGMMA_MIN_K == 64


@pytest.mark.parametrize("case", ["fp32", "k63", "c20", "u_off", "tile",
                                  "width", "depth", "split", "name"])
def test_point_gemm_wgmma_refusals_launch_nothing(case):
    """An explicit wgmma call on fp32 operands, fewer than 64 output
    channels, C % 8 != 0 or a u off 16 bytes, a tile or depth it does not
    instantiate, any split of C (the wgmma route never splits), or an unknown
    route raises ``ValueError`` before anything launches: it is never run
    on the other route."""
    u = torch.zeros(16, 64, 72, dtype=torch.bfloat16)
    v = torch.zeros(2, 16, 72, 9, dtype=torch.bfloat16)
    kw = dict(bm=64, bn=64, route="wgmma")
    if case == "fp32":
        u, v = u.float(), v.float()
    elif case == "k63":
        u = u[:, :63].contiguous()
    elif case == "c20":
        u, v = u[:, :, :20].contiguous(), v[:, :, :20].contiguous()
    elif case == "u_off":
        u = _offset(u, 1)
    elif case == "tile":
        kw["bm"] = 32
    elif case == "width":
        kw["bn"] = 128
    elif case == "depth":
        kw["bk"] = 32
    elif case == "split":
        kw["split_k"] = 2                  # C = 72: two 64-deep steps
    else:
        kw["route"] = "tma"
    common.reset_launches()
    with pytest.raises(ValueError, match="wgmma route takes|instantiated|"
                                         "does not split|route must be"):
        winograd_point_gemm_batch(u, v, **kw)
    with pytest.raises(ValueError):
        winograd_point_gemm(u, v[0], **kw)
    assert sum(common.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# The launch signature and chip_smoke.py
# ---------------------------------------------------------------------------

@pytest.fixture
def launched(monkeypatch):
    """The point-GEMM wrappers' launch path on CPU tensors, with a stand-in
    for each C entry point: every call's (library, symbol, number of
    arguments bound, arguments) is recorded, and the launch counted as on
    the card."""
    calls = []

    def bind(lib, symbol, n_ptrs, n_ints):
        return lambda *args: calls.append((lib, symbol, n_ptrs + n_ints + 1, args)) or 0
    monkeypatch.setattr(wino_mod, "on_cpu", lambda *a, **kw: False)
    monkeypatch.setattr(wino_mod, "bind", bind)
    monkeypatch.setattr(wino_mod, "stream_of", lambda t: 0)
    common.reset_launches()
    yield calls
    common.reset_launches()


def test_point_gemm_signature_carries_the_route(launched):
    """A wgmma call binds ``rt_winograd_wgmma_bf16`` of the library
    ``winograd_wgmma`` with as many arguments as it declares (one image as
    N = 1), an mma.sync call its dtype's entry point; each launch signature
    ends with the route, then the dtype, and counts once."""
    u = torch.zeros(16, 64, 72, dtype=torch.bfloat16)
    v = torch.zeros(2, 16, 72, 9, dtype=torch.bfloat16)
    winograd_point_gemm_batch(u, v, bm=128, bn=64, route="wgmma")
    winograd_point_gemm(u, v[0], bm=64, bn=64, route="wgmma")
    winograd_point_gemm(u, v[0], bm=64, bn=64)
    assert [(lib, sym) for lib, sym, *_ in launched] == [
        ("winograd_wgmma", "rt_winograd_wgmma_bf16"),
        ("winograd_wgmma", "rt_winograd_wgmma_bf16"),
        ("winograd_bf16", "rt_winograd_point_gemm_bf16")]
    assert all(n == len(args) for *_, n, args in launched)
    assert launched[0][3][3:-1] == (2, 16, 64, 72, 9, 128)
    assert launched[1][3][3:-1] == (1, 16, 64, 72, 9, 64)
    assert launched[2][3][4:-1] == (16, 64, 72, 9, 64, 64, 32, 1)
    assert list(common.SEEN["winograd_point_gemm_batch"]) == [
        (2, 16, 64, 72, 9, 128, 64, 64, 1, "wgmma", "bfloat16")]
    assert list(common.SEEN["winograd_point_gemm"]) == [
        (16, 64, 72, 9, 64, 64, 64, 1, "wgmma", "bfloat16"),
        (16, 64, 72, 9, 64, 32, 64, 1, "mma.sync", "bfloat16")]
    assert common.LAUNCHES["winograd_point_gemm"] == 2


def test_chip_smoke_reads_the_point_gemm_route():
    """chip_smoke.py reads a point-GEMM launch's route and dtype from the
    signature, names both routes' sources (the library ``winograd_wgmma``
    builds), holds a main-path bf16 point-GEMM to its route
    (``wino_route_of``), replays a signature on its route, and sweeps both
    routes' plans at a bf16 signature the wgmma route takes (the mma.sync
    plans alone at fp32 or K < 64)."""
    smoke = _chip_smoke()
    assert common.LIBRARIES["winograd_wgmma"] == ("winograd_wgmma", ())
    assert (smoke.ROUTE_SOURCES["winograd_point_gemm_batch"]
            == smoke.ROUTE_SOURCES["winograd_point_gemm"] == {
                "mma.sync": "src/repro_torch/csrc/winograd.cu",
                "wgmma": "src/repro_torch/csrc/winograd_wgmma.cu"})
    sig = (8, 16, 64, 64, 2916, 64, 64, 64, 1, "wgmma", "bfloat16")
    one = (16, 512, 512, 1, 128, 64, 64, 1, "wgmma", "bfloat16")
    f32 = (16, 512, 512, 1, 64, 16, 8, 4, "mma.sync", "float32")
    assert smoke.sig_route("winograd_point_gemm_batch", sig) == "wgmma"
    assert smoke.sig_route("winograd_point_gemm", f32) == "mma.sync"
    assert smoke.sig_dtype("winograd_point_gemm", one) == "bfloat16"
    assert (smoke.wino_route_of("bfloat16", 64, 64, 9, 1),
            smoke.wino_route_of("bfloat16", 63, 64, 9, 1),
            smoke.wino_route_of("bfloat16", 64, 20, 9, 1),
            smoke.wino_route_of("float32", 512, 512, 9, 1),
            smoke.wino_route_of("bfloat16", 512, 512, 1, 1),
            smoke.wino_route_of("bfloat16", 512, 512, 1, 8)) == (
                "wgmma", "mma.sync", "mma.sync", "mma.sync", "mma.sync", "wgmma")
    table = smoke.kernel_table(torch)
    swept = table["winograd_point_gemm_batch"]["sweep"](sig)
    assert {s[-2] for s in swept} == {"mma.sync", "wgmma"}
    assert {(s[5], s[6], s[7]) for s in swept if s[-2] == "wgmma"} == {(64, 64, 64)}
    assert all(len(s) == len(sig) for s in swept)
    assert {s[-2] for s in table["winograd_point_gemm"]["sweep"](f32)} == {"mma.sync"}
    assert {s[-2] for s in table["winograd_point_gemm"]["sweep"](one)} == {
        "mma.sync", "wgmma"}
    assert {s[-3] for s in swept + table["winograd_point_gemm"]["sweep"](one)
            if s[-2] == "wgmma"} == {1}
    assert table["winograd_point_gemm_batch"]["work"](sig) == table[
        "winograd_point_gemm_batch"]["work"]((*sig[:9], "mma.sync", "bfloat16"))


# ---------------------------------------------------------------------------
# Both routes against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route_name", ["mma.sync", "wgmma"])
@pytest.mark.parametrize("cfg", [(2, 16, 64, 48, 75), (1, 4, 70, 72, 9),
                                 (3, 16, 96, 8, 1)])
def test_bf16_point_gemm_both_routes_match_reference(cfg, route_name):
    """bf16 point-GEMMs of at least 64 output channels (T = 75, 9 and 1; C =
    48, 72, 8: one 64-deep step or two) through each route's wrappers,
    batched and on one image (a v off 16 bytes too), against the
    reference's kernels in interpret mode at 5e-2; ``ops.plan`` puts them
    on the wgmma route where they have 8 output columns or more (not 3
    images of T = 1)."""
    N, P, K, C, T = cfg
    rng = np.random.default_rng(7)
    (ju, u), (jv, v) = _pair(rng, P, K, C, scale=C ** -0.5), _pair(rng, N, P, C, T)
    want = ref_point_gemm_batch(ju, jv, bk=32, bt=32, bc=32, interpret=True)
    want1 = ref_point_gemm(ju, jv[0], bk=32, bt=32, bc=32, interpret=True)
    kw = (dict(bm=64, bn=64, route="wgmma") if route_name == "wgmma"
          else dict(bm=64, bn=64))
    _hold(winograd_point_gemm_batch(u, v, **kw), want)
    _hold(winograd_point_gemm_batch(u, _offset(v, 1), **kw), want)
    _hold(winograd_point_gemm(u, v[0], **kw), want1)
    assert plan(u, v)["route"] == plan(u, v[0])["route"] == (
        "wgmma" if T > 1 else "mma.sync")
    _hold(winograd_point_gemm_batch(u, v, **plan(u, v)), want)
    _hold(winograd_point_gemm(u, v[0], **plan(u, v[0])), want1)
