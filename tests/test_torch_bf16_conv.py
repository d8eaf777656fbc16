"""The bfloat16 contract of the implicit-GEMM convs and the Winograd
point-GEMMs against the JAX reference, on the CPU: ``conv_im2col``,
``conv_im2col_batch``, ``winograd_point_gemm`` and
``winograd_point_gemm_batch`` (and the conv ``ops`` entry points) take bf16
operands, sum in fp32, apply the epilogue in fp32 (bias and residual bf16
or fp32, widened) and store the operands' dtype once, as the reference's
Pallas kernels do (``src/repro/kernels/im2col_gemm/im2col_gemm.py:66-72``,
``:120``; ``src/repro/kernels/winograd/winograd.py:23-33``, ``:57``). The
Winograd entry points on bf16 x, w, bias and residual transform in fp32 and
return bf16, as the reference's ``winograd_conv`` does
(``src/repro/kernels/winograd/ops.py:28-37``, ``:60-71``).

Inputs are numpy normals from a seed, rounded once to bf16; the same bf16
values go through the reference in interpret mode (the convs with
``fuse_store=True``, so that the reference too rounds once, after its
in-kernel epilogue) and through the port's CPU path (each wrapper's plain
version). Tolerances: a bf16 output at the reference's ``_TOL[bfloat16]``
(5e-2 relative and absolute, ``tests/test_kernels.py:19-20``; one bf16 ulp
is 2^-8 of a value, so two roundings of the same fp32 sum differ by at
most that), an fp32 output at its ``_TOL[float32]`` (1e-4). On the card
the kernels are held to these plain versions in ``tests/test_torch_gpu.py``
(``-k bf16``) and ``chip_smoke.py``.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.im2col_gemm.im2col_gemm import conv_im2col as ref_conv
from repro.kernels.im2col_gemm.im2col_gemm import conv_im2col_batch as ref_conv_batch
from repro.kernels.im2col_gemm.ops import conv_im2col_batch_op as ref_conv_batch_op
from repro.kernels.im2col_gemm.ops import conv_im2col_op as ref_conv_op
from repro.kernels.winograd.ops import winograd_conv as ref_wino_conv
from repro.kernels.winograd.ops import winograd_conv_batch as ref_wino_conv_batch
from repro.kernels.winograd.winograd import winograd_point_gemm as ref_point_gemm
from repro.kernels.winograd.winograd import (
    winograd_point_gemm_batch as ref_point_gemm_batch)
from repro_torch.kernels import common
from repro_torch.kernels.im2col_gemm.im2col_gemm import (TILE_K, TILE_K_BF16,
                                                         WGMMA_BK, WGMMA_TILE_M,
                                                         WGMMA_TILE_N, WGMMA_TILES,
                                                         conv_im2col,
                                                         conv_im2col_batch,
                                                         takes_wgmma)
from repro_torch.kernels.im2col_gemm.ops import VARIANTS as CONV_VARIANTS
from repro_torch.kernels.im2col_gemm.ops import (WGMMA_BM, WGMMA_BN, ceiling,
                                                 conv_im2col_batch_op,
                                                 conv_im2col_op, cta_plan, plan,
                                                 route, wgmma_plan)
from repro_torch.models import cnn_zoo
from repro_torch.kernels.winograd import winograd as wino_mod
from repro_torch.kernels.winograd.ops import VARIANTS as WINO_VARIANTS
from repro_torch.kernels.winograd.ops import ceiling as wino_ceiling
from repro_torch.kernels.winograd.ops import cta_plan as wino_cta_plan
from repro_torch.kernels.winograd.ops import winograd_conv, winograd_conv_batch
from repro_torch.kernels.matmul.ops import VARIANTS as MM_VARIANTS
from repro_torch.kernels.winograd.winograd import (winograd_point_gemm,
                                                   winograd_point_gemm_batch)

ROOT = Path(__file__).resolve().parents[1]
CONV_WGMMA_CU = ROOT / "src" / "repro_torch" / "csrc" / "conv_wgmma.cu"
SMEM = 232448                             # shared memory one H100 block can use
F32_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py::_TOL[float32]
BF16_TOL = dict(rtol=5e-2, atol=5e-2)     # tests/test_kernels.py::_TOL[bfloat16]
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
# bias and residual: none; of the operands' dtype; fp32 (which the
# reference widens as it does bf16 ones); ReLU with either
EPILOGUES = {"none": (None, False), "same": ("same", True), "f32": ("f32", True)}


def _pair(rng, dtype, *shape, scale=1.0):
    """(JAX array, torch tensor) holding the same values of ``dtype`` (a
    ``DTYPES`` key or ``"f32"``): numpy normals, rounded once to bf16 for
    ``"bf16"``."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
        return jnp.asarray(t.float().numpy(), jnp.bfloat16), t
    return jnp.asarray(t.numpy()), t


def _epilogue(rng, dtype, ep, bias_shape, res_shape):
    """(JAX kwargs, torch kwargs) of one ``EPILOGUES`` entry: bias and
    residual of the operands' ``dtype`` or fp32, and ReLU."""
    kind, relu = EPILOGUES[ep]
    if kind is None:
        return {}, {}
    edt = dtype if kind == "same" else "f32"
    (jb, b), (jr, r) = _pair(rng, edt, *bias_shape), _pair(rng, edt, *res_shape)
    return (dict(bias=jb, residual=jr, relu=relu),
            dict(bias=b, residual=r, relu=relu))


def _hold(got, want, tdt, tol):
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)


# ---------------------------------------------------------------------------
# conv_im2col, conv_im2col_batch and their ops entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ep", sorted(EPILOGUES))
@pytest.mark.parametrize("cfg", [(8, 16, 16, 3, 1), (4, 19, 8, 3, 2),
                                 (3, 14, 32, 5, 1), (8, 9, 8, 1, 1),
                                 (5, 12, 20, 3, 1)])
def test_bf16_conv_im2col_matches_reference(cfg, ep):
    """The reference test's shapes (``tests/test_kernels.py:77-79``) on one
    bf16 image: ``conv_im2col`` (default tile) and ``conv_im2col_op`` return
    bf16 within the bf16 tolerance of the reference's fused kernel, with no
    epilogue, or bias and residual (bf16 or fp32) and ReLU."""
    jdt, tdt, tol = DTYPES["bf16"]
    C, H, K, f, s = cfg
    oh = (H - f) // s + 1
    rng = np.random.default_rng(0)
    (jx, x), (jw, w) = _pair(rng, "bf16", C, H, H), _pair(rng, "bf16", K, C, f, f)
    jep, tep = _epilogue(rng, "bf16", ep, (K,), (K, oh, oh))
    want = ref_conv(jx, jw, s, bk=16, interpret=True, fuse_store=True, **jep)
    assert want.dtype == jdt
    _hold(conv_im2col(x, w, s, **tep), want, tdt, tol)
    _hold(conv_im2col_op(x, w, s, **tep), want, tdt, tol)


@pytest.mark.parametrize("ep", sorted(EPILOGUES))
@pytest.mark.parametrize("cfg", [(2, 4, 16, 8, 3, 1), (3, 4, 19, 8, 3, 2),
                                 (2, 3, 14, 32, 5, 1), (2, 8, 9, 8, 1, 1)])
def test_bf16_conv_im2col_batch_matches_reference(cfg, ep):
    """The reference test's batched shapes (``tests/test_kernels.py:123-124``)
    in bf16: ``conv_im2col_batch`` and ``conv_im2col_batch_op``, each
    epilogue, against the reference's fused batched kernel."""
    jdt, tdt, tol = DTYPES["bf16"]
    N, C, H, K, f, s = cfg
    oh = (H - f) // s + 1
    rng = np.random.default_rng(1)
    (jx, x), (jw, w) = _pair(rng, "bf16", N, C, H, H), _pair(rng, "bf16", K, C, f, f)
    jep, tep = _epilogue(rng, "bf16", ep, (K,), (N, K, oh, oh))
    want = ref_conv_batch(jx, jw, s, bk=16, interpret=True, fuse_store=True, **jep)
    assert want.dtype == jdt
    _hold(conv_im2col_batch(x, w, s, **tep), want, tdt, tol)
    _hold(conv_im2col_batch_op(x, w, s, **tep), want, tdt, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(CONV_VARIANTS))
def test_conv_ops_every_variant_in_both_dtypes(variant, dtype):
    """``conv_im2col_op`` and ``conv_im2col_batch_op`` under every
    ``conv-bk*`` variant against the reference's op under the same variant,
    bias and residual of the operands' dtype and ReLU: bf16 in bf16 at
    5e-2, fp32 in fp32 at 1e-4 (unchanged by the bf16 contract)."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    C, H, K, f, s = 6, 13, 40, 3, 2
    oh = (H - f) // s + 1
    (jx, x), (jw, w) = _pair(rng, dtype, 2, C, H, H), _pair(rng, dtype, K, C, f, f)
    jep, tep = _epilogue(rng, dtype, "same", (K,), (2, K, oh, oh))
    want = ref_conv_batch_op(jx, jw, s, variant, interpret=True, fuse_store=True, **jep)
    _hold(conv_im2col_batch_op(x, w, s, variant, **tep), want, tdt, tol)
    jep1 = dict(jep, residual=jep["residual"][0])
    tep1 = dict(tep, residual=tep["residual"][0])
    want = ref_conv_op(jx[0], jw, s, variant, interpret=True, fuse_store=True, **jep1)
    _hold(conv_im2col_op(x[0], w, s, variant, **tep1), want, tdt, tol)


@pytest.mark.parametrize("variant", sorted(CONV_VARIANTS))
def test_bf16_conv_tile_rule(variant):
    """A bf16 conv plan keeps the fp32 plan's BM and BN and doubles its
    depth (a stage of the same bytes, a multiple of the bf16 mma's 16), an
    instantiated bf16 depth; the fp32 plan is unchanged."""
    bm, bk, bn = ceiling(variant)
    assert ceiling(variant, torch.bfloat16) == (bm, 2 * bk, bn)
    for K, P, R in [(64, 8 * 109 * 109, 147), (512, 9, 4608), (16, 900, 27)]:
        p32, p16 = cta_plan(K, P, R, variant), cta_plan(K, P, R, variant, torch.bfloat16)
        assert p32[2] in TILE_K and p16[2] in TILE_K_BF16 and p16[2] % 16 == 0
        assert p16[:2] == p32[:2]


# ---------------------------------------------------------------------------
# winograd_point_gemm, winograd_point_gemm_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_point_gemm_matches_reference(dtype):
    """The reference test's shapes (``tests/test_kernels.py:88-93``): u (16,
    60, 48), v (16, 48, 75) -> the operands' dtype, under the port's default
    tile and under a split ``wino-*`` plan at the dtype."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    (ju, u), (jv, v) = _pair(rng, dtype, 16, 60, 48), _pair(rng, dtype, 16, 48, 75)
    want = ref_point_gemm(ju, jv, bk=32, bt=32, bc=32, interpret=True)
    assert want.dtype == jdt
    _hold(winograd_point_gemm(u, v), want, tdt, tol)
    bm, bn, bk, _ = wino_cta_plan(60, 75, 48, 16, "wino-128x128", tdt)
    _hold(winograd_point_gemm(u, v, bm=bm, bk=bk, bn=bn, split_k=2), want, tdt, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_point_gemm_batch_matches_reference(dtype):
    """The reference test's batched shapes (``tests/test_kernels.py:134-140``):
    u (16, 60, 48) shared, v (2, 16, 48, 75) -> (2, 16, 60, 75) in the
    operands' dtype."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(4)
    (ju, u), (jv, v) = _pair(rng, dtype, 16, 60, 48), _pair(rng, dtype, 2, 16, 48, 75)
    want = ref_point_gemm_batch(ju, jv, bk=32, bt=32, bc=32, interpret=True)
    assert want.dtype == jdt
    _hold(winograd_point_gemm_batch(u, v), want, tdt, tol)
    bm, bn, bk, _ = wino_cta_plan(60, 75, 48, 32, "mm-128x128x256", tdt)
    _hold(winograd_point_gemm_batch(u, v, bm=bm, bk=bk, bn=bn, split_k=2), want,
          tdt, tol)


@pytest.mark.parametrize("variant", sorted(WINO_VARIANTS) + sorted(MM_VARIANTS))
def test_bf16_point_gemm_tile_rule(variant):
    """A bf16 point-GEMM plan keeps the fp32 plan's BM and BN and doubles
    its depth, an instantiated bf16 depth of csrc/winograd.cu."""
    bm, bk, bn = wino_ceiling(variant)
    assert wino_ceiling(variant, torch.bfloat16) == (bm, 2 * bk, bn)
    for K, T, C, batch in [(64, 2916, 64, 128), (512, 9, 512, 128), (16, 1, 3, 16)]:
        p32 = wino_cta_plan(K, T, C, batch, variant)
        p16 = wino_cta_plan(K, T, C, batch, variant, torch.bfloat16)
        assert p32[2] in wino_mod.TILE_K and p16[2] in wino_mod.TILE_K_BF16
        assert p16[:2] == p32[:2]


# ---------------------------------------------------------------------------
# The Winograd entry points on bf16 operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("batch", [False, True])
def test_bf16_winograd_conv_matches_reference(batch, m):
    """``winograd_conv`` / ``winograd_conv_batch`` on bf16 x, w, bias and
    residual with ReLU: the transforms and the point-GEMM run in fp32, bias
    and residual are widened to fp32 before the inverse transform's
    epilogue (the reference's ``_epilogue``), and the output is bf16,
    against the reference's entry point in interpret mode."""
    C, H, K = 4, 14, 8
    lead = (2,) if batch else ()
    rng = np.random.default_rng(5)
    (jx, x), (jw, w) = _pair(rng, "bf16", *lead, C, H, H), _pair(rng, "bf16", K, C, 3, 3)
    (jb, b), (jr, r) = _pair(rng, "bf16", K), _pair(rng, "bf16", *lead, K, H - 2, H - 2)
    ref, port = ((ref_wino_conv_batch, winograd_conv_batch) if batch
                 else (ref_wino_conv, winograd_conv))
    want = ref(jx, jw, m=m, bias=jb, residual=jr, relu=True, interpret=True)
    assert want.dtype == jnp.bfloat16
    _hold(port(x, w, m=m, bias=b, residual=r, relu=True), want, torch.bfloat16,
          BF16_TOL)


# ---------------------------------------------------------------------------
# The wgmma route of the bf16 conv (csrc/conv_wgmma.cu): the rule that picks
# it, its plans and tiles, its refusals, chip_smoke.py's reading of it, and
# both routes' wrappers against the reference
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _convs(net):
    """(C, H, K, f, s) of every conv of ``net`` at its input's actual size,
    as chip_smoke.py's phase 5 drives them."""
    return [layer[1:] for layer in _chip_smoke().conv_layers(cnn_zoo.get(net))]


def _meta(*shape, dtype):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("net", ["resnet18", "edge_cnn"])
def test_conv_route_rule_on_the_nets(net, dtype):
    """Every conv of resnet18 (20, all of at least 64 output channels) and
    edge_cnn (14): bf16 with K >= 64 takes the wgmma route, fp32 or K < 64
    mma.sync, under every variant, one image and b = 8."""
    tdt = DTYPES[dtype][1]
    convs = _convs(net)
    assert len(convs) == {"resnet18": 20, "edge_cnn": 14}[net]
    routes = []
    for C, H, K, f, s in convs:
        x, w = _meta(C, H, H, dtype=tdt), _meta(K, C, f, f, dtype=tdt)
        want = "wgmma" if dtype == "bf16" and K >= 64 else "mma.sync"
        assert route(x, w) == want and takes_wgmma(x, w) == (want == "wgmma")
        assert {plan(n, x, w, s, v)["route"] for v in CONV_VARIANTS
                for n in (1, 8)} == {want}
        routes.append(want)
    if dtype == "bf16":
        assert routes.count("wgmma") == {"resnet18": 20, "edge_cnn": 5}[net]


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("net", ["resnet18", "edge_cnn"])
def test_conv_wgmma_plan_splits_only_to_fill_the_card(net, n):
    """The wgmma plan of every conv with K >= 64, on one image and at b = 8,
    under every variant: an instantiated tile, BM the smallest covering K
    under the variant's ceiling, BN the smallest covering the pixels under
    the BM's widest, narrowed only while the tiles would leave half the SMs
    idle, BK 64; R split only where the output tiles leave SMs idle, into
    no more slices than one wave holds, each slice owning a 64-deep step
    (``common.check_plan`` accepts it)."""
    for C, H, K, f, s in _convs(net):
        if K < 64:
            continue
        oh = (H - f) // s + 1
        P, R = n * oh * oh, C * f * f
        for v in CONV_VARIANTS:
            bm, bn, bk, split = wgmma_plan(K, P, R, v)
            assert (bm, bn) in WGMMA_TILES and bk == WGMMA_BK
            assert bm == min(t for t in WGMMA_TILE_M if t >= min(K, WGMMA_BM[v]))
            widest = min(t for t in WGMMA_TILE_N if t >= min(P, WGMMA_BN[bm]))
            mt = -(-K // bm)
            assert bn == widest or 2 * mt * -(-P // (2 * bn)) < common.SMS
            assert bn == WGMMA_TILE_N[0] or 2 * mt * -(-P // bn) >= common.SMS
            tiles, steps = mt * -(-P // bn), -(-R // bk)
            common.check_plan("conv", R, bm, bk, bn, split, WGMMA_TILE_M,
                              (WGMMA_BK,), WGMMA_TILE_N)
            if split > 1:
                assert tiles < common.SMS and tiles * split <= common.SMS
                assert (split - 1) * -(-steps // split) < steps
            else:
                assert tiles >= common.SMS or steps == 1 or common.SMS // tiles < 2
    # resnet18's late layers split on one image; its 64-channel layers at
    # b = 8 fill the card unsplit on 256 pixels a tile, and on one image
    # take 128 (90 tiles, not 45)
    assert wgmma_plan(512, 9, 4608, "conv-bk128")[3] > 1
    assert wgmma_plan(64, 8 * 107 * 107, 576, "conv-bk128") == (64, 256, 64, 1)
    assert wgmma_plan(64, 107 * 107, 576, "conv-bk128") == (64, 128, 64, 1)
    assert wgmma_plan(128, 8 * 48 * 48, 1152, "conv-bk256") == (128, 64, 64, 1)


def test_conv_wgmma_tiles_match_the_cuda_instantiations():
    """WGMMA_TILES is what csrc/conv_wgmma.cu instantiates
    (RT_FOR_EACH_CONV_WGMMA_TILE), each within a block's shared memory at
    the kernel's ring depth (the ring, the producers' offset tables, the
    consumers' epilogue staging and the barriers); every BM's widest BN is
    one of them, and conv-bk256 runs as its 128-row twin."""
    src = CONV_WGMMA_CU.read_text()
    body = re.search(r"#define RT_FOR_EACH_CONV_WGMMA_TILE\(X\)((?:.*\\\n)*.*)",
                     src).group(1)
    tiles = tuple(tuple(int(v) for v in t)
                  for t in re.findall(r"X\((\d+), (\d+)\)", body))
    assert sorted(tiles) == sorted(WGMMA_TILES) and len(set(tiles)) == len(tiles)
    stages = int(re.search(r"constexpr int kStages = (\d+);", src).group(1))
    assert stages == 4
    for bm, bn in WGMMA_TILES:
        staging = bm // 64 * 4 * 16 * 40 * 4            # each consumer warp's rows
        assert 1024 + stages * (bm + bn) * WGMMA_BK * 2 + 1024 + staging + 16 * stages <= SMEM
    assert set(WGMMA_BN.items()) <= set(WGMMA_TILES)
    assert WGMMA_BM == {"conv-bk64": 64, "conv-bk128": 128, "conv-bk256": 128}


@pytest.mark.parametrize("case", ["fp32", "k63", "tile", "depth", "split",
                                  "name"])
def test_conv_wgmma_refusals_launch_nothing(case):
    """An explicit wgmma call on fp32 operands or on fewer than 64 output
    channels, an uninstantiated tile, depth or split, or an unknown route
    raises ``ValueError`` before anything launches."""
    x, w = torch.zeros(2, 8, 9, 9, dtype=torch.bfloat16), torch.zeros(64, 8, 3, 3,
                                                                       dtype=torch.bfloat16)
    kw = dict(bm=64, bn=128, route="wgmma")
    if case == "fp32":
        x, w = x.float(), w.float()
    elif case == "k63":
        w = w[:63]
    elif case == "tile":
        kw["bm"] = 32
    elif case == "depth":
        kw["bk"] = 32
    elif case == "split":
        kw["split_k"] = 3                  # R = 72: two 64-deep steps
    else:
        kw["route"] = "tma"
    common.reset_launches()
    with pytest.raises(ValueError, match="wgmma route takes|instantiated|split_k|"
                                         "route must be"):
        conv_im2col_batch(x, w, 1, **kw)
    with pytest.raises(ValueError):
        conv_im2col(x[0], w, 1, **kw)
    assert sum(common.LAUNCHES.values()) == 0


def test_chip_smoke_reads_the_conv_route():
    """chip_smoke.py reads a conv launch's route, dtype and output channels
    from the signature, names both routes' sources (the library
    ``conv_wgmma`` builds), holds a main-path bf16 conv of K >= 64 to the
    wgmma route, and sweeps both routes' plans at such a signature (the
    mma.sync plans alone at fp32 or K < 64)."""
    smoke = _chip_smoke()
    assert common.LIBRARIES["conv_wgmma"] == ("conv_wgmma", ())
    assert smoke.ROUTE_SOURCES["conv_im2col_batch"] == smoke.ROUTE_SOURCES["conv_im2col"] == {
        "mma.sync": "src/repro_torch/csrc/im2col_gemm.cu",
        "wgmma": "src/repro_torch/csrc/conv_wgmma.cu"}
    sig = (8, 64, 109, 109, 64, 3, 1, 64, 64, 128, 1, "bfloat16", "bfloat16",
           True, "wgmma", "bfloat16")
    one = (3, 224, 224, 64, 7, 2, 128, 32, 64, 1, False, False, False,
           "mma.sync", "float32")
    assert smoke.sig_route("conv_im2col_batch", sig) == "wgmma"
    assert smoke.sig_route("conv_im2col", one) == "mma.sync"
    assert smoke.sig_dtype("conv_im2col_batch", sig) == "bfloat16"
    assert (smoke.sig_conv_k("conv_im2col_batch", sig),
            smoke.sig_conv_k("conv_im2col", one)) == (64, 64)
    assert (smoke.conv_route_of("bfloat16", 64), smoke.conv_route_of("bfloat16", 63),
            smoke.conv_route_of("float32", 512)) == ("wgmma", "mma.sync", "mma.sync")
    table = smoke.kernel_table(torch)
    swept = table["conv_im2col_batch"]["sweep"](sig)
    assert {s[-2] for s in swept} == {"mma.sync", "wgmma"}
    assert {(s[7], s[9]) for s in swept if s[-2] == "wgmma"} == {(64, 256)}
    assert {s[-2] for s in table["conv_im2col"]["sweep"](one)} == {"mma.sync"}
    assert table["conv_im2col_batch"]["work"](sig) == table["conv_im2col_batch"]["work"](
        (*sig[:14], "mma.sync", "bfloat16"))


@pytest.mark.parametrize("route_name", ["mma.sync", "wgmma"])
@pytest.mark.parametrize("cfg", [(2, 4, 11, 64, 3, 1), (1, 3, 15, 72, 7, 2),
                                 (2, 8, 9, 66, 1, 2)])
def test_bf16_conv_both_routes_match_reference(cfg, route_name):
    """bf16 convs of at least 64 output channels (R = 36, 147 and 8: weights
    the wgmma kernel gathers itself and one 64-deep step) through each
    route's wrappers, batched and on one image, bf16 bias and residual and
    ReLU, against the reference's fused kernel at 5e-2; the entry points
    plan them onto the wgmma route."""
    jdt, tdt, tol = DTYPES["bf16"]
    N, C, H, K, f, s = cfg
    oh = (H - f) // s + 1
    rng = np.random.default_rng(6)
    (jx, x), (jw, w) = _pair(rng, "bf16", N, C, H, H), _pair(rng, "bf16", K, C, f, f)
    jep, tep = _epilogue(rng, "bf16", "same", (K,), (N, K, oh, oh))
    want = ref_conv_batch(jx, jw, s, bk=16, interpret=True, fuse_store=True, **jep)
    kw = (dict(bm=64, bn=128, route="wgmma") if route_name == "wgmma"
          else dict(bm=64, bn=64))
    _hold(conv_im2col_batch(x, w, s, **kw, **tep), want, tdt, tol)
    tep1 = dict(tep, residual=tep["residual"][0])
    _hold(conv_im2col(x[0], w, s, **kw, **tep1), want[0], tdt, tol)
    assert plan(N, x, w, s, "conv-bk128")["route"] == "wgmma"
    _hold(conv_im2col_batch_op(x, w, s, **tep), want, tdt, tol)
