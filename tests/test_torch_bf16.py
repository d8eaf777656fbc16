"""The kernels' bfloat16 contract against the JAX reference, on the CPU:
``matmul``, ``matmul_batch`` and ``flash_attention`` take bf16 operands,
compute in fp32 and store ``out_dtype`` (matmul; default the operands'
dtype) or q's dtype (attention), as the reference's Pallas kernels do (the
convs and the Winograd point-GEMMs: ``tests/test_torch_bf16_conv.py``).

Inputs are numpy normals from a seed, rounded once to bf16; the same bf16
values go through the reference in interpret mode and through the port's
CPU path (each wrapper's plain version: fp32 on the bf16 values, one cast
at the end). Tolerances: ``out_dtype`` float32 at the reference's fp32
``_TOL`` (1e-4: the products of bf16 values are exact in fp32, only the
order of the sums differs; largest error seen 2.3e-5 on sums up to ~60), a
bf16 output at its ``_TOL[bfloat16]`` (5e-2 relative and absolute,
``tests/test_kernels.py:19-20``; largest matmul error seen 0.25, one bf16
ulp of a value in [32, 64); flash attention 1.95e-3). The LM route and the
bf16 prefill are held at the bf16 tolerance too (largest errors seen 1.56e-2
on outputs up to 3.2, and 3.9e-2 on fp32 logits up to 3.1).

Also: an fp32 bias and residual on bf16 operands (the reference's
``_finish`` widens either), ``cta_plan``'s bf16 tile rule,
``MeasuredCost``'s dtype, ``chip_smoke.py``'s bf16 check rejecting a wrong
attention that the 5e-2 tolerance would pass, its bf16 phase-5 passes, the
signatures and bounds of its bf16 conv and point-GEMM rows, and the
refusals: the Winograd transforms take fp32 only (as the reference's do),
no kernel takes fp16 or operands of mixed dtypes (``TypeError``, never a
quiet upcast).
On the card the bf16 kernels are held to these plain versions in
``tests/test_torch_gpu.py`` (``-k bf16``) and ``chip_smoke.py``.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import autotune as JAT
from repro.kernels.flash_attention.ops import flash_attention_op as ref_flash_op
from repro.kernels.matmul.matmul import matmul as ref_matmul
from repro.kernels.matmul.matmul import matmul_batch as ref_matmul_batch
from repro.kernels.matmul.ops import VARIANTS as REF_MM_VARIANTS
from repro.models import components as JC
from repro.models import transformer as JT
from repro_torch.configs import base as cb
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import autotune as AT
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS as FA_HEAD_DIMS
from repro_torch.kernels.flash_attention.flash_attention import TILES as FA_TILES
from repro_torch.kernels.flash_attention.flash_attention import (flash_attention,
                                                                  flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import VARIANTS as FA_VARIANTS
from repro_torch.kernels.flash_attention.ops import cta_tile as fa_cta_tile
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.im2col_gemm.im2col_gemm import conv_im2col, conv_im2col_batch
from repro_torch.kernels.matmul.matmul import (TILE_K, TILE_K_BF16, matmul,
                                               matmul_batch)
from repro_torch.kernels.matmul.ops import (CTA_TILES, VARIANTS, ceiling,
                                            cta_plan, matmul_batch_op,
                                            matmul_op)
from repro_torch.kernels.winograd.winograd import (
    winograd_input_transform, winograd_inverse_transform, winograd_point_gemm,
    winograd_point_gemm_batch)
from repro_torch.models import components as C
from repro_torch.models import transformer as T

F32_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py::_TOL[float32]
BF16_TOL = dict(rtol=5e-2, atol=5e-2)     # tests/test_kernels.py::_TOL[bfloat16]
EPILOGUES = list(itertools.product((False, True), repeat=3))   # bias, res, relu
OUT = {"f32": (jnp.float32, torch.float32, F32_TOL),
       "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _bf16(rng, *shape, scale=1.0):
    """(JAX array, torch tensor) holding the same bf16 values: numpy normals
    rounded once to bf16."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    t = t.to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _hold(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)


# ---------------------------------------------------------------------------
# matmul, matmul_batch and their ops entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out", sorted(OUT))
@pytest.mark.parametrize("shape,blocks", [
    ((256, 256, 256), (128, 128, 128)),
    ((300, 200, 150), (128, 128, 128)),     # non-divisible edges
    ((64, 64, 64), (128, 128, 128)),        # blocks larger than array
    ((100, 77, 33), (32, 32, 32)),
])
def test_bf16_matmul_matches_reference(shape, blocks, out):
    """The reference test's shapes (``tests/test_kernels.py:24-29``):
    ``matmul`` and ``matmul_op`` on bf16 operands in either ``out_dtype``."""
    jdt, tdt, tol = OUT[out]
    m, k, n = shape
    rng = np.random.default_rng(0)
    (jx, x), (jy, y) = _bf16(rng, m, k), _bf16(rng, k, n)
    bm, bk, bn = blocks
    want = ref_matmul(jx, jy, bm=bm, bk=bk, bn=bn, out_dtype=jdt, interpret=True)
    for got in (matmul(x, y, out_dtype=tdt), matmul_op(x, y, out_dtype=tdt)):
        assert got.dtype == tdt and got.shape == (m, n)
        _hold(got, want, tol)
    assert matmul(x, y).dtype == torch.bfloat16      # default: the operands'


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_matmul_op_every_variant(variant):
    """Every ``mm-*`` variant, each against the reference at its own TPU
    blocks, in both output dtypes."""
    rng = np.random.default_rng(1)
    (jx, x), (jy, y) = _bf16(rng, 160, 96), _bf16(rng, 96, 200)
    bm, bk, bn = REF_MM_VARIANTS[variant]
    for jdt, tdt, tol in OUT.values():
        want = ref_matmul(jx, jy, bm=bm, bk=bk, bn=bn, out_dtype=jdt,
                          interpret=True)
        _hold(matmul_op(x, y, variant, out_dtype=tdt), want, tol)


@pytest.mark.parametrize("bias,res,relu", EPILOGUES)
def test_bf16_matmul_epilogues(bias, res, relu):
    """bias (M,) -> residual (M, N) -> ReLU, bf16 like the operands, applied
    in fp32 to the fp32 sum; both output dtypes."""
    rng = np.random.default_rng(2)
    (jx, x), (jy, y) = _bf16(rng, 100, 77), _bf16(rng, 77, 33)
    (jb, b), (jr, r) = _bf16(rng, 100), _bf16(rng, 100, 33)
    jep = dict(bias=jb if bias else None, residual=jr if res else None, relu=relu)
    ep = dict(bias=b if bias else None, residual=r if res else None, relu=relu)
    for jdt, tdt, tol in OUT.values():
        want = ref_matmul(jx, jy, bm=32, bk=32, bn=32, out_dtype=jdt,
                          interpret=True, **jep)
        _hold(matmul(x, y, out_dtype=tdt, **ep), want, tol)
        _hold(matmul_op(x, y, "mm-256x256x256", out_dtype=tdt, **ep), want, tol)


@pytest.mark.parametrize("x_bcast", [False, True])
@pytest.mark.parametrize("out", sorted(OUT))
def test_bf16_matmul_batch_matches_reference(out, x_bcast):
    """``matmul_batch`` and ``matmul_batch_op``: bf16 (B, M, K) @ (B, K, N),
    x broadcast over the batch or not, the full epilogue (bias (M,),
    residual (B, M, N), ReLU)."""
    jdt, tdt, tol = OUT[out]
    B, M, K, N = 3, 40, 50, 70
    rng = np.random.default_rng(3)
    if x_bcast:
        jx1, x1 = _bf16(rng, M, K)
        jx, x = jnp.broadcast_to(jx1, (B, M, K)), x1.expand(B, M, K)
    else:
        jx, x = _bf16(rng, B, M, K)
    (jy, y), (jb, b), (jr, r) = _bf16(rng, B, K, N), _bf16(rng, M), _bf16(rng, B, M, N)
    want = ref_matmul_batch(jx, jy, bm=32, bk=32, bn=32, out_dtype=jdt, bias=jb,
                            residual=jr, relu=True, interpret=True)
    for got in (matmul_batch(x, y, bias=b, residual=r, relu=True, out_dtype=tdt),
                matmul_batch_op(x, y, bias=b, residual=r, relu=True, out_dtype=tdt)):
        assert got.dtype == tdt and got.shape == (B, M, N)
        _hold(got, want, tol)


def _f32(rng, *shape):
    """(JAX array, torch tensor) holding the same fp32 numpy normals."""
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("bias,res", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("out", sorted(OUT))
def test_bf16_matmul_takes_an_fp32_bias_and_residual(out, bias, res, batch):
    """bf16 operands with an fp32 bias and residual, which the reference's
    ``_finish`` widens as it does bf16 ones (``.astype(f32)``): ``matmul``
    and ``matmul_batch`` (and their ops) against the reference on the same
    fp32 epilogue tensors, ReLU on; a bf16 bias beside an fp32 residual
    too."""
    jdt, tdt, tol = OUT[out]
    B, M, K, N = 3, 40, 50, 70
    rng = np.random.default_rng(5)
    lead = (B,) if batch else ()
    (jx, x), (jy, y) = _bf16(rng, *lead, M, K), _bf16(rng, *lead, K, N)
    (jb, b), (jr, r) = _f32(rng, M), _f32(rng, *lead, M, N)
    (jb16, b16) = _bf16(rng, M)
    ref, port, op = ((ref_matmul_batch, matmul_batch, matmul_batch_op) if batch
                     else (ref_matmul, matmul, matmul_op))
    for jbias, tbias in ((jb, b), (jb16, b16)):
        jep = dict(bias=jbias if bias else None, residual=jr if res else None,
                   relu=True)
        ep = dict(bias=tbias if bias else None, residual=r if res else None,
                  relu=True)
        want = ref(jx, jy, bm=32, bk=32, bn=32, out_dtype=jdt, interpret=True,
                   **jep)
        for got in (port(x, y, out_dtype=tdt, **ep), op(x, y, out_dtype=tdt, **ep)):
            assert got.dtype == tdt and got.shape == (*lead, M, N)
            _hold(got, want, tol)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_matmul_batch_op_every_variant(variant):
    rng = np.random.default_rng(4)
    (jx, x), (jy, y) = _bf16(rng, 2, 72, 130), _bf16(rng, 2, 130, 90)
    bm, bk, bn = REF_MM_VARIANTS[variant]
    want = ref_matmul_batch(jx, jy, bm=bm, bk=bk, bn=bn, out_dtype=jnp.float32,
                            interpret=True)
    _hold(matmul_batch_op(x, y, variant, out_dtype=torch.float32), want, F32_TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_tile_rule(variant):
    """The bf16 ceiling keeps the fp32 ceiling's BM and BN and doubles its
    depth (a stage of the same bytes, BK a multiple of the bf16 mma's 16);
    ``cta_plan`` at bf16 always plans an instantiated bf16 depth, and the
    fp32 plan is unchanged."""
    bm, bk, bn = CTA_TILES[variant]
    assert ceiling(variant) == (bm, bk, bn)
    assert ceiling(variant, torch.bfloat16) == (bm, 2 * bk, bn)
    assert 2 * bk in TILE_K_BF16 and 2 * bk % 16 == 0
    for M, N, K, batch in [(4096, 4096, 4096, 1), (64, 7200, 576, 8), (16, 8, 27, 1)]:
        plan32 = cta_plan(M, N, K, batch, variant)
        plan16 = cta_plan(M, N, K, batch, variant, torch.bfloat16)
        assert plan32[2] in TILE_K and plan16[2] in TILE_K_BF16
        assert plan16[:2] == plan32[:2]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cfg", [(2, 256, 8, 2, 64), (1, 128, 4, 4, 32)],
                         ids=["gqa-d64", "mha-d32"])
def test_bf16_flash_attention_op_matches_reference(cfg, causal):
    """bf16 q, k, v (B, S, H, hd), GQA or not -> bf16, against the
    reference's ``flash_attention_op`` in interpret mode."""
    B, S, H, Hkv, d = cfg
    rng = np.random.default_rng(5)
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, B, S, h, d) for h in (H, Hkv, Hkv))
    want = ref_flash_op(jq, jk, jv, causal=causal, interpret=True)
    got = flash_attention_op(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _hold(got, want, BF16_TOL)


@pytest.mark.parametrize("variant", sorted(FA_VARIANTS))
def test_bf16_flash_tile_rule(variant):
    """The bf16 CTA tile keeps the fp32 tile's BQ and steps 64 keys at every
    head dim (8,192 elements of K a step, capped at 64 keys); the fp32 tile
    keeps 4,096 / d. Both are instantiated tiles."""
    for d in FA_HEAD_DIMS:
        bq, bkv = fa_cta_tile(variant, d)
        assert (bq, bkv) == (min(FA_VARIANTS[variant][0] // 2, 128), min(64, 4096 // d))
        assert fa_cta_tile(variant, d, torch.bfloat16) == (bq, 64)
        assert {(bq, bkv), (bq, 64)} <= set(FA_TILES)


def test_bf16_flash_attention_scale_on_fp32_scores():
    """A given scale multiplies the fp32 scores of the bf16 values: the
    plain version equals the fp32 computation on the upcast operands, cast
    once to bf16."""
    rng = np.random.default_rng(6)
    q, k, v = (_bf16(rng, 3, 40, 32)[1] for _ in range(3))
    got = flash_attention(q, k, v, causal=True, scale=0.37)
    want = flash_attention(q.float(), k.float(), v.float(), causal=True, scale=0.37)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# The LM route: bf16 prefills reach the kernel in bf16
# ---------------------------------------------------------------------------

@pytest.fixture
def flash_on_cpu(monkeypatch):
    """``components.flash_routed`` as on the card (a CUDA operand's flags),
    and the operands' dtypes of every ``flash_attention`` call recorded."""
    routed, calls = C.flash_routed, []

    def on_card(q, *a, **kw):
        class OnCard:
            is_cuda, shape, requires_grad = True, q.shape, q.requires_grad
        return routed(OnCard, *a, **kw)

    def recording(q, k, v, **kw):
        calls.append((q.dtype, k.dtype, v.dtype))
        return flash_attention(q, k, v, **kw)
    monkeypatch.setattr(C, "flash_routed", on_card)
    monkeypatch.setattr(C, "flash_attention", recording)
    return calls


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_bf16_flash_route_matches_reference_attention(hd, flash_on_cpu):
    """``_flash_route`` on bf16 q, k, v (GQA, a ragged length): the kernel
    gets them in bf16, no fp32 copy, and the result is the reference's
    plain bf16 attention (``src/repro/models/components.py``) within the
    bf16 tolerance (one bf16 rounding of the same fp32 values apart)."""
    B, S, Hq, Hkv = 2, 37, 8, 2
    rng = np.random.default_rng(7)
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, B, S, h, hd) for h in (Hq, Hkv, Hkv))
    pos = np.arange(S, dtype=np.int32)
    want = JC.attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos))
    tp = torch.from_numpy(pos).long()
    got = C.attention(q, k, v, tp, tp)
    assert flash_on_cpu == [(torch.bfloat16,) * 3]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _hold(got, want, BF16_TOL)


def test_bf16_chatglm3_prefill_on_the_flash_route_matches_reference(flash_on_cpu):
    """chatglm3_6b reduced to 2 layers at narrow widths (head dim 32, so the
    route takes it) in bf16, weights crossed from the reference's init:
    every layer's prefill attention goes to the kernel with bf16 operands,
    and the last-position logits are the reference's bf16 prefill's within
    the bf16 tolerance."""
    kw = dict(n_layers=2, head_dim=32)
    jcfg = dataclasses.replace(jcb.get("chatglm3_6b").reduced(),
                               param_dtype=jnp.bfloat16, **kw)
    tcfg = dataclasses.replace(cb.get("chatglm3_6b").reduced(),
                               param_dtype=torch.bfloat16, **kw)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    want, _ = jax.jit(lambda p: JT.prefill(p, jcfg, jnp.asarray(tokens)))(jp)
    got, _ = T.prefill(tp, tcfg, torch.from_numpy(tokens).long())
    assert flash_on_cpu == [(torch.bfloat16,) * 3] * 2
    assert got.shape == want.shape
    _hold(got, want, BF16_TOL)


# ---------------------------------------------------------------------------
# chip_smoke.py's bf16 passes, on the CPU
# ---------------------------------------------------------------------------

def _load_chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bf16_entry_paths_hold_their_oracle():
    """Phase 5's bf16 passes at edge_cnn's widths and a small GQA attention:
    ``matmul_batch_op``, ``conv_im2col_op``, ``conv_im2col_batch_op``, the
    two point-GEMMs (on U and V from the transforms, rounded to bf16) and
    ``flash_attention_op`` on bf16 operands give bf16 outputs within one
    bf16 rounding of the fp32 oracle on the same values (each drive asserts
    it through ``hold_bf16``); each path names the kernels it launches."""
    from repro_torch.models import cnn_zoo
    smoke = _load_chip_smoke()
    layers = [l for l in smoke.conv_layers(cnn_zoo.get("edge_cnn"))
              if l[0].split("/")[1] in ("conv0", "exp12", "conv9", "conv10")]
    attention = {"gqa_d64": dict(heads=4, kv_heads=2, head_dim=64, seq=256, causal=True)}
    paths = smoke.bf16_entry_paths("edge_cnn", layers, attention, batch=2)
    assert [k for k, *_ in paths.values()] == [
        "matmul_batch", "conv_im2col", "conv_im2col_batch", "winograd_point_gemm",
        "winograd_point_gemm_batch", "flash_attention"]
    for kernel, drive, launched in paths.values():
        assert launched == {kernel, *(("winograd_input_transform",)
                                      if "point_gemm" in kernel else ())}
        assert np.isfinite(drive(torch, "cpu", np.random.default_rng(0)))


def test_bf16_bounds_at_the_bf16_rate():
    """A bf16 signature is bounded at 989 TFLOP/s and 2-byte traffic: for
    chatglm3_6b causal at S = 4,096 0.139 ms (by operations), against the
    fp32 signature's 0.834 at the 3xTF32 rate; a bf16 matmul with a bf16
    output moves half the bytes of the fp32 one. (A flash signature carries
    K and V's rep, 16 here, and the route before the scale and dtype.)"""
    smoke = _load_chip_smoke()
    table = smoke.kernel_table(torch)
    fa = table["flash_attention"]
    base = (32, 4096, 4096, 128, True, 64, 32, 16, "mma.sync", 128 ** -0.5)
    bf, f32 = (*base, "bfloat16"), (*base, "float32")
    assert fa["flops_s"](bf) == smoke.BF16_FLOPS
    assert fa["work"](bf)[1] * 2 == fa["work"](f32)[1]
    flops, nbytes = fa["work"](bf)
    assert round(max(flops / fa["flops_s"](bf), nbytes / smoke.HBM_BYTES_S) * 1e3, 3) == 0.139
    mm = table["matmul"]
    sig = (256, 512, 384, 64, 32, 64, 1)
    bf, f32 = ((*sig, dt, dt, False, dt, dt) for dt in ("bfloat16", "float32"))
    assert mm["work"](bf)[1] * 2 == mm["work"](f32)[1]
    # an fp32 bias and residual on bf16 operands are counted at 4 bytes
    mixed = (*sig, "float32", "float32", False, "bfloat16", "bfloat16")
    assert mm["work"](mixed)[1] - mm["work"](bf)[1] == 2 * (256 + 256 * 384)
    assert mm["flops_s"]((*sig, False, False, False, "bfloat16", "float32")) == \
        smoke.BF16_FLOPS
    assert mm["flops_s"](f32) == smoke.TF32_FLOPS / 3


@pytest.fixture
def launched(monkeypatch):
    """The conv and point-GEMM wrappers' launch path on CPU tensors, with a
    stand-in for each C entry point: every call's (library, symbol, number
    of arguments bound, arguments) is recorded, and the launch counted as on
    the card."""
    from repro_torch.kernels.im2col_gemm import im2col_gemm as conv_mod
    from repro_torch.kernels.winograd import winograd as wino_mod
    calls = []

    def bind(lib, symbol, n_ptrs, n_ints):
        return lambda *args: calls.append((lib, symbol, n_ptrs + n_ints + 1, args)) or 0
    for mod in (conv_mod, wino_mod):
        monkeypatch.setattr(mod, "on_cpu", lambda *a, **kw: False)
        monkeypatch.setattr(mod, "bind", bind)
        monkeypatch.setattr(mod, "stream_of", lambda t: 0)
    common.reset_launches()
    yield calls
    common.reset_launches()


def test_bf16_conv_and_point_gemm_signatures_and_bounds(launched):
    """A bf16 conv or point-GEMM launch binds the bf16 library's entry point
    with as many arguments as it declares, records the operand dtype last
    (a conv's bias and residual as their dtype's name, then its route; a
    point-GEMM's route), and
    chip_smoke.py reads that dtype (``sig_dtype``) and bounds the signature
    at 989 TFLOP/s and 2-byte traffic, an fp32 bias at 4 bytes; fp32 launches keep the
    3xTF32 rate and 4-byte traffic."""
    smoke = _load_chip_smoke()
    table = smoke.kernel_table(torch)
    bf, f32 = torch.bfloat16, torch.float32
    x, w = torch.zeros(2, 8, 10, 10, dtype=bf), torch.zeros(16, 8, 3, 3, dtype=bf)
    b, r = torch.zeros(16), torch.zeros(2, 16, 8, 8, dtype=bf)
    conv_im2col_batch(x, w, 1, bm=16, bn=64, bias=b, residual=r, relu=True)
    conv_im2col(x[0].float(), w.float(), 1, bm=16, bn=64, split_k=2)
    u, v = torch.zeros(16, 8, 24, dtype=bf), torch.zeros(2, 16, 24, 9, dtype=bf)
    winograd_point_gemm_batch(u, v, bm=16, bn=8)
    winograd_point_gemm(u.float(), v[0].float(), bm=16, bn=8)
    assert [(lib, sym) for lib, sym, *_ in launched] == [
        ("im2col_gemm_bf16", "rt_conv_im2col_batch_bf16"),
        ("im2col_gemm", "rt_conv_im2col_f32"),
        ("winograd_bf16", "rt_winograd_point_gemm_batch_bf16"),
        ("winograd", "rt_winograd_point_gemm_f32")]
    assert all(n == len(args) for *_, n, args in launched)
    assert launched[0][3][-3:-1] == (0, 1)            # bias fp32, residual bf16
    (cb,), (c1,) = common.SEEN["conv_im2col_batch"], common.SEEN["conv_im2col"]
    (wb,), (w1,) = (common.SEEN["winograd_point_gemm_batch"],
                    common.SEEN["winograd_point_gemm"])
    assert cb == (2, 8, 10, 10, 16, 3, 1, 16, 32, 64, 1, "float32", "bfloat16",
                  True, "mma.sync", "bfloat16")
    assert c1 == (8, 10, 10, 16, 3, 1, 16, 16, 64, 2, False, False, False,
                  "mma.sync", "float32")
    assert wb == (2, 16, 8, 24, 9, 16, 32, 8, 1, "mma.sync", "bfloat16")
    assert w1 == (16, 8, 24, 9, 16, 16, 8, 1, "mma.sync", "float32")
    for name, sig, dt in (("conv_im2col_batch", cb, "bfloat16"), ("conv_im2col", c1, "float32"),
                          ("winograd_point_gemm_batch", wb, "bfloat16"),
                          ("winograd_point_gemm", w1, "float32")):
        assert smoke.sig_dtype(name, sig) == dt
        want = smoke.BF16_FLOPS if dt == "bfloat16" else smoke.TF32_FLOPS / 3
        assert table[name]["flops_s"](sig) == want
    P, Pw = 2 * 8 * 8, 2 * 16 * 24 * 9
    assert table["conv_im2col_batch"]["work"](cb) == (
        2 * P * 16 * 72 + P * 16 * 3,
        2 * (2 * 8 * 10 * 10 + 16 * 72 + P * 16) + 4 * 16 + 2 * P * 16)
    assert table["conv_im2col"]["work"](c1)[1] == 4 * (8 * 100 + 16 * 72 + 64 * 16)
    assert table["winograd_point_gemm_batch"]["work"](wb) == (
        2 * 2 * 16 * 8 * 24 * 9, 2 * (16 * 8 * 24 + Pw + 2 * 16 * 8 * 9))
    assert table["winograd_point_gemm"]["work"](w1)[1] == 4 * (
        16 * 8 * 24 + 16 * 24 * 9 + 16 * 8 * 9)
    # the sweep at a bf16 signature stays in bf16: bf16 depths, bf16 or no epilogue
    sweep = table["conv_im2col_batch"]["sweep"](cb)
    assert {s[8] for s in sweep} == {32} and {s[-1] for s in sweep} == {"bfloat16"}
    assert {s[11] for s in sweep} == {False, "bfloat16"}
    assert {s[5] for s in table["winograd_point_gemm"]["sweep"](
        (16, 8, 24, 9, 16, 32, 8, 1, "mma.sync", "bfloat16"))} <= {32, 64}


def test_chip_smoke_served_rows_are_timed_on_served_passes(monkeypatch):
    """A served kernel's fp32 row in the ``{"kernels": [...]}`` line is
    timed on the served pass where it does the most work, even where a
    phase-5 pass of the same dtype (the input transform under the bf16
    point-GEMM paths) has a larger bound; its bf16 row on its bf16 pass."""
    smoke = _load_chip_smoke()

    def t(dt, bound):
        return dict(dtype=dt, ms=2 * bound, plain_ms=3 * bound, bound_ms=bound,
                    bound_by="bytes", library_ms=None, bound_fp32_ms=bound,
                    launches=13)
    passes = {"edge_cnn_mix": t("float32", 0.01), "resnet18_mix": t("float32", 0.17),
              "phase 5 fp32": t("float32", 0.19), "phase 5 bf16": t("bfloat16", 0.02)}
    r = {"max_abs_err_by_dtype": {"float32": 1e-5, "bfloat16": 1e-2},
         "passes": passes, "source": "src/repro_torch/csrc/winograd.cu",
         "replaces": "x.py:1"}
    monkeypatch.setattr(smoke, "PATH_DTYPES", {
        p: {"winograd_point_gemm_batch": {pt["dtype"]: 13}} for p, pt in passes.items()})
    rows = smoke.kernel_rows({"winograd_point_gemm_batch": r},
                             dict.fromkeys(passes), {"phase 5 fp32", "phase 5 bf16"},
                             "card")
    assert [(row["dtype"], row["timed_on"], row["bound_ms"]) for row in rows] == [
        ("float32", "resnet18_mix b=8 forward", 0.17),
        ("bfloat16", "phase 5 bf16", 0.02)]
    assert [row["launches"] for row in rows] == [39, 13]


def _attention_p_parts(q, k, v, parts):
    """Causal attention in fp32 with P V taken from P rounded to bf16 in
    ``parts`` parts (1: P as one bf16 part; 2: a bf16 high and low part,
    as the bf16 flash kernel feeds the tensor cores), the row sums from
    fp32 P; output rounded once to bf16."""
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    n = s.shape[-1]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    pv = hi @ v if parts == 1 else hi @ v + (p - hi).bfloat16().float() @ v
    return (pv / p.sum(-1, keepdim=True)).bfloat16()


def test_hold_bf16_rejects_p_fed_as_one_bf16_part():
    """chip_smoke.py's bf16 check (``hold_bf16``: one bf16 rounding of the
    fp32 result, plus 1e-4 of the row's largest |result|) on attention at
    unit-scale scores (2 heads, S = 2,048, d = 128, causal): P fed to P V as
    a bf16 high and low part passes; P as one bf16 part (22% of the
    elements over the bound), the last 64 rows each blind to its own key,
    or a 64-key block dropped from the late rows fails. The first two are
    within the reference's 5e-2, which would have passed them."""
    smoke = _load_chip_smoke()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2048, 128, generator=g).bfloat16().float()
               for _ in range(3))
    want = flash_attention_plain(q, k, v, causal=True)
    two = _attention_p_parts(q, k, v, 2)
    assert smoke.hold_bf16(torch, two, want, 1e-4, rows=True) < 2 ** -7
    s = q @ k.transpose(-1, -2) * 128 ** -0.5
    causal = torch.ones(2048, 2048, dtype=torch.bool).triu(1)
    late, dropped = causal.clone(), causal.clone()
    rows = torch.arange(1984, 2048)
    late[rows, rows] = True                                 # each row's own key
    dropped[1536:, 512:576] = True                          # one 64-key block
    one, late, dropped = (_attention_p_parts(q, k, v, 1), *(
        (torch.softmax(s.masked_fill(m, float("-inf")), -1) @ v).bfloat16()
        for m in (late, dropped)))
    for w in (one, late, dropped):
        with pytest.raises(AssertionError, match="more than one rounding"):
            smoke.hold_bf16(torch, w, want, 1e-4, rows=True)
    for w in (one, late):
        np.testing.assert_allclose(w.float().numpy(), want.numpy(), **BF16_TOL)


# ---------------------------------------------------------------------------
# The matmul-site autotune's dtype
# ---------------------------------------------------------------------------

def test_measured_cost_times_bf16_by_default():
    assert AT.MeasuredCost(device="cuda").dtype == torch.bfloat16   # no card touched
    assert AT.MeasuredCost(device="cuda", dtype=torch.float32).dtype == torch.float32
    with pytest.raises(ValueError, match="times the card"):
        AT.MeasuredCost(device="cpu", dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_dataset_records_the_cost_dtype(dtype):
    """A cost source that states its dtype: the reference's analytic surface
    at that dtype's bytes. The dataset records the dtype and keeps the
    reference's numbers; a source that states none records None."""
    class Priced:
        def __init__(self, dtype):
            self.dtype = dtype

        def __call__(self, M, K, N, variant):
            return JAT.analytic_cost(M, K, N, *REF_MM_VARIANTS[variant],
                                     dtype_bytes=self.dtype.itemsize)

    cost = Priced(dtype)
    data = AT.build_dataset(cost, sample_rows=8, max_flops=1e10, seed=3)
    assert data.dtype == dtype
    want = np.array([[cost(*map(int, r), v) for v in data.names] for r in data.feats])
    np.testing.assert_array_equal(data.times, want)
    assert AT.build_dataset(lambda *a: 1.0, budget_s=0.0).dtype is None


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

# the conv and Winograd kernels that take bf16 (the ports of Pallas kernels)
CONV_BF16 = ("conv_im2col", "conv_im2col_batch", "winograd_point_gemm",
             "winograd_point_gemm_batch")


def _conv_calls(dt, dt2=None):
    """The conv and Winograd kernels with operands of ``dt``, the weights
    (the point-GEMM's v) of ``dt2`` where given."""
    dt2 = dt2 or dt
    x, w = torch.zeros(1, 4, 8, 8, dtype=dt), torch.zeros(4, 4, 3, 3, dtype=dt2)
    u, v = torch.zeros(16, 4, 4, dtype=dt), torch.zeros(1, 16, 4, 9, dtype=dt2)
    return {
        "conv_im2col": lambda: conv_im2col(x[0], w, 1, bm=16, bn=8),
        "conv_im2col_batch": lambda: conv_im2col_batch(x, w, 1, bm=16, bn=8),
        "winograd_point_gemm": lambda: winograd_point_gemm(u, v[0], bm=16, bn=8),
        "winograd_point_gemm_batch": lambda: winograd_point_gemm_batch(
            u, v, bm=16, bn=8),
        "winograd_input_transform": lambda: winograd_input_transform(x, 2),
        "winograd_inverse_transform": lambda: winograd_inverse_transform(
            torch.zeros(1, 16, 4, 9, dtype=dt), 2, 6, 6),
    }


def _bf16_calls(dt, dt2=None):
    """matmul, matmul_batch and flash_attention with operands of ``dt``, the
    second operand of ``dt2`` where given."""
    dt2 = dt2 or dt
    a, b = torch.zeros(16, 32, dtype=dt), torch.zeros(32, 8, dtype=dt2)
    q, k = torch.zeros(1, 16, 32, dtype=dt), torch.zeros(1, 16, 32, dtype=dt2)
    return {
        "matmul": lambda: matmul(a, b),
        "matmul_batch": lambda: matmul_batch(a[None], b[None]),
        "flash_attention": lambda: flash_attention(q, k, k),
    }


@pytest.mark.parametrize("name", sorted(_conv_calls(torch.float32)))
def test_conv_and_winograd_kernels_refuse_bf16_and_fp16(name):
    """The two convs and the two point-GEMMs run fp32 and bf16, the output
    in the operands' dtype, and refuse fp16 and operands of two dtypes; the
    two Winograd transforms (fp32 in the reference too) refuse bf16 and
    fp16. A refused operand raises, never upcast quietly."""
    if name in CONV_BF16:
        for dt in (torch.float32, torch.bfloat16):
            assert _conv_calls(dt)[name]().dtype == dt
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            _conv_calls(torch.float16)[name]()
        for dt, dt2 in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
            with pytest.raises(TypeError, match="share a dtype"):
                _conv_calls(dt, dt2)[name]()
        assert common.DTYPES[name] == (torch.float32, torch.bfloat16)
        return
    assert _conv_calls(torch.float32)[name]().dtype == torch.float32
    for dt in (torch.bfloat16, torch.float16):
        with pytest.raises(TypeError, match="float32"):
            _conv_calls(dt)[name]()
    assert name not in common.DTYPES


@pytest.mark.parametrize("name", sorted(_bf16_calls(torch.float32)))
def test_bf16_kernels_refuse_fp16_and_mixed_dtypes(name):
    """fp32 and bf16 run; fp16 and operands of two dtypes raise."""
    for dt in (torch.float32, torch.bfloat16):
        assert _bf16_calls(dt)[name]().dtype == dt
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _bf16_calls(torch.float16)[name]()
    for dt, dt2 in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        with pytest.raises(TypeError, match="share a dtype"):
            _bf16_calls(dt, dt2)[name]()


def test_matmul_refuses_a_bf16_bias_on_fp32_operands_and_fp16_output():
    x, y = torch.zeros(8, 16), torch.zeros(16, 8)
    with pytest.raises(TypeError, match="share a dtype"):
        matmul(x, y, bias=torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="out_dtype"):
        matmul(x, y, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="instantiated tile"):
        matmul(x.bfloat16(), y.bfloat16(), bk=16)     # an fp32 depth
