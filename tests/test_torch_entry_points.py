"""The port's four entry-point kernels against the reference's ``ops`` API.

``matmul_batch_op``, ``conv_im2col_op``, ``winograd_conv_op`` /
``winograd_conv_batch_op`` / ``winograd_conv`` and ``flash_attention_op``
are held to the JAX package's functions of the same names, run in Pallas
interpret mode, on the same numpy inputs, for every ``VARIANTS`` key. On
the CPU each wrapper computes its kernel's plain PyTorch version, so these
tests hold the plain versions and the wrappers' plumbing (GQA repeat, head
fold, block clamp, epilogue, broadcast operands) to the reference.
Tolerances are the reference's own: fp32 rtol=atol=1e-4 for the GEMMs and
attention (``tests/test_kernels.py::_TOL``), 1e-3 for the Winograd convs.

``tests/test_torch_gpu.py`` holds each hand-written CUDA kernel to its plain
version on the card.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention as jax_fa
from repro.kernels.flash_attention.ops import VARIANTS as JAX_FA_VARIANTS
from repro.kernels.flash_attention.ops import flash_attention_op as jax_fa_op
from repro.kernels.im2col_gemm.ops import conv_im2col_op as jax_conv_op
from repro.kernels.matmul.ops import VARIANTS as JAX_MM_VARIANTS
from repro.kernels.matmul.ops import matmul_batch_op as jax_mm_batch_op
from repro.kernels.winograd.ops import VARIANTS as JAX_WINO_VARIANTS
from repro.kernels.winograd.ops import winograd_conv as jax_wino_conv
from repro.kernels.winograd.ops import winograd_conv_batch as jax_wino_conv_batch
from repro.kernels.winograd.ops import winograd_conv_batch_op as jax_wino_batch_op
from repro.kernels.winograd.ops import winograd_conv_op as jax_wino_op
from repro.kernels.winograd.ref import conv3x3_ref as jax_conv3x3_ref
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.flash_attention import TILES as FA_KERNEL_TILE_LIST
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import cta_tile as fa_cta_tile
from repro_torch.kernels.flash_attention.ops import VARIANTS as FA_VARIANTS
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.im2col_gemm.ops import VARIANTS as CONV_VARIANTS
from repro_torch.kernels.im2col_gemm.ops import conv_im2col_op
from repro_torch.kernels.matmul.matmul import matmul_batch
from repro_torch.kernels.matmul.ops import matmul_batch_op
from repro_torch.kernels.winograd.ops import (winograd_conv, winograd_conv_batch,
                                              winograd_conv_batch_op,
                                              winograd_conv_op)
from repro_torch.kernels.winograd.ref import conv3x3_ref

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
WINO_TOL = dict(rtol=1e-3, atol=1e-3)
EPILOGUES = list(itertools.product((False, True), repeat=3))   # bias, res, relu
# (BQ, BKV) tiles csrc/flash_attention.cu instantiates (RT_FOR_EACH_FA_TILE)
FA_KERNEL_TILES = {(64, 32), (64, 64), (128, 32), (128, 64)}
SMEM_PER_BLOCK = 232448                                          # 227 KB


def smem_bytes(bq, bkv, d):
    """Dynamic shared memory of one CTA of ``csrc/flash_attention.cu``: Q's
    big and small tf32 halves (bq rows each), one K and one V stage (bkv
    rows each), rows padded to d + 4 floats, in fp32."""
    return 4 * (2 * bq + 2 * bkv) * (d + 4)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# matmul_batch_op (reference: kernels/matmul/matmul.py:87)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,epi,bcast", [
    (v, e, b) for v, e, b in zip(sorted(JAX_MM_VARIANTS), EPILOGUES,
                                 itertools.cycle(("x", "y", None)))])
def test_matmul_batch_op_every_variant(variant, epi, bcast, rng):
    """Every mm-* key, ragged (B, M, K, N), each with one epilogue
    combination (all eight covered) and, in turn, x broadcast over the
    batch, y broadcast, or neither — the broadcast operand is read in place
    (batch stride 0), as ``tests/test_variants.py`` feeds it."""
    B, M, K, N = 3, 150, 70, 90
    hb, hr, relu = epi
    x = _np(rng, M, K) if bcast == "x" else _np(rng, B, M, K)
    y = _np(rng, K, N) if bcast == "y" else _np(rng, B, K, N)
    b = _np(rng, M) if hb else None
    r = _np(rng, B, M, N) if hr else None
    jx = jnp.broadcast_to(jnp.asarray(x), (B, M, K))
    jy = jnp.broadcast_to(jnp.asarray(y), (B, K, N))
    want = jax_mm_batch_op(jx, jy, variant=variant, interpret=True, bias=_j(b),
                           residual=_j(r), relu=relu, fuse_store=True)
    tx = _t(x).expand(B, M, K) if bcast == "x" else _t(x)
    ty = _t(y).expand(B, K, N) if bcast == "y" else _t(y)
    before = dict(common.LAUNCHES)
    got = matmul_batch_op(tx, ty, variant=variant, bias=_t(b), residual=_t(r),
                          relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)
    assert common.LAUNCHES == before, "CPU tensors take the plain version"


def test_matmul_batch_rejects_what_the_kernel_cannot_take():
    x, y = torch.zeros(2, 4, 3), torch.zeros(2, 3, 5)
    with pytest.raises(ValueError):
        matmul_batch(x, torch.zeros(3, 3, 5))             # batch mismatch
    with pytest.raises(ValueError):
        matmul_batch(x, y, bias=torch.zeros(5))
    with pytest.raises(ValueError):
        matmul_batch(x, y, residual=torch.zeros(4, 5))
    with pytest.raises(ValueError):
        matmul_batch(torch.zeros(2, 3, 4).transpose(1, 2), y)   # strided matrix
    with pytest.raises(TypeError):
        matmul_batch(x.double(), y.double())


# ---------------------------------------------------------------------------
# conv_im2col_op (reference: kernels/im2col_gemm/im2col_gemm.py:76)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,s,variant,epi", [
    (f, s, v, e) for (f, s), v, e in zip(
        itertools.product((1, 3, 5), (1, 2)),
        itertools.cycle(sorted(CONV_VARIANTS)),
        [(True, True, True), (True, False, False), (False, True, True),
         (False, False, True), (True, True, False), (False, False, False)])])
def test_conv_im2col_op(f, s, variant, epi, rng):
    """One image, f in {1, 3, 5}, stride 1 and 2, every conv-bk* key, bias
    (K,) and residual (K, oh, ow) against the reference's in-kernel
    epilogue (``fuse_store=True``)."""
    C, H, W, K = 6, 13, 11, 12
    hb, hr, relu = epi
    oh, ow = (H - f) // s + 1, (W - f) // s + 1
    x, w = _np(rng, C, H, W), _np(rng, K, C, f, f, scale=(C * f * f) ** -0.5)
    b = _np(rng, K) if hb else None
    r = _np(rng, K, oh, ow) if hr else None
    want = jax_conv_op(jnp.asarray(x), jnp.asarray(w), s, variant=variant,
                       interpret=True, bias=_j(b), residual=_j(r), relu=relu,
                       fuse_store=True)
    got = conv_im2col_op(_t(x), _t(w), s, variant=variant, bias=_t(b),
                         residual=_t(r), relu=relu)
    assert got.shape == (K, oh, ow)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


# ---------------------------------------------------------------------------
# winograd_point_gemm under winograd_conv (reference: kernels/winograd/
# winograd.py:36, ops.py:41,112)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(JAX_WINO_VARIANTS))
def test_winograd_conv_op_and_batch_op(variant, rng):
    """F(2x2, 3x3): the single-image and batched ops against the
    reference's, and the single-image one against the plain convolution."""
    x, w = _np(rng, 2, 5, 14, 13), _np(rng, 8, 5, 3, 3, scale=(5 * 9) ** -0.5)
    want1 = jax_wino_op(jnp.asarray(x[0]), jnp.asarray(w), variant=variant,
                        interpret=True)
    got1 = winograd_conv_op(_t(x[0]), _t(w), variant=variant)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **WINO_TOL)
    np.testing.assert_allclose(
        got1.numpy(), np.asarray(jax_conv3x3_ref(jnp.asarray(x[0]), jnp.asarray(w))),
        **WINO_TOL)
    np.testing.assert_allclose(conv3x3_ref(_t(x[0]), _t(w)).numpy(),
                               np.asarray(jax_conv3x3_ref(jnp.asarray(x[0]),
                                                          jnp.asarray(w))),
                               **GEMM_TOL)
    wantb = jax_wino_batch_op(jnp.asarray(x), jnp.asarray(w), variant=variant,
                              interpret=True)
    gotb = winograd_conv_batch_op(_t(x), _t(w), variant=variant)
    np.testing.assert_allclose(gotb.numpy(), np.asarray(wantb), **WINO_TOL)


@pytest.mark.parametrize("variant", sorted(JAX_WINO_VARIANTS))
def test_winograd_conv_m4_with_epilogue(variant, rng):
    """F(4x4, 3x3) single-image and batched, bias -> residual -> ReLU, against
    the reference's ``winograd_conv`` / ``winograd_conv_batch``."""
    bk, bt = JAX_WINO_VARIANTS[variant]
    x, w = _np(rng, 2, 4, 15, 17), _np(rng, 8, 4, 3, 3, scale=(4 * 9) ** -0.5)
    b, r = _np(rng, 8), _np(rng, 2, 8, 13, 15)
    want1 = jax_wino_conv(jnp.asarray(x[0]), jnp.asarray(w), m=4, bk=bk, bt=bt,
                          bias=jnp.asarray(b), residual=jnp.asarray(r[0]),
                          relu=True, interpret=True)
    got1 = winograd_conv(_t(x[0]), _t(w), m=4, variant=variant, bias=_t(b),
                         residual=_t(r[0]), relu=True)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **WINO_TOL)
    wantb = jax_wino_conv_batch(jnp.asarray(x), jnp.asarray(w), m=4, bk=bk,
                                bt=bt, bias=jnp.asarray(b),
                                residual=jnp.asarray(r), relu=True,
                                interpret=True)
    gotb = winograd_conv_batch(_t(x), _t(w), m=4, variant=variant, bias=_t(b),
                               residual=_t(r), relu=True)
    np.testing.assert_allclose(gotb.numpy(), np.asarray(wantb), **WINO_TOL)


@pytest.mark.parametrize("m,H,W", [(2, 7, 11), (4, 11, 13)])
@pytest.mark.parametrize("variant,bias,res,relu", [
    (v, *e) for v, e in zip(itertools.cycle(sorted(JAX_WINO_VARIANTS)
                                            + ["mm-256x256x256"]), EPILOGUES)])
def test_winograd_conv_epilogues_c70_odd_t(m, H, W, variant, bias, res, relu, rng):
    """Batched and single-image Winograd convs, every bias / residual / ReLU
    combination, against the reference's ``winograd_conv_batch`` /
    ``winograd_conv``: C = 70 (no multiple of 4 or of a channel step) and an
    odd, ragged tile count (T = 15 at F(2x2), 9 at F(4x4))."""
    N, C, K = 2, 70, 12
    x, w = _np(rng, N, C, H, W), _np(rng, K, C, 3, 3, scale=(C * 9) ** -0.5)
    b = _np(rng, K) if bias else None
    r = _np(rng, N, K, H - 2, W - 2) if res else None
    wantb = jax_wino_conv_batch(jnp.asarray(x), jnp.asarray(w), m=m, bias=_j(b),
                                residual=_j(r), relu=relu, interpret=True)
    gotb = winograd_conv_batch(_t(x), _t(w), m=m, variant=variant, bias=_t(b),
                               residual=_t(r), relu=relu)
    np.testing.assert_allclose(gotb.numpy(), np.asarray(wantb), **WINO_TOL)
    r1 = None if r is None else r[0]
    want1 = jax_wino_conv(jnp.asarray(x[0]), jnp.asarray(w), m=m, bias=_j(b),
                          residual=_j(r1), relu=relu, interpret=True)
    got1 = winograd_conv(_t(x[0]), _t(w), m=m, variant=variant, bias=_t(b),
                         residual=_t(r1), relu=relu)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **WINO_TOL)


# ---------------------------------------------------------------------------
# flash_attention_op (reference: kernels/flash_attention/flash_attention.py:62,
# ops.py:23)
# ---------------------------------------------------------------------------

def test_fa_variants_and_tile_map():
    """The reference's five fa-* keys; each maps by the documented rule
    (BQ = half the TPU query block, capped at 128; BKV = 4,096 / d keys,
    capped at 64) onto a tile the CUDA source instantiates and that fits one
    block's shared memory at every head dim."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/flash_attention.cu").read_text()
    macro = next(l for l in src.splitlines() if l.startswith("#define RT_FOR_EACH_FA_TILE"))
    assert {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+), D\)", macro)} == FA_KERNEL_TILES
    assert set(FA_KERNEL_TILE_LIST) == FA_KERNEL_TILES
    assert FA_VARIANTS == JAX_FA_VARIANTS
    mapped = set()
    for key, (bq, bkv) in FA_VARIANTS.items():
        for d in (32, 64, 128):
            tile = fa_cta_tile(key, d)
            assert tile == (min(bq // 2, 128), min(64, 4096 // d))
            assert tile in FA_KERNEL_TILES
            assert smem_bytes(*tile, d) <= SMEM_PER_BLOCK
            mapped.add(tile)
    assert mapped == FA_KERNEL_TILES      # every instantiated tile is reached


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("variant", sorted(JAX_FA_VARIANTS))
def test_flash_attention_op_gqa(variant, causal, rng):
    """Every fa-* key, causal and not, GQA with 8 query heads over 2 KV heads,
    d = 32 and 64 in turn; S = 256 puts several blocks on the sequence for
    the smaller keys and clamps the larger ones (``bq = min(bq, Sq)``)."""
    d = 32 if sorted(JAX_FA_VARIANTS).index(variant) % 2 else 64
    q = _np(rng, 1, 256, 8, d)
    k, v = _np(rng, 1, 256, 2, d), _np(rng, 1, 256, 2, d)
    want = jax_fa_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, variant=variant, interpret=True)
    before = dict(common.LAUNCHES)
    got = flash_attention_op(_t(q), _t(k), _t(v), causal=causal, variant=variant)
    assert got.shape == q.shape and common.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


@pytest.mark.parametrize("sq,sk", [(128, 256), (256, 128)])
def test_flash_attention_op_sq_ne_sk(sq, sk, rng):
    """Sq != Sk, causal: the mask is top-left aligned (query i sees keys
    0..i), as in the reference."""
    q = _np(rng, 2, sq, 4, 32)
    k, v = _np(rng, 2, sk, 2, 32), _np(rng, 2, sk, 2, 32)
    want = jax_fa_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, variant="fa-128x128", interpret=True)
    got = flash_attention_op(_t(q), _t(k), _t(v), causal=True, variant="fa-128x128")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


def test_flash_attention_kernel_explicit_scale(rng):
    """The (BH, S, d) function with an explicit scale, against the Pallas
    kernel at a TPU block that splits the sequence."""
    q, k, v = (_np(rng, 3, 128, 32) for _ in range(3))
    want = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                  scale=0.3, bq=64, bkv=32, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


def test_flash_attention_op_rejects_what_the_reference_rejects(rng):
    """A sequence the clamped TPU block does not divide is refused on both
    sides; so are query heads that are not a multiple of the KV heads."""
    q = _np(rng, 1, 200, 2, 32)
    with pytest.raises(AssertionError):
        jax_fa_op(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                  variant="fa-128x128", interpret=True)
    with pytest.raises(ValueError):
        flash_attention_op(_t(q), _t(q), _t(q), variant="fa-128x128")
    kv = torch.zeros(1, 128, 3, 32)
    with pytest.raises(ValueError):
        flash_attention_op(torch.zeros(1, 128, 4, 32), kv, kv)


# ---------------------------------------------------------------------------
# The slice as a whole: chip_smoke.py's entry-point phase, on the CPU
# ---------------------------------------------------------------------------

def _load_chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_point_phase_matches_reference(monkeypatch):
    """chip_smoke.py's phase 5 — every entry point, each path against its
    kernel-free oracle — run on the CPU at edge_cnn's widths (one conv of
    each kind: 3x3, 1x1, stride 2) and small GQA attention shapes. Every
    call the phase makes is recorded and replayed through the reference's
    function of the same name on the same inputs."""
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.kernels.im2col_gemm.ops as conv_ops
    import repro_torch.kernels.matmul.ops as mm_ops
    import repro_torch.kernels.winograd.ops as wino_ops
    from repro.kernels.winograd.ops import winograd_conv as jax_wino
    from repro_torch.models import cnn_zoo

    calls, depth = [], [0]

    def record(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kw):          # records the outermost call only
            depth[0] += 1
            try:
                out = fn(*args, **kw)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                calls.append((name, args, kw, out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((mm_ops, "matmul_batch_op"), (conv_ops, "conv_im2col_op"),
                         (wino_ops, "winograd_conv_op"), (wino_ops, "winograd_conv"),
                         (fa_ops, "flash_attention_op")):
        record(module, name)

    smoke = _load_chip_smoke()
    layers = [l for l in smoke.conv_layers(cnn_zoo.get("edge_cnn"))
              if l[0].split("/")[1] in ("conv0", "exp12", "conv9", "conv10")]
    attention = {"gqa_d32": dict(heads=8, kv_heads=2, head_dim=32, seq=128, causal=True),
                 "gqa_d64": dict(heads=4, kv_heads=2, head_dim=64, seq=256, causal=False)}
    paths = smoke.entry_point_paths("edge_cnn", layers, attention, batch=2)
    assert sorted({k for k, *_ in paths.values()}) == sorted(smoke.ENTRY_KERNELS)
    for kernel, drive, launched in paths.values():
        assert kernel in launched
        assert drive(torch, "cpu", np.random.default_rng(0)) < 1e-3

    def n(t):
        return t if isinstance(t, (int, float, bool)) else jnp.asarray(t.numpy())

    seen = {}
    for name, args, kw, out in calls:
        seen[name] = seen.get(name, 0) + 1
        a, k = [n(x) for x in args], {key: n(v) for key, v in kw.items()}
        if name == "matmul_batch_op":
            want, tol = jax_mm_batch_op(*a, interpret=True, fuse_store=True, **k), GEMM_TOL
        elif name == "conv_im2col_op":
            want, tol = jax_conv_op(*a, interpret=True, fuse_store=True, **k), GEMM_TOL
        elif name == "winograd_conv_op":
            want, tol = jax_wino_op(*a, interpret=True, **k), WINO_TOL
        elif name == "winograd_conv":
            want, tol = jax_wino(*a, interpret=True, **k), WINO_TOL
        else:
            want, tol = jax_fa_op(*a, interpret=True, **k), GEMM_TOL
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **tol)
    assert seen == {"matmul_batch_op": 4, "conv_im2col_op": 4,
                    "winograd_conv_op": 2, "winograd_conv": 2,
                    "flash_attention_op": 2}


def test_flash_attention_bound_at_the_3xtf32_rate():
    """chip_smoke.py bounds the fp32 flash-attention kernel at the 3xTF32
    rate (it runs on the tensor cores) and prints the fp32-rate bound
    beside it: for chatglm3_6b causal at S = 4,096 (32 heads, d = 128, the
    pairs the mask keeps) 0.834 and 2.052 ms. The rate is the signature's
    dtype's: the launch signature ends with it (after K and V's rep, the
    query heads over the KV heads, and the route)."""
    smoke = _load_chip_smoke()
    spec = smoke.kernel_table(torch)["flash_attention"]
    cfg = smoke.ATTENTION["chatglm3_6b_causal"]
    sig = (cfg["heads"], cfg["seq"], cfg["seq"], cfg["head_dim"], True,
           *fa_cta_tile("fa-128x128", cfg["head_dim"]),
           cfg["heads"] // cfg["kv_heads"], "mma.sync", cfg["head_dim"] ** -0.5,
           "float32")
    assert spec["flops_s"](sig) == smoke.TF32_FLOPS / 3
    flops, nbytes = spec["work"](sig)
    bound = max(flops / spec["flops_s"](sig), nbytes / smoke.HBM_BYTES_S) * 1e3
    bound32 = max(flops / smoke.FP32_FLOPS, nbytes / smoke.HBM_BYTES_S) * 1e3
    assert round(bound, 3) == 0.834 and round(bound32, 3) == 2.052
