"""The wgmma route of flash attention (``csrc/flash_wgmma.cu``) and the
grouped-query KV read in place, on the CPU: the rule that picks a route,
the tile table and the instantiated tiles, each route's C entry point and
launch signature, and GQA attention with K and V at their own heads
against the reference's Pallas kernel in interpret mode.

``kernels/flash_attention/flash_attention.route`` sends bf16 q, k, v at d =
64 or 128 with 16-byte aligned bases to the wgmma kernel and everything else
to the mma.sync kernels of ``csrc/flash_attention.cu``, from the call alone;
a call that names a route it does not fit raises. k and v hold ``BH / rep``
heads and query row bh reads KV row bh // rep, on every route. On the CPU
either route computes the wrapper's plain version, so the reference
comparison holds the folding, the rep and the routing plumbing;
``tests/test_torch_gpu.py -k flash`` holds the kernels themselves to that
plain version on the card.

Tolerances: the reference's ``_TOL`` (``tests/test_kernels.py:19-20``):
fp32 rtol=atol=1e-4 (sum order only), bf16 5e-2.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_op as ref_fa_op
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.flash_attention import (
    ROUTES, TILES, WGMMA_HEAD_DIMS, WGMMA_TILES, flash_attention,
    flash_attention_plain, route, takes_wgmma)
from repro_torch.kernels.flash_attention.ops import (VARIANTS, cta_tile,
                                                     flash_attention_op, plan,
                                                     wgmma_tile)
from repro_torch.models import components as C

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),      # tests/test_kernels.py::_TOL
       torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
SMEM = 232448                             # shared memory one H100 block can use
ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src" / "repro_torch" / "csrc" / "flash_wgmma.cu"
BF = torch.bfloat16


def _smem(bq: int, bkv: int, d: int) -> tuple:
    """(stages, dynamic shared memory, budget) of a wgmma tile, as
    FwTile counts them: 1,024 bytes of alignment, Q, a ring of as many K
    and V stages as fit (at most 4) in the budget — a whole block's 227 KB
    for two consumer warpgroups, half an SM's 228 KB less the 1 KB each
    block reserves for one (two CTAs to an SM) — and 3 stages + 3 barriers."""
    budget = 115712 if bq == 64 else SMEM
    q_bytes, stage = bq * d * 2, 2 * bkv * d * 2
    stages = min(4, (budget - 1024 - q_bytes - 256) // stage)
    return stages, 1024 + q_bytes + stages * stage + (3 * stages + 3) * 8, budget


def _rand(rng, *shape, dtype=torch.float32):
    """numpy normals, bf16-representable where ``dtype`` is bf16, as the
    torch tensor and the JAX array of the same values."""
    a = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
    return a, jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if dtype == BF else jnp.float32)


def _fold(t: torch.Tensor) -> torch.Tensor:
    B, S, H, d = t.shape
    return t.transpose(1, 2).reshape(B * H, S, d).contiguous()


# ---------------------------------------------------------------------------
# The route rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,want", [
    ("bf16_d64", "wgmma"), ("bf16_d128", "wgmma"), ("bf16_gqa_rep7", "wgmma"),
    ("bf16_d32", "mma.sync"), ("fp32_d64", "mma.sync"), ("fp32_d128", "mma.sync"),
    ("bf16_offset_q", "mma.sync"), ("bf16_offset_k", "mma.sync"),
    ("bf16_mixed", "mma.sync")])
def test_route_rule(case, want):
    """bf16 at d = 64 or 128 with every base on a 16-byte boundary takes
    wgmma whatever ``rep`` is; d = 32, fp32, a view 2 bytes off a boundary
    or a mixed call takes mma.sync."""
    d = 32 if case == "bf16_d32" else 128 if case.endswith("d128") else 64
    dt = torch.float32 if case.startswith("fp32") else BF
    q, k = torch.zeros(14, 40, d, dtype=dt), torch.zeros(14, 40, d, dtype=dt)
    if case == "bf16_gqa_rep7":
        k = torch.zeros(2, 40, d, dtype=dt)
    elif case == "bf16_offset_q":
        q = torch.zeros(14 * 40 * d + 1, dtype=dt)[1:].view(14, 40, d)
        assert q.is_contiguous() and q.data_ptr() % 16 == 2
    elif case == "bf16_offset_k":
        k = torch.zeros(14 * 40 * d + 1, dtype=dt)[1:].view(14, 40, d)
    elif case == "bf16_mixed":
        k = k.float()
    assert route(q, k, k) == want and takes_wgmma(q, k, k) == (want == "wgmma")


@pytest.mark.parametrize("case", ["fp32", "d32", "offset", "tile_not_at_d",
                                  "mma_tile", "unknown", "rep_mismatch"])
def test_a_forced_route_that_does_not_fit_raises(case):
    """``force_route="wgmma"`` on fp32, on d = 32 or on a misaligned base, or with
    a tile the wgmma kernel does not instantiate at this d (128 keys at d =
    128, an mma.sync tile), raises ``ValueError``, as does an unknown route
    or K and V whose heads are not BH / rep; nothing runs the other route."""
    q = torch.zeros(4, 64, 128, dtype=BF)
    kw = dict(force_route="wgmma")
    if case == "fp32":
        q = q.float()
    elif case == "d32":
        q = torch.zeros(4, 64, 32, dtype=BF)
    elif case == "offset":
        q = torch.zeros(4 * 64 * 128 + 1, dtype=BF)[1:].view(4, 64, 128)
    elif case == "tile_not_at_d":
        kw.update(bq=64, bkv=128)
    elif case == "mma_tile":
        kw.update(bq=64, bkv=32)
    elif case == "unknown":
        kw = dict(force_route="tma")
    k = q.contiguous()
    if case == "rep_mismatch":
        kw.update(rep=3)
    before = dict(common.LAUNCHES)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, **kw)
    assert dict(common.LAUNCHES) == before
    if case == "mma_tile":            # the same tile on its own route runs
        assert flash_attention(q, k, k, bq=64, bkv=32, force_route="mma.sync").shape == q.shape


# ---------------------------------------------------------------------------
# The tile table and the instantiated tiles
# ---------------------------------------------------------------------------

def test_wgmma_tiles_match_the_cuda_instantiations():
    """WGMMA_TILES is what csrc/flash_wgmma.cu instantiates
    (RT_FOR_EACH_FLASH_WGMMA_TILE), so no plan names a tile the launcher
    refuses; every variant's plan at d = 64 and 128 is one of them, and
    together they reach every one."""
    src = CU.read_text()
    body = re.search(r"#define RT_FOR_EACH_FLASH_WGMMA_TILE\(X\)((?:.*\\\n)*.*)",
                     src).group(1)
    tiles = [tuple(int(v) for v in t)
             for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)]
    assert sorted(tiles) == sorted(WGMMA_TILES) and len(set(tiles)) == len(tiles)
    assert {d for *_, d in tiles} == set(WGMMA_HEAD_DIMS)
    planned = {(*wgmma_tile(v, d), d) for v in VARIANTS for d in WGMMA_HEAD_DIMS}
    assert planned == set(WGMMA_TILES)


@pytest.mark.parametrize("tile", WGMMA_TILES, ids=lambda t: "x".join(map(str, t)))
def test_wgmma_tile_fits_shared_memory(tile):
    """Each tile's ring holds at least two stages within its budget, and
    the budget within the 227 KB a block can use."""
    stages, smem, budget = _smem(*tile)
    assert 2 <= stages <= 4 and smem <= budget <= SMEM


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_wgmma_tile_rule(variant):
    """BQ half the TPU query block capped at 128; BKV half the TPU KV block,
    capped at 128 at d = 64 and at 64 at d = 128; the mma.sync route keeps
    ``cta_tile``."""
    bq, bkv = VARIANTS[variant]
    assert wgmma_tile(variant, 64) == (min(bq // 2, 128), min(bkv // 2, 128))
    assert wgmma_tile(variant, 128) == (min(bq // 2, 128), 64)
    q = torch.zeros(4, 64, 128, dtype=BF)
    assert plan(q, q, q, variant) == dict(bq=min(bq // 2, 128), bkv=64, force_route="wgmma")
    assert plan(q.float(), q.float(), q.float(), variant) == dict(
        zip(("bq", "bkv"), cta_tile(variant, 128)), force_route="mma.sync")
    q32 = torch.zeros(4, 64, 32, dtype=BF)
    assert plan(q32, q32, q32, variant)["force_route"] == "mma.sync"


# ---------------------------------------------------------------------------
# Each route's entry point and signature
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_launch(monkeypatch):
    """flash_attention as on the card, with the C entry points replaced by
    a recorder: {symbol: [(library, ctypes counts, argument tuple)]}; the
    launch counters count."""
    calls = {}

    def bind(lib, symbol, *counts, **kw):
        return lambda *args: calls.setdefault(symbol, []).append(
            (lib, counts, args)) or 0
    monkeypatch.setattr(fa_mod, "on_cpu", lambda *a, **k: False)
    monkeypatch.setattr(fa_mod, "bind", bind)
    monkeypatch.setattr(fa_mod, "stream_of", lambda t: 0)
    common.reset_launches()
    yield calls
    common.reset_launches()


def test_each_route_calls_its_own_entry_point(fake_launch):
    """wgmma: ``rt_flash_wgmma_bf16`` of the ``flash_wgmma`` library, 4
    pointers, 8 ints (BH, Sq, Sk, d, causal, bq, bkv, rep), the scale and
    the stream (the tile fixes the kernel's schedule);
    mma.sync: ``rt_flash_attention_{bf16,f32}``, the same arguments. The
    signature records rep and the route
    before the scale and the dtype (``sig[-1]`` stays the dtype); both count
    under ``flash_attention``."""
    q, k = torch.zeros(14, 100, 64, dtype=BF), torch.zeros(2, 120, 64, dtype=BF)
    flash_attention(q, k, k, causal=True, bq=128, bkv=128, rep=7)
    flash_attention(q, k, k, causal=True, bq=64, bkv=64, rep=7)
    flash_attention(q, k, k, causal=False, rep=7, force_route="mma.sync")
    flash_attention(q.float(), k.float(), k.float(), scale=0.5, bkv=32, rep=7)
    (lib, counts, args), (_, _, args64) = fake_launch["rt_flash_wgmma_bf16"]
    assert (lib, counts) == ("flash_wgmma", (4, 8, 1)) and len(args) == 14
    assert args[:4] == (q.data_ptr(), k.data_ptr(), k.data_ptr(), args[3])
    assert args[4:] == (14, 100, 120, 64, 1, 128, 128, 7, 0.125, 0)
    assert args64[4:] == (14, 100, 120, 64, 1, 64, 64, 7, 0.125, 0)
    (lib, counts, args), = fake_launch["rt_flash_attention_bf16"]
    assert (lib, counts) == ("flash_attention_bf16", (4, 8, 1)) and len(args) == 14
    assert args[4:] == (14, 100, 120, 64, 0, 64, 64, 7, 0.125, 0)
    (lib, counts, args), = fake_launch["rt_flash_attention_f32"]
    assert (lib, counts) == ("flash_attention", (4, 8, 1))
    assert args[4:] == (14, 100, 120, 64, 1, 64, 32, 7, 0.5, 0)
    assert sorted(common.SEEN["flash_attention"], key=repr) == sorted([
        (14, 100, 120, 64, True, 128, 128, 7, "wgmma", 0.125, "bfloat16"),
        (14, 100, 120, 64, True, 64, 64, 7, "wgmma", 0.125, "bfloat16"),
        (14, 100, 120, 64, False, 64, 64, 7, "mma.sync", 0.125, "bfloat16"),
        (14, 100, 120, 64, True, 64, 32, 7, "mma.sync", 0.5, "float32")], key=repr)
    assert common.LAUNCHES["flash_attention"] == 4


def test_a_failed_launch_raises_and_counts_nothing(fake_launch, monkeypatch):
    """The C entry point's CUDA error raises ``KernelError`` out of either
    route; no launch is counted and nothing computes the attention another
    way."""
    monkeypatch.setattr(fa_mod, "bind", lambda *a, **k: (lambda *args: 1))
    monkeypatch.setattr(fa_mod, "flash_attention_plain",
                        lambda *a, **k: pytest.fail("plain attention ran"))
    q = torch.zeros(4, 64, 128, dtype=BF)
    for r in ROUTES:
        with pytest.raises(common.KernelError, match="cudaError 1"):
            flash_attention(q, q, q, force_route=r)
    assert common.LAUNCHES["flash_attention"] == 0


def test_op_and_lm_route_launch_kv_heads_on_the_wgmma_route(fake_launch):
    """``flash_attention_op`` and the LM prefill (``components.attention``
    with the route taken) launch the wgmma kernel on bf16 K and V of Hkv
    heads: BH = B H query rows over rep = H / Hkv, the tile of their
    variant; an fp32 call takes the mma.sync kernel with the same rep."""
    q = torch.zeros(2, 256, 14, 64, dtype=BF)
    k = torch.zeros(2, 256, 2, 64, dtype=BF)
    flash_attention_op(q, k, k, causal=True, variant="fa-256x256")
    flash_attention_op(q.float(), k.float(), k.float(), causal=False)
    pos = torch.arange(256)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C, "flash_routed", lambda *a, **kw: True)
        C.attention(q, k, k, pos, pos, causal=True)
    sigs = list(common.SEEN["flash_attention"])
    assert (28, 256, 256, 64, True, 128, 128, 7, "wgmma", 0.125, "bfloat16") in sigs
    assert (28, 256, 256, 64, False, 64, 64, 7, "mma.sync", 0.125, "float32") in sigs
    assert (28, 256, 256, 64, True, 64, 64, 7, "wgmma", 1.0, "bfloat16") in sigs
    assert len(fake_launch["rt_flash_wgmma_bf16"]) == 2


# ---------------------------------------------------------------------------
# K and V with their own heads, against the reference
# ---------------------------------------------------------------------------

def test_op_and_lm_route_hand_the_kernel_kv_heads(monkeypatch):
    """``flash_attention_op`` and ``_flash_route`` give ``flash_attention``
    K and V of B * Hkv rows (no repeat) with rep = H / Hkv, and their
    outputs equal attention on K and V repeated to the query heads."""
    seen = []

    def recording(q, k, v, **kw):
        seen.append((q.shape[0], k.shape[0], v.shape[0], kw["rep"]))
        return flash_attention(q, k, v, **kw)
    monkeypatch.setattr(fa_ops, "flash_attention", recording)
    monkeypatch.setattr(C, "flash_attention", recording)
    rng = np.random.default_rng(3)
    q, _ = _rand(rng, 2, 64, 8, 32)
    k, _ = _rand(rng, 2, 64, 2, 32)
    v, _ = _rand(rng, 2, 64, 2, 32)
    got_op = flash_attention_op(q, k, v, causal=True)
    got_lm = C._flash_route(q, k, v, 32 ** -0.5, causal=True)
    assert seen == [(16, 4, 4, 4), (16, 4, 4, 4)]
    kr, vr = k.repeat_interleave(4, dim=2), v.repeat_interleave(4, dim=2)
    want = flash_attention_plain(_fold(q), _fold(kr), _fold(vr), causal=True)
    want = want.reshape(2, 8, 64, 32).transpose(1, 2)
    torch.testing.assert_close(got_op, want, **TOL[torch.float32])
    torch.testing.assert_close(got_lm, want, **TOL[torch.float32])


@pytest.mark.parametrize("rep", [1, 2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
def test_rep_matches_the_reference_gqa_op(rep, dtype):
    """``flash_attention(..., rep=r)`` on folded q (B H rows) and k, v (B
    Hkv rows) equals the reference's ``flash_attention_op`` (which repeats
    K and V to the query heads) on the same numpy inputs, causal and not,
    at d = 64: the route the card would take at bf16 is wgmma."""
    rng = np.random.default_rng(10 + rep)
    B, S, Hkv, d = 2, 128, 2, 64
    (q, jq), (k, jk), (v, jv) = (_rand(rng, B, S, h, d, dtype=dtype)
                                 for h in (Hkv * rep, Hkv, Hkv))
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    assert route(qf, kf, vf) == ("wgmma" if dtype == BF else "mma.sync")
    for causal in (True, False):
        want = ref_fa_op(jq, jk, jv, causal=causal, interpret=True)
        got = flash_attention(qf, kf, vf, causal=causal, rep=rep,
                              **plan(qf, kf, vf, "fa-128x128"))
        got = got.reshape(B, Hkv * rep, S, d).transpose(1, 2)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)), **TOL[dtype])


def test_plain_rep_reads_kv_row_bh_over_rep():
    """The plain version with rep equals it on K and V repeated to the
    query rows, bit for bit, and so does each route on the CPU."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(12, 33, 64, generator=g).bfloat16()
    k, v = (torch.randn(4, 47, 64, generator=g).bfloat16() for _ in range(2))
    want = flash_attention_plain(q, k.repeat_interleave(3, 0),
                                 v.repeat_interleave(3, 0), causal=True)
    assert torch.equal(flash_attention_plain(q, k, v, causal=True, rep=3), want)
    for r in ROUTES:
        assert torch.equal(flash_attention(q, k, v, rep=3, force_route=r), want)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_reads_the_route_from_the_signature():
    """chip_smoke.py reads a flash launch's route and dtype from the
    signature's fields, and its table sweeps both routes' tiles at a bf16
    signature of d = 64 or 128 and the mma.sync tiles alone at fp32."""
    smoke = _load_chip_smoke()
    sig = (32, 4096, 4096, 128, True, 64, 64, 16, "wgmma", 128 ** -0.5, "bfloat16")
    assert smoke.sig_route("flash_attention", sig) == "wgmma"
    assert smoke.sig_dtype("flash_attention", sig) == "bfloat16"
    table = smoke.kernel_table(torch)["flash_attention"]
    swept = table["sweep"](sig)
    assert {(s[5], s[6], s[8]) for s in swept} == (
        {(a, b, "mma.sync") for a, b in TILES}
        | {(a, b, "wgmma") for a, b, d in WGMMA_TILES if d == 128})
    assert {s[4] for s in swept} == {True, False}
    fp32 = (*sig[:8], "mma.sync", sig[9], "float32")
    assert {s[8] for s in table["sweep"](fp32)} == {"mma.sync"}
    flops, nbytes = table["work"](sig)
    assert flops == 4 * 128 * 4096 * 4097 // 2 * 32
    assert nbytes == 2 * 128 * (2 * 32 * 4096 + 2 * 2 * 4096)


@pytest.mark.parametrize("kernel, routes, ab, want", [
    ("matmul", {"wgmma": 5}, False, "src/repro_torch/csrc/matmul_wgmma.cu"),
    ("matmul_batch", {"mma.sync": 3, "wgmma": 2}, False,
     "src/repro_torch/csrc/matmul.cu"),
    ("flash_attention", {"wgmma": 1}, True, "src/repro_torch/csrc/flash_wgmma.cu"),
    ("flash_attention", {"mma.sync": 1}, True,
     "src/repro_torch/csrc/flash_attention.cu"),
    ("conv_im2col", None, False, "src/repro_torch/csrc/im2col_gemm.cu"),
])
def test_chip_smoke_kernel_row_names_the_timed_route_source(kernel, routes, ab,
                                                            want, monkeypatch):
    """A routed kernel's bf16 row in the ``{"kernels": [...]}`` line names the
    source of the route that launched most on its timed pass, whether or not
    the pass carries an A/B or a per-route float64 distance; an unrouted
    kernel's row names its own source."""
    smoke = _load_chip_smoke()
    dt = "float32" if routes is None else "bfloat16"
    n = sum((routes or {"-": 1}).values())
    t = dict(dtype=dt, ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="operations",
             library_ms=None, bound_fp32_ms=0.7, launches=n)
    if routes is not None:
        t["routes"] = routes
    if ab:
        t["ab"] = [0.9, 0.4, 0.4, 0.9]
    r = {"max_abs_err_by_dtype": {dt: 1e-3}, "passes": {"pass": t},
         "source": "src/repro_torch/csrc/im2col_gemm.cu", "replaces": "x.py:1"}
    if ab:
        r["float64_err_by_route"] = {dt: {"wgmma": 1e-3, "mma.sync": 1e-3}}
    monkeypatch.setattr(smoke, "PATH_DTYPES", {"pass": {kernel: {dt: n}}})
    monkeypatch.setattr(smoke, "PATH_ROUTES", {"pass": {kernel: {dt: routes or {}}}})
    row, = smoke.kernel_rows({kernel: r}, {"pass": None}, {"pass"}, "card")
    assert row["source"] == want
    assert row["launches"] == n and row["ms"] == 1.0
    assert ("ab_ms" in row) == ab
