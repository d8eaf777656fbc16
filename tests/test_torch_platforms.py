"""The port's last two platforms against the reference on the CPU: the
simulated tile platform (``PallasPlatform`` and the analytic tile-cost
surface of ``core/autotune.py``) and the measured host-CPU platform
(``HostPlatform`` over ``profiler/host.py``).

The analytic surface is numpy in both packages, so costs, datasets,
fingerprints and model addresses are held bit for bit. Selections from the
reference's calibrated models carried across must give the reference's
assignment; served plans are held to the reference's compiled plan at
1e-4 (fp32, sum order only). The host platform measures, so its times
differ run to run: its columns, fingerprint, NaN pattern and store
addresses are what is held. No test writes under ``artifacts/``.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import autotune as JAT
from repro.kernels.im2col_gemm.ops import VARIANTS as J_CONV_VARIANTS
from repro.kernels.matmul.ops import VARIANTS as J_MM_VARIANTS
from repro.kernels.winograd.ops import VARIANTS as J_WINO_VARIANTS
from repro.models import cnn_zoo as JZ
from repro.primitives import conv as JC
from repro.primitives import executor as JE
from repro.primitives import layouts as JL
from repro.primitives import plan as JP
from repro.profiler import host as JH
from repro.profiler import pools as JPO
from repro.profiler.dataset import PerfDataset as JDataset
from repro.service import artifacts as JA
from repro.service import pipeline as JPL
from repro.service import platforms as JPF
from repro_torch import convert
from repro_torch.core import autotune as TAT
from repro_torch.core import selection as TS
from repro_torch.primitives import executor as TE
from repro_torch.profiler import host as TH
from repro_torch.profiler import pools as TPO
from repro_torch.profiler.dataset import PerfDataset as TDataset
from repro_torch.service import artifacts as TA
from repro_torch.service import pipeline as TPL
from repro_torch.service import platforms as TPF
from repro_torch.service.serving.server import OptimisedServer

PLAN_TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(1, 1, 1), (7, 129, 300), (128, 128, 128), (255, 64, 1024),
          (4096, 27, 784), (65536, 4096, 512), (131072, 32768, 32768)]
SCALES = {"noisy": {}, "exact": {"noisy": False}, "scaled": {"time_scale": 2.0}}
# small enough for the reference's calibration and NN2 fits to take seconds
PLATFORM_KW = dict(max_triplets=5)
BASE_TRAIN = dict(max_iters=150, patience=40)
CALIBRATE = dict(budget=0.05, max_iters=100)
# three small configs: a 3x3 stride-1 layer (every family applies), a 1x1
# and a strided 5x5 (Winograd and kn2 inapplicable)
HOST_CONFIGS = [(8, 4, 8, 1, 3), (8, 4, 8, 1, 1), (4, 4, 9, 2, 5)]


# ---------------------------------------------------------------------------
# The analytic tile-cost surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(J_MM_VARIANTS))
def test_analytic_cost_matches_reference(variant):
    blocks = J_MM_VARIANTS[variant]
    assert TAT.MM_VARIANTS[variant] == blocks
    for (M, K, N), dtype_bytes in itertools.product(SHAPES, (2, 4)):
        want = JAT.analytic_cost(M, K, N, *blocks, dtype_bytes=dtype_bytes)
        assert TAT.analytic_cost(M, K, N, *blocks, dtype_bytes=dtype_bytes) == want
        got = TAT._analytic_cost_np(np.array([M]), K, N, *blocks, dtype_bytes)
        np.testing.assert_array_equal(got, JAT._analytic_cost_np(
            np.array([M]), K, N, *blocks, dtype_bytes))


def test_variant_blocks_price_the_reference_tables():
    """Every variant of the three kernels' reference tables (and none, and an
    unknown name) lowers to the reference's blocks, never the card's tiles."""
    names = [None, "mm-1x1x1", "conv-bk7", "wino-1x1", *J_MM_VARIANTS,
             *J_CONV_VARIANTS, *J_WINO_VARIANTS]
    for v in names:
        assert TAT._variant_blocks(v) == JAT._variant_blocks(v), v


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("columns", ["reference", "port"])
def test_conv_tile_time_batch_matches_reference(columns, scale):
    """Over the 5-triplet pool and the 40 default columns or the port's 55
    ``pallas_columns()``: bit for bit, NaN exactly where the reference's."""
    cfg = np.asarray(TPO.config_pool(max_triplets=5), np.int64)
    assert cfg.tolist() == np.asarray(JPO.config_pool(max_triplets=5)).tolist()
    cols = None if columns == "reference" else TAT.pallas_columns()
    got = TAT.conv_tile_time_batch(cfg, cols, **SCALES[scale])
    want = JAT.conv_tile_time_batch(cfg, cols, **SCALES[scale])
    assert got.shape == (len(cfg), 40 if cols is None else 55)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=r"\(L, 5\)"):
        TAT.conv_tile_time_batch(cfg[:, :4])


@pytest.mark.parametrize("scale", list(SCALES))
def test_pallas_dlt_time_batch_matches_reference(scale):
    pairs = np.asarray(TPO.dlt_pool(), np.int64)
    got = TAT.pallas_dlt_time_batch(pairs, **SCALES[scale])
    assert got.shape == (len(pairs), 6) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, JAT.pallas_dlt_time_batch(pairs, **SCALES[scale]))


# ---------------------------------------------------------------------------
# PallasPlatform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"time_scale": 2.0},
                                {"variants": list(TAT.TILE_VARIANTS)},
                                {"noisy": False, "name": "tpu-b"},
                                {"bases": ["winograd-2x2-3x3", "conv-1x1-gemm-ab-ki"]}],
                         ids=["default", "drifted", "all-variants", "exact-renamed",
                              "two-bases"])
def test_pallas_platform_matches_reference(kw):
    """Columns, ``base_column``, fingerprint, datasets and model addresses
    (``tests/test_multibackend.py:130``) equal the reference's, so either
    package warm-starts from the other's store."""
    got = TPF.PallasPlatform(**PLATFORM_KW, **kw)
    want = JPF.PallasPlatform(**PLATFORM_KW, **kw)
    assert got.name == want.name and got.columns == want.columns
    if not kw:
        assert len(got.columns) == 40
    assert [got.base_column(c) for c in got.columns] == [
        want.base_column(c) for c in want.columns]
    assert got.fingerprint() == want.fingerprint()
    assert got.pool_fingerprint() == want.pool_fingerprint()
    for g, w in ((got.primitive_dataset(), want.primitive_dataset()),
                 (got.dlt_dataset(), want.dlt_dataset())):
        assert g.columns == w.columns and g.platform == w.platform
        np.testing.assert_array_equal(g.feats, w.feats)
        np.testing.assert_array_equal(g.times, w.times)
        assert g.fingerprint() == w.fingerprint()
    for role in ("prim", "dlt"):
        fields = got._model_fields(role, "nn2", seed=0, mode="native")
        assert fields == want._model_fields(role, "nn2", seed=0, mode="native")
        assert TA.digest(fields) == JA.digest(fields)
    cfgs = np.asarray(TPO.config_pool(max_triplets=3), np.int64)
    np.testing.assert_array_equal(got.measure_sample(6, seed=2).times,
                                  want.measure_sample(6, seed=2).times)
    np.testing.assert_array_equal(got.profile(cfgs), want.profile(cfgs))


def test_pallas_provider_matches_profile():
    """``tests/test_multibackend.py:117``: the provider prices what the
    platform profiles (unscaled), and both equal the reference's."""
    tpu = TPF.PallasPlatform(**PLATFORM_KW)
    prov = tpu.cost_provider()
    assert isinstance(prov, TAT.PallasTileProvider) and prov.columns == tpu.columns
    cfgs = np.array([[64, 32, 28, 1, 3], [128, 64, 14, 1, 5]], np.int64)
    np.testing.assert_array_equal(tpu.profile(cfgs), prov.primitive_cost_matrix(cfgs))
    jprov = JPF.PallasPlatform(**PLATFORM_KW).cost_provider()
    np.testing.assert_array_equal(prov.primitive_cost_matrix(cfgs),
                                  jprov.primitive_cost_matrix(cfgs))
    pairs = np.array([[16, 30], [64, 13]], np.int64)
    np.testing.assert_array_equal(prov.dlt_cost_matrix(pairs),
                                  jprov.dlt_cost_matrix(pairs))
    assert prov.primitive_cost_matrix(np.zeros((0, 5))).shape == (0, 40)
    assert prov.dlt_cost_matrix(np.zeros((0, 2))).shape == (0, 6)
    drifted = TPF.PallasPlatform(**PLATFORM_KW, time_scale=3.0)
    np.testing.assert_array_equal(drifted.cost_provider().primitive_cost_matrix(cfgs),
                                  prov.primitive_cost_matrix(cfgs))


@pytest.fixture(scope="module")
def ref_intel_base():
    """The reference's intel base (5 triplets) and the port's copy."""
    base = JPF.get_platform("intel", **PLATFORM_KW).pretrain(**BASE_TRAIN)
    return base, _carry(base)


def _carry(models):
    """The reference's ``PlatformModels`` -> the port's, on the CPU."""
    return TPF.PlatformModels(
        convert.perfmodel_from_state(models.prim.to_state(), device="cpu"),
        convert.perfmodel_from_state(models.dlt.to_state(), device="cpu"),
        models.platform, models.mode, budget=models.budget)


def test_per_backend_warm_start_roundtrip(tmp_path, ref_intel_base):
    """``tests/test_multibackend.py:145`` in the port: arm and tpu optimised
    cold from one intel base, then warm, byte-identical; the two backends
    share no artifact."""
    store = TA.ArtifactStore(str(tmp_path), device="cpu")
    kw = dict(base=ref_intel_base[1], executable=True, store=store,
              device="cpu", **CALIBRATE)
    cold = {b: TPL.optimise("edge_cnn", TPF.get_platform(b, **PLATFORM_KW), **kw)
            for b in ("arm", "tpu")}
    assert not cold["arm"].warm and not cold["tpu"].warm
    warm = {b: TPL.optimise("edge_cnn", TPF.get_platform(b, **PLATFORM_KW), **kw)
            for b in ("arm", "tpu")}
    x = np.array([[64, 32, 28, 1, 3]], np.float64)
    for b in ("arm", "tpu"):
        assert warm[b].warm_models and warm[b].warm_selection
        assert warm[b].models.prim.fingerprint() == cold[b].models.prim.fingerprint()
        np.testing.assert_array_equal(warm[b].models.prim.predict(x),
                                      cold[b].models.prim.predict(x))
        assert warm[b].assignment == cold[b].assignment
    assert set(cold["arm"].assignment.values()) != set(cold["tpu"].assignment.values())
    assert all("@mm-" in c for c in cold["tpu"].columns)


@pytest.fixture(scope="module")
def ref_tpu(ref_intel_base):
    """The reference's intel -> tpu calibration and its edge_cnn selection."""
    tpu = JPF.PallasPlatform(**PLATFORM_KW)
    models = tpu.calibrate(ref_intel_base[0], **CALIBRATE)
    return JPL.optimise("edge_cnn", tpu, models=models, executable=True)


def _ref_plan_output(assignment, weights, xs):
    spec = JZ.get("edge_cnn")
    plan = JP.compile_plan(spec, assignment)
    return np.asarray(plan(jnp.asarray(xs), weights)[plan.sinks[-1]])


def test_tpu_selection_from_reference_models_matches_reference(ref_tpu):
    """The reference's calibrated intel -> tpu models carried across: the
    port's ``optimise(executable=True)`` gives the reference's assignment
    (tile columns) and cost, and the port's plan output is within 1e-4 of
    the reference's ``execute``."""
    models = _carry(ref_tpu.models)
    opt = TPL.optimise("edge_cnn", TPF.get_platform("tpu", **PLATFORM_KW),
                       models=models, executable=True, device="cpu")
    assert opt.assignment == ref_tpu.assignment
    assert opt.columns == ref_tpu.columns
    assert opt.predicted_cost_s == pytest.approx(ref_tpu.predicted_cost_s, rel=1e-5)
    assert any(JC.split_tile(c)[1] for c in opt.assignment.values())
    spec = opt.spec
    jw = JE.make_weights(JZ.get("edge_cnn"), seed=3)
    tw = TE.make_weights(spec, 3, device="cpu")
    x = np.random.default_rng(3).standard_normal((3, 32, 32)).astype(np.float32)
    want = JE.execute(JZ.get("edge_cnn"), ref_tpu.assignment, jw, x=jnp.asarray(x))
    got = TE.execute(spec, opt.assignment, tw, x=x, device="cpu")
    for node, y in want.outputs.items():
        np.testing.assert_allclose(got.outputs[node].numpy(), np.asarray(y),
                                   **PLAN_TOL)


def test_routed_arm_and_tpu_serving_matches_the_oracle(ref_intel_base):
    """``tests/test_multibackend.py:232`` in the port: edge_cnn optimised
    for arm and tpu from one intel base, registered as routed backends on
    the CPU; every response within 1e-4 of the reference's compiled plan of
    the backend that served it."""
    kw = dict(base=ref_intel_base[1], executable=True, device="cpu", **CALIBRATE)
    opts = {b: TPL.optimise("edge_cnn", TPF.get_platform(b, **PLATFORM_KW), **kw)
            for b in ("arm", "tpu")}
    jw = JE.make_weights(JZ.get("edge_cnn"), seed=0)
    server = OptimisedServer(latency_budget_ms=50.0, device="cpu")
    for b, o in opts.items():
        server.register(o, backend=b, max_inflight=1,
                        weights={k: np.asarray(v) for k, v in jw.items()})
    xs = np.random.default_rng(0).standard_normal((8, 3, 32, 32)).astype(np.float32)
    tickets = [server.submit("edge_cnn", x) for x in xs]
    pinned = [server.submit(f"edge_cnn#{b}", xs[0]) for b in ("arm", "tpu")]
    server.pump()
    s = server.stats("edge_cnn")
    assert set(s["backends"]) == {"arm", "tpu"} and s["images"] == 10
    assert not s["failed_dispatches"] and not s["fallback_images"]
    for t, x in zip(tickets + pinned, [*xs, xs[0], xs[0]]):
        backend = t.net.split("#")[1]
        want = _ref_plan_output(opts[backend].assignment, jw, x[None])
        np.testing.assert_allclose(t.result, want[0], **PLAN_TOL)
    server.stop()


# ---------------------------------------------------------------------------
# HostPlatform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"repeats": 3},
                                {"primitives": ["kn2row", "im2col-copy-ab-ki"]}],
                         ids=["default", "repeats", "primitives"])
def test_host_platform_columns_and_fingerprint_match_reference(kw):
    got, want = TPF.HostPlatform(**kw), JPF.HostPlatform(**kw)
    assert got.name == want.name == "host"
    assert got.columns == want.columns
    assert got.fingerprint() == want.fingerprint()
    assert got.fingerprint().startswith("host-cpu/")
    if not kw:
        assert len(got.columns) == 21
    assert TPF.host_machine_id() == JPF.host_machine_id()
    prov = got.cost_provider()
    assert isinstance(prov, TS.MeasuredProvider)
    assert str(prov.device) == "cpu" and prov.columns == got.columns


def test_host_platform_nan_pattern_matches_reference():
    """Measured on this CPU by both packages over a 3-config pool: NaN in
    the same cells (inapplicable), every other cell a positive time."""
    plat = TPF.HostPlatform(configs=HOST_CONFIGS, repeats=1)
    got = plat.profile(np.asarray(HOST_CONFIGS))
    want = JH.profile_primitive_batch(HOST_CONFIGS, list(JC.RUNNABLE), repeats=1)
    assert got.shape == want.shape == (3, 21)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert (got[np.isfinite(got)] > 0).all()
    ds = plat.primitive_dataset()
    assert ds.platform == "host-cpu" and ds.columns == plat.columns
    assert np.array_equal(np.isnan(ds.times), np.isnan(want))
    dlt = TPF.HostPlatform(dlt_pairs=[(4, 8)], repeats=1).dlt_dataset()
    assert dlt.columns == [JL.dlt_name(s, d) for s, d in JL.dlt_pairs() if s != d]
    assert dlt.times.shape == (1, 6) and (dlt.times > 0).all()


def test_host_platform_refuses_tile_columns():
    tile = "im2col-copy-ab-ki@mm-128x128x128"
    with pytest.raises(ValueError, match="tile columns"):
        TPF.HostPlatform(primitives=["kn2row", tile])
    with pytest.raises(ValueError, match="tile columns"):
        TH.profile_primitive_batch([HOST_CONFIGS[0]], [tile], repeats=1)
    with pytest.raises(ValueError, match="tile columns"):
        TH.profile_primitive(tile, *HOST_CONFIGS[0], repeats=1)


def _fake_profile(calls, label):
    def fake(configs, primitives=None, repeats=9):
        calls.append(len(configs))
        return TDataset(np.asarray(configs, np.float64),
                        np.full((len(configs), len(primitives)), 1e-4),
                        list(primitives), ["k", "c", "im", "s", "f"], label)
    return fake


def test_host_platform_dataset_persistence(tmp_path, monkeypatch):
    """``tests/test_service.py:388`` in the port: with a store the host
    platform profiles once and warm-starts across instances, keyed by
    (pool, repeats, columns, machine id); ``invalidate_datasets`` drops the
    persisted dataset."""
    calls = []
    monkeypatch.setattr(TH, "profile_primitive_dataset", _fake_profile(calls, TH.LABEL))
    store = TA.ArtifactStore(str(tmp_path), device="cpu")
    pool = [(8, 4, 8, 1, 3), (16, 8, 8, 1, 3)]
    prims = ["im2col-copy-ab-ki", "kn2row"]
    p1 = TPF.HostPlatform(configs=pool, primitives=prims, repeats=3, store=store)
    ds1 = p1.primitive_dataset()
    assert calls == [2]
    p2 = TPF.HostPlatform(configs=pool, primitives=prims, repeats=3, store=store)
    assert p2.primitive_dataset().fingerprint() == ds1.fingerprint()
    assert calls == [2]                       # warm: no second measurement
    TPF.HostPlatform(configs=pool, primitives=prims, repeats=5,
                     store=store).primitive_dataset()
    assert calls == [2, 2]                    # another address
    p2.invalidate_datasets()
    TPF.HostPlatform(configs=pool, primitives=prims, repeats=3,
                     store=store).primitive_dataset()
    assert calls == [2, 2, 2]
    fields = p1._dataset_fields("prim", "wall")
    assert fields["machine"] == TPF.host_machine_id() and fields["quantity"] == "wall"


def test_host_platform_never_reads_the_reference_dataset(tmp_path, monkeypatch):
    """A store shared with the reference: the reference's ``HostPlatform``
    persists its (JAX) dataset, the port's measures its own under another
    address, and neither package reads the other's."""
    jcalls, tcalls = [], []

    def jfake(configs, primitives=None, repeats=9):
        jcalls.append(len(configs))
        return JDataset(np.asarray(configs, np.float64),
                        np.full((len(configs), len(primitives)), 2e-4),
                        list(primitives), ["k", "c", "im", "s", "f"], "host-cpu")
    monkeypatch.setattr(JH, "profile_primitive_dataset", jfake)
    monkeypatch.setattr(TH, "profile_primitive_dataset", _fake_profile(tcalls, TH.LABEL))
    kw = dict(configs=HOST_CONFIGS[:2], primitives=["kn2row"], repeats=3)
    jplat = JPF.HostPlatform(store=JA.ArtifactStore(str(tmp_path)), **kw)
    jplat.primitive_dataset()
    tplat = TPF.HostPlatform(store=TA.ArtifactStore(str(tmp_path), device="cpu"), **kw)
    ds = tplat.primitive_dataset()
    assert jcalls == [2] and tcalls == [2]
    assert (ds.times == 1e-4).all()
    jfields = jplat._dataset_fields("prim", HOST_CONFIGS[:2])
    tfields = tplat._dataset_fields("prim", "wall")
    assert {k: v for k, v in tfields.items() if k != "quantity"} == jfields
    assert TA.digest(tfields) != JA.digest(jfields)
    assert len(TA.ArtifactStore(str(tmp_path), device="cpu").entries("datasets")) == 2
    JPF.HostPlatform(store=JA.ArtifactStore(str(tmp_path)), **kw).primitive_dataset()
    assert jcalls == [2]                      # the reference still warm on its own
