"""The port's measured profiler and GPU platform, on the CPU (``device="cpu"``
is for the tests; the card runs them in ``tests/test_torch_gpu.py -k
profile`` and ``chip_smoke.py`` phase 7): the NaN pattern of the base
columns against the reference's host profiler, tile columns running their
plain versions, the DLT profile, ``GpuPlatform`` (columns, refusal without a
card, dataset persistence, calibration onto tile columns) and the
``MeasuredProvider`` under ``select``.

Times these tests measure are CPU wall times and are only checked to be positive
and finite; no device time exists on the CPU (NaN). No test writes under
``artifacts/``: every store is in ``tmp_path``.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest
import torch

from repro.core import autotune as JT
from repro.primitives import conv as JC
from repro.profiler import host as JH
from repro.service import platforms as JPF
from repro_torch.core import autotune as TT
from repro_torch.core import selection as TS
from repro_torch.core.perfmodel import fit_perf_model
from repro_torch.kernels import common
from repro_torch.models import cnn_zoo as TZ
from repro_torch.primitives import conv as TC
from repro_torch.primitives import layouts as TL
from repro_torch.profiler import device as TD
from repro_torch.profiler.dataset import PerfDataset
from repro_torch.service import artifacts as TA
from repro_torch.service import platforms as TPF

# tiny pool: applicable and inapplicable cells for every family
POOL = [(8, 4, 8, 1, 3), (8, 4, 9, 2, 1), (6, 3, 10, 1, 5)]
DLT_POOL = [(4, 6), (3, 5)]
FEW = ["direct-sum2d", "im2col-copy-ab-ki", "winograd-2x2-3x3", "conv-1x1-gemm-ab-ki",
       "im2col-copy-ab-ki@mm-128x128x128", "conv-1x1-gemm-ab-ki@conv-bk64",
       "winograd-2x2-3x3@wino-128x128", "winograd-4x4-3x3@mm-256x128x128"]


def test_base_columns_nan_pattern_matches_reference_host_profiler():
    """Over every runnable base primitive: NaN exactly where the
    reference's host profiler gives NaN, finite positive elsewhere; the
    device times are NaN on the CPU."""
    want = JH.profile_primitive_batch(POOL, JC.RUNNABLE, repeats=1)
    got = TD.profile_primitive_batch(POOL, TC.RUNNABLE, repeats=1, device="cpu")
    assert list(TC.RUNNABLE) == list(JC.RUNNABLE)
    assert got.wall.shape == want.shape
    assert np.array_equal(np.isnan(got.wall), np.isnan(want))
    assert (got.wall[np.isfinite(got.wall)] > 0).all()
    assert np.isnan(got.device).all()


def test_tile_columns_run_their_plain_versions_on_the_cpu():
    """Tile columns are timed through ``conv_variant_call`` (on CPU tensors
    the kernels' plain versions: no launch), NaN where the base is
    inapplicable, and compute what their base primitive computes."""
    cols = TT.pallas_columns()
    common.reset_launches()
    got = TD.profile_primitive_batch(POOL, cols, repeats=1, device="cpu")
    assert not any(common.LAUNCHES.values())
    base = [TC.split_tile(c)[0] for c in cols]
    pattern = TD.profile_primitive_batch(POOL, base, repeats=1, device="cpu").wall
    assert np.array_equal(np.isnan(got.wall), np.isnan(pattern))
    assert np.isfinite(got.wall).sum() >= len(POOL) * 8
    rng = np.random.default_rng(0)
    for col in cols:
        k, c, im, s, f = next(cfg for cfg in POOL if TD.applicable(col, *cfg))
        x = torch.from_numpy(rng.standard_normal((c, im, im)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((k, c, f, f)).astype(np.float32))
        torch.testing.assert_close(TD.column_callable(col, s)(x, w),
                                   TC.run_primitive(TC.split_tile(col)[0], x, w, s),
                                   rtol=1e-4, atol=1e-4)


def test_inputs_follow_the_reference_draws():
    """One ``default_rng(0)`` shared across the batch, drawn only for
    applicable cells, image then weights: the inputs a column sees are the
    reference's."""
    seen = []
    orig = TD.time_callable

    def record(fn, *args, **kw):
        seen.append([a.clone() for a in args])
        return orig(fn, *args, **kw)

    import repro_torch.profiler.device as mod
    mp = pytest.MonkeyPatch()
    mp.setattr(mod, "time_callable", record)
    try:
        TD.profile_primitive_batch(POOL[:2], ["im2col-copy-ab-ki", "conv-1x1-gemm-atb-ik"],
                                   repeats=1, device="cpu")
    finally:
        mp.undo()
    rng = np.random.default_rng(0)
    want = []
    for k, c, im, s, f in POOL[:2]:
        for name in ("im2col-copy-ab-ki", "conv-1x1-gemm-atb-ik"):
            if JC.REGISTRY[name].applicable(k, c, im, s, f):
                x = rng.standard_normal((c, im, im)).astype(np.float32)
                w = rng.standard_normal((k, c, f, f)).astype(np.float32)
                lay = JC.REGISTRY[name].in_layout
                want.append((np.asarray(TL.from_chw(torch.from_numpy(x), lay)), w))
    assert len(seen) == len(want) == 3
    for (x, w), (wx, ww) in zip(seen, want):
        assert x.is_contiguous() and np.array_equal(x.numpy(), wx)
        assert np.array_equal(w.numpy(), ww)


def test_dlt_profile_shape_and_order():
    got = TD.profile_dlt_batch(DLT_POOL, repeats=1, device="cpu")
    assert got.wall.shape == (2, 6) and (got.wall > 0).all()
    assert TD.dlt_columns() == [TL.dlt_name(s, d) for s, d in TL.dlt_pairs() if s != d]
    assert TD.profile_dlt("chw", "chw", 4, 6, device="cpu") == (0.0, 0.0)
    ds = TD.profile_dlt_dataset(DLT_POOL, repeats=1, device="cpu")
    assert ds.wall.columns == TD.dlt_columns() and ds.wall.platform == "cpu"
    assert ds.device.feats.shape == (2, 2)


def test_time_callable_median_on_the_cpu():
    calls = []
    t = TD.time_callable(lambda: calls.append(1), repeats=5, warmup=2, device="cpu")
    assert len(calls) == 7 and t.wall > 0 and np.isnan(t.device)


# ---------------------------------------------------------------------------
# tile columns, GpuPlatform
# ---------------------------------------------------------------------------

def test_tile_columns_extend_the_reference():
    """The port's tile columns are every kernel's variants over the five
    bases (55); the ``mm-*`` ones are the reference's 40, in its order."""
    from repro_torch.kernels.matmul.ops import VARIANTS
    assert TT.PALLAS_CONV_BASES == JT.PALLAS_CONV_BASES
    assert TT.pallas_columns(variants=list(VARIANTS)) == JT.pallas_columns()
    cols = TT.pallas_columns()
    assert len(cols) == 55 and len(set(cols)) == 55
    assert all(TC.is_runnable(c) for c in cols)
    families = {TC.split_tile(c)[1].split("-")[0] for c in cols}
    assert families == {"mm", "conv", "wino"}


def test_gpu_platform_columns_and_refusals(monkeypatch):
    plat = TPF.get_platform("gpu", device="cpu")
    assert isinstance(plat, TPF.GpuPlatform) and plat.name == "gpu"
    assert len(plat.columns) == 76 and plat.columns[:21] == list(TC.RUNNABLE)
    assert plat.base_column("winograd-2x2-3x3@wino-128x128") == "winograd-2x2-3x3"
    assert plat.fingerprint().startswith("cpu/r=9/cols=")
    assert "cpus=" in TPF.device_machine_id("cpu")
    with pytest.raises(ValueError, match="not runnable"):
        TPF.GpuPlatform(primitives=["kn2row", "im2col-copy-ab-ki@wino-128x128"],
                        device="cpu")
    # the other names dispatch to the port's own platforms
    assert isinstance(TPF.get_platform("host"), TPF.HostPlatform)
    for name in ("tpu", "pallas"):
        assert isinstance(TPF.get_platform(name), TPF.PallasPlatform)
    # with its default device and no card it refuses; it never profiles
    # the CPU in the card's place
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TPF.GpuPlatform()
    with pytest.raises(RuntimeError, match="CUDA"):
        TPF.get_platform("gpu")


def test_gpu_platform_dataset_persistence(tmp_path, monkeypatch):
    """GpuPlatform with a store profiles once and warm-starts the wall and
    device datasets across instances, keyed by (pool, repeats, columns,
    machine id); ``invalidate_datasets`` drops the persisted ones (the
    counterpart of ``tests/test_service.py``'s host-platform test)."""
    calls = []

    def fake_profile(configs, primitives=None, repeats=9, device="cuda"):
        calls.append(len(configs))
        feats = np.asarray(configs, np.float64)
        mk = lambda v: PerfDataset(feats, np.full((len(configs), len(primitives)), v),
                                   list(primitives), ["k", "c", "im", "s", "f"], "cpu")
        return TD.Timing(mk(1e-4), mk(2e-5))

    monkeypatch.setattr(TD, "profile_primitive_dataset", fake_profile)
    store = TA.ArtifactStore(str(tmp_path), device="cpu")
    pool = [(8, 4, 8, 1, 3), (16, 8, 8, 1, 3)]
    prims = ["im2col-copy-ab-ki", "im2col-copy-ab-ki@mm-128x128x128"]
    mk = lambda **kw: TPF.GpuPlatform(configs=pool, primitives=prims, store=store,
                                      device="cpu", **kw)
    p1 = mk(repeats=3)
    ds1 = p1.primitive_dataset()
    assert calls == [2] and np.all(p1.device_dataset().times == 2e-5)
    p2 = mk(repeats=3)
    assert p2.primitive_dataset().fingerprint() == ds1.fingerprint()
    assert calls == [2]                               # warm: no second measurement
    assert np.all(p2.device_dataset().times == 2e-5)
    mk(repeats=5).primitive_dataset()                 # another address
    assert calls == [2, 2]
    p2.invalidate_datasets()
    mk(repeats=3).primitive_dataset()                 # persisted copy dropped
    assert calls == [2, 2, 2]


def test_calibrate_base_primitives_onto_tile_columns(tmp_path):
    """A base model over plain primitives transfers onto the platform's tile
    columns (``base_of=split_tile``): each tile head starts as its base's,
    factor-corrected and fine-tuned from a profiled sample."""
    arm = JPF.get_platform("arm", max_triplets=4)
    tr, va, _ = arm.primitive_dataset().split()
    base = fit_perf_model("lin", tr.feats, tr.times, va.feats, va.times,
                          columns=arm.primitive_dataset().columns, device="cpu")
    from repro_torch.service.platforms import PlatformModels
    dlt = fit_perf_model("lin", np.array([[4.0, 6], [8, 10], [16, 12], [3, 20]]),
                         np.full((4, 6), 1e-5) * np.arange(1, 5)[:, None],
                         np.array([[4.0, 6]]), np.full((1, 6), 1e-5), device="cpu")
    models = PlatformModels(base, dlt, "base", "native")
    pool = [(8, 4, 8, 1, 3), (8, 4, 9, 2, 1), (16, 8, 10, 1, 3), (8, 8, 6, 1, 1),
            (4, 4, 12, 1, 3), (8, 4, 7, 1, 3)]
    plat = TPF.GpuPlatform(configs=pool, dlt_pairs=DLT_POOL, primitives=FEW,
                           repeats=1, device="cpu")
    sample = plat.measure_sample(4)
    assert list(sample.columns) == FEW and sample.n == 4
    fixed = plat.calibrate(models, mode="factor", sample=sample, device="cpu")
    assert fixed.mode == "factor" and list(fixed.prim.columns) == FEW
    tuned = plat.calibrate(models, mode="finetune", sample=sample, max_iters=5,
                           device="cpu")
    assert tuned.mode == "finetune" and tuned.prim.device.type == "cpu"
    assert tuned.dlt.columns == TD.dlt_columns() and tuned.dlt.device.type == "cpu"


def test_measured_provider_selects_on_the_cpu():
    """``select`` under measured costs: every conv gets an applicable
    column, and the measured matrices have the provider's shape."""
    spec = TZ.get("edge_cnn")
    prov = TS.MeasuredProvider(repeats=1, columns=FEW, device="cpu")
    sel = TS.select(spec, prov)
    convs = [(i, n) for i, n in enumerate(spec.nodes) if isinstance(n, TZ.ConvLayer)]
    for i, node in convs:
        assert TD.applicable(sel.assignment[i], *node.config)
    assert sel.optimal
    assert prov.dlt_cost_matrix(np.array(DLT_POOL)).shape == (2, 6)
