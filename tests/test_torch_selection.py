"""The port's selection path against the reference on identical numpy
inputs: normalisation, the PBQP solver, compiled column traits, the
simulated datasets, the committed performance models (load, fingerprint,
predict, factor correction, column subsets), ``select`` under simulated and
model costs on every zoo net, ``optimise``/``reoptimise`` on copies of the
committed artifact store, the store itself across the two packages, and
the selected plan served on the CPU.

Tolerances: the simulators, the solver and the stores are numpy in both
packages, so their outputs are held bit for bit; the MLP forward (torch
fp32 against JAX fp32) is held at rtol=2e-5 (6.3e-6 measured over the arm
pool) and solver costs under it at 1e-5 relative; the served plan at the
reference's 1e-3. No test writes under ``artifacts/``: stores are copies in
``tmp_path``.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import normalize as JN
from repro.core import pbqp as JQ
from repro.core import perfmodel as JM
from repro.core import selection as JS
from repro.models import cnn_zoo as JZ
from repro.primitives import conv as JC
from repro.primitives import executor as JE
from repro.primitives import plan as JP
from repro.profiler import dataset as JD
from repro.service import artifacts as JA
from repro.service import pipeline as JPL
from repro.service import platforms as JPF
from repro_torch import convert
from repro_torch.core import normalize as TN
from repro_torch.core import pbqp as TQ
from repro_torch.core import perfmodel as TM
from repro_torch.core import selection as TS
from repro_torch.models import cnn_zoo as TZ
from repro_torch.primitives import conv as TC
from repro_torch.profiler import dataset as TD
from repro_torch.service import artifacts as TA
from repro_torch.service import pipeline as TPL
from repro_torch.service import platforms as TPF
from repro_torch.service.serving.server import OptimisedServer

ROOT = Path(__file__).resolve().parents[1]
ARTIFACTS = ROOT / "artifacts"
MODEL_DIRS = sorted(p.name for p in (ARTIFACTS / "models").iterdir())
ARM_PRIM, ARM_DLT = "a84acd505b89b475", "b55b99f51ffb3e50"
ARM_MODELS_FP = "ed27174dfbf36a63-fd76c2275cf86102"
EDGE_CNN_SELECTION = ARTIFACTS / "selections" / "cd7c5dc68f699685" / "data.json"
OPT_ARGS = dict(max_triplets=60, max_iters=2000, executable=True)

PRED_TOL = dict(rtol=2e-5, atol=0.0)
COST_RTOL = 1e-5
SERVE_TOL = dict(rtol=1e-3, atol=1e-3)


def _model_path(name):
    return str(ARTIFACTS / "models" / name / "model.npz")


@pytest.fixture(scope="module")
def arm_models():
    """The committed arm pair in both packages: (ref prim, ref dlt, port
    prim, port dlt), the port's on the CPU."""
    return (JM.PerfModel.load(_model_path(ARM_PRIM)),
            JM.PerfModel.load(_model_path(ARM_DLT)),
            TM.PerfModel.load(_model_path(ARM_PRIM), device="cpu"),
            TM.PerfModel.load(_model_path(ARM_DLT), device="cpu"))


@pytest.fixture(scope="module")
def arm_pools():
    """The arm 60-triplet primitive pool and the DLT pool (reference)."""
    return (JD.simulate_primitive_dataset("arm", max_triplets=60),
            JD.simulate_dlt_dataset("arm"))


def _store_copy(tmp_path, *, selections=True):
    root = tmp_path / "store"
    shutil.copytree(ARTIFACTS / "models", root / "models")
    if selections:
        shutil.copytree(ARTIFACTS / "selections", root / "selections")
    return str(root)


def _hold_predictions(got, want):
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **PRED_TOL)


# ---------------------------------------------------------------------------
# normalize, pbqp, compiled traits, simulators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log", [True, False])
def test_normalize_round_trips_like_reference(log, rng):
    x = np.exp(rng.standard_normal((40, 6)))
    x[rng.random(x.shape) < 0.2] = np.nan
    x[:, 3] = 2.5                                        # constant column
    j, t = JN.LogStandardizer(log=log).fit(x), TN.LogStandardizer(log=log).fit(x)
    assert t.to_dict() == j.to_dict()
    z = t.transform(x)
    assert z.dtype == np.float32
    assert np.array_equal(z, j.transform(x), equal_nan=True)
    assert np.array_equal(t.inverse(z), j.inverse(z), equal_nan=True)
    np.testing.assert_allclose(t.inverse(z), x, rtol=1e-5)
    again = TN.LogStandardizer.from_dict(json.loads(json.dumps(j.to_dict())))
    assert np.array_equal(again.transform(x), z, equal_nan=True)
    pred = x * (1 + 0.1 * rng.standard_normal(x.shape))
    assert TN.mdrae(pred, x) == JN.mdrae(pred, x)
    assert np.array_equal(TN.mdrae_per_column(pred, x),
                          JN.mdrae_per_column(pred, x), equal_nan=True)


def _random_graph_arrays(seed, n, max_choices=4, p_inf=0.3, extra_edges=None):
    """tests/test_pbqp.py's random graph, as (nodes, edges) arrays."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, max_choices + 1, size=n)
    nodes = []
    for i in range(n):
        c = rng.uniform(0, 10, sizes[i])
        if rng.random() < p_inf:
            c[rng.integers(0, sizes[i])] = np.inf
        if not np.isfinite(c).any():
            c[0] = 1.0
        nodes.append((i, c))
    edges = [(i, i + 1, rng.uniform(0, 5, (sizes[i], sizes[i + 1])))
             for i in range(n - 1)]
    extra = rng.integers(0, n) if extra_edges is None else extra_edges
    for _ in range(extra):
        u, v = rng.integers(0, n, 2)
        if u != v:
            edges.append((u, v, rng.uniform(0, 5, (sizes[u], sizes[v]))))
    return nodes, edges


def _chain(seed):
    rng = np.random.default_rng(seed)
    nodes = [(i, rng.uniform(0, 10, 5)) for i in range(200)]
    return nodes, [(i, i + 1, rng.uniform(0, 5, (5, 5))) for i in range(199)]


def _diamond(seed):
    rng = np.random.default_rng(seed)
    nodes = [(i, rng.uniform(0, 10, 3)) for i in range(4)]
    return nodes, [(u, v, rng.uniform(0, 5, (3, 3)))
                   for u, v in ((0, 1), (0, 2), (1, 3), (2, 3))]


def _inapplicable(_):
    return ([("a", np.array([np.inf, 5.0])), ("b", np.array([1.0, np.inf, 2.0]))],
            [("a", "b", np.ones((2, 3)))])


PBQP_CASES = ([(f"random-{s}-{n}", lambda s=s, n=n: _random_graph_arrays(s, n))
               for s, n in ((0, 2), (1, 4), (7, 6), (42, 6), (99, 5), (2024, 6))]
              + [("dense-12", lambda: _random_graph_arrays(5, 12, extra_edges=30)),
                 ("dense-20", lambda: _random_graph_arrays(11, 20, extra_edges=60)),
                 ("ties", lambda: ([(i, np.ones(3)) for i in range(6)],
                                   [(i, (i + 1) % 6, np.zeros((3, 3))) for i in range(6)]
                                   + [(0, 3, np.zeros((3, 3)))])),
                 ("chain", lambda: _chain(0)), ("diamond", lambda: _diamond(1)),
                 ("inapplicable", lambda: _inapplicable(0))])


@pytest.mark.parametrize("case", [c for _, c in PBQP_CASES],
                         ids=[n for n, _ in PBQP_CASES])
def test_pbqp_solve_matches_reference(case):
    nodes, edges = case()
    graphs = []
    for mod in (JQ, TQ):
        g = mod.PBQPGraph()
        for n, c in nodes:
            g.add_node(n, c)
        for u, v, m in edges:
            g.add_edge(u, v, m)
        graphs.append(g)
    want, got = JQ.solve(graphs[0]), TQ.solve(graphs[1])
    assert got.assignment == want.assignment
    assert got.cost == want.cost and got.optimal == want.optimal
    assert TQ.evaluate(graphs[1], got.assignment) == got.cost
    if len(nodes) <= 6:
        assert TQ.brute_force(graphs[1]).cost == JQ.brute_force(graphs[0]).cost
    with pytest.raises(ValueError):
        TQ.PBQPGraph().add_node("x", np.array([np.inf, np.inf]))


def _tile_names():
    from repro_torch.kernels.im2col_gemm.ops import VARIANTS as CONV
    from repro_torch.kernels.matmul.ops import VARIANTS as MM
    from repro_torch.kernels.winograd.ops import VARIANTS as WINO
    runnable = [n for n in TC.PRIMITIVE_NAMES if TC.REGISTRY[n].impl is not None]
    return TC.tile_columns(runnable, sorted({**MM, **CONV, **WINO}))


@pytest.mark.parametrize("which", ["base", "tile"])
def test_compile_traits_equal_reference(which):
    names = tuple(TC.PRIMITIVE_NAMES if which == "base" else _tile_names())
    assert len(names) == (49 if which == "base" else len(names)) and names
    assert list(TC.PRIMITIVE_NAMES) == list(JC.PRIMITIVE_NAMES)
    got, want = TC.compile_traits(names), JC.compile_traits(names)
    for field in ("fam", "vec", "t_idx", "scan", "order_ki", "tile_m", "tile_n",
                  "oned", "variant_as", "in_layout", "out_layout", "key",
                  "epilogue"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    cfg = np.array(JD.simulate_primitive_dataset("arm", max_triplets=12).feats, np.int64)
    assert np.array_equal(got.applicable_mask(*cfg.T), want.applicable_mask(*cfg.T))
    assert [TC.family_of(n) for n in names] == [JC.family_of(n) for n in names]


@pytest.mark.parametrize("max_triplets", [60, None])
@pytest.mark.parametrize("platform", ["intel", "amd", "arm"])
def test_simulated_datasets_bit_equal(platform, max_triplets):
    for make, kw in (("simulate_primitive_dataset", dict(max_triplets=max_triplets)),
                     ("simulate_dlt_dataset", {})):
        got, want = getattr(TD, make)(platform, **kw), getattr(JD, make)(platform, **kw)
        assert got.columns == want.columns and got.feature_names == want.feature_names
        assert np.array_equal(got.feats, want.feats)
        assert np.array_equal(got.times, want.times, equal_nan=True)
        assert got.fingerprint() == want.fingerprint()
        tr, va, te = got.split()
        for a, b in zip((tr, va, te), want.split()):
            assert np.array_equal(a.times, b.times, equal_nan=True)
        sub = got.subsample(0.05, seed=3)
        assert sub.fingerprint() == want.subsample(0.05, seed=3).fingerprint()
    if platform == "arm" and max_triplets == 60:
        assert got.fingerprint() == "8f2dbba64db2f01e"
        assert TD.simulate_primitive_dataset("arm", max_triplets=60).fingerprint() \
            == "60db06c6ba7bcd6d"


def test_dataset_save_load_and_served_across_packages(tmp_path, rng):
    ds = TD.simulate_primitive_dataset("amd", max_triplets=8)
    ds.save(str(tmp_path / "d.npz"))
    back = JD.PerfDataset.load(str(tmp_path / "d.npz"))
    assert back.fingerprint() == ds.fingerprint()
    feats = ds.feats[:6].copy()
    feats[3] = feats[1]                                  # a shared config
    assigned = ["direct-sum2d", "kn2row", "winograd-2-3", "kn2row", "mec-col",
                "im2col-copy-ab-ki"]
    buckets = [(b, rng.uniform(1e-5, 1e-3, 6)) for b in (8, 2)]
    probes = [(ds.feats[7], "direct-sum2d", 2e-4)]
    kw = dict(columns=ds.columns, platform="amd", info={"dispatches": 5},
              probes=probes)
    got = TD.observations_to_dataset(feats, assigned, buckets, **kw)
    want = JD.observations_to_dataset(feats, assigned, buckets, **kw)
    assert got.fingerprint() == want.fingerprint()
    assert got.served_info == want.served_info
    other = TD.observations_to_dataset(feats[:2], assigned[:2], [(4, np.ones(2))],
                                       columns=ds.columns[:20], platform="amd")
    merged = TD.merge_served([got, other])
    ref = JD.merge_served([want, JD.observations_to_dataset(
        feats[:2], assigned[:2], [(4, np.ones(2))], columns=ds.columns[:20],
        platform="amd")])
    assert merged.fingerprint() == ref.fingerprint()
    assert merged.served_info == ref.served_info


# ---------------------------------------------------------------------------
# performance models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODEL_DIRS)
def test_committed_model_loads_fingerprints_and_predicts(name, arm_pools, tmp_path):
    want = JM.PerfModel.load(_model_path(name))
    got = TM.PerfModel.load(_model_path(name), device="cpu")
    assert got.kind == want.kind and list(got.columns) == list(want.columns)
    assert got.fingerprint() == want.fingerprint()
    assert got.device.type == "cpu"
    feats = arm_pools[0].feats if want.n_outputs == 49 else arm_pools[1].feats
    _hold_predictions(got.predict(feats), want.predict(feats))
    # saved by the port, read by the reference, and carried across in memory
    got.save(str(tmp_path / "m.npz"))
    assert JM.PerfModel.load(str(tmp_path / "m.npz")).fingerprint() == want.fingerprint()
    carried = convert.perfmodel_from_state(want.to_state(), device="cpu")
    assert carried.fingerprint() == want.fingerprint()
    assert np.array_equal(carried.predict(feats[:50]), got.predict(feats[:50]),
                          equal_nan=True)


def test_arm_pair_fingerprint(arm_models):
    jp, jd, tp, td = arm_models
    models = TPF.PlatformModels(tp, td, "sim/arm/noisy=1/mt=60", "native")
    assert models.fingerprint() == ARM_MODELS_FP
    assert JPF.PlatformModels(jp, jd, "", "native").fingerprint() == ARM_MODELS_FP


def test_factor_correct_and_subset_columns_match_reference(arm_models, arm_pools, tmp_path):
    jp, _, tp, _ = arm_models
    prim = arm_pools[0]
    sample = JPF.SimulatedPlatform("arm", max_triplets=60, time_scale=1.7) \
        .measure_sample(16, seed=4)
    times = sample.times.copy()
    times[:, 5:9] = np.nan                               # unmeasured columns
    for fill in (False, True):
        want = JM.factor_correct(jp, sample.feats, times, fill_missing=fill)
        got = TM.factor_correct(tp, sample.feats, times, fill_missing=fill)
        assert got.kind == want.kind == "factor-nn2"
        assert got.log_factor.dtype == np.float64
        np.testing.assert_allclose(got.log_factor, want.log_factor, rtol=0, atol=2e-5)
        _hold_predictions(got.predict(prim.feats), want.predict(prim.feats))
        again = TM.factor_correct(got, sample.feats, times)   # composes, no nesting
        assert again.base is tp
    got.save(str(tmp_path / "f.npz"))
    back = TM.PerfModel.load(str(tmp_path / "f.npz"), device="cpu")
    assert back.kind == "factor-nn2" and np.array_equal(back.log_factor, got.log_factor)
    assert back.fingerprint() == got.fingerprint()
    assert JM.PerfModel.load(str(tmp_path / "f.npz")).fingerprint() == got.fingerprint()
    cols = _tile_names()[:40] + ["kn2row", "mec-col"]
    base_of = lambda c: TC.split_tile(c)[0]
    subsets = []
    for t_model, j_model in ((tp, jp), (got, want)):
        sub_t = t_model.subset_columns(cols, base_of=base_of)
        sub_j = j_model.subset_columns(cols, base_of=lambda c: JC.split_tile(c)[0])
        assert sub_t.n_outputs == len(cols) and list(sub_t.columns) == cols
        _hold_predictions(sub_t.predict(prim.feats), sub_j.predict(prim.feats))
        subsets.append((sub_t, sub_j))
    # the plain subset is the reference's byte for byte; the factor one
    # carries log factors fitted to each package's own predictions
    assert subsets[0][0].fingerprint() == subsets[0][1].fingerprint()
    with pytest.raises(ValueError):
        tp.subset_columns(["no-such-primitive"])


def test_training_and_unported_platforms_refuse(tmp_path):
    """Training refuses what it cannot do (an unknown model kind or
    calibration mode). The reference's host-CPU and tile platforms are
    ported: ``get_platform`` dispatches their names to the port's classes,
    with the reference's fingerprints, and the host platform refuses tile
    columns."""
    with pytest.raises(ValueError, match="unknown perf model kind"):
        TM.fit_perf_model("nn3", np.ones((4, 5)), np.ones((4, 2)),
                          np.ones((2, 5)), np.ones((2, 2)), device="cpu")
    for name, cls in (("host", TPF.HostPlatform), ("tpu", TPF.PallasPlatform),
                      ("pallas", TPF.PallasPlatform)):
        got, want = TPF.get_platform(name), JPF.get_platform(name)
        assert isinstance(got, cls) and got.name == want.name
        assert got.fingerprint() == want.fingerprint()
    with pytest.raises(ValueError, match="tile columns"):
        TPF.get_platform("host", primitives=["im2col-copy-ab-ki@mm-128x128x128"])
    arm = TPF.get_platform("arm", max_triplets=60)
    store = TA.ArtifactStore(_store_copy(tmp_path), device="cpu")
    models = arm.pretrain("nn2", store=store, max_iters=2000)
    assert models.warm
    with pytest.raises(ValueError, match="unknown calibration mode"):
        arm.calibrate(models, 0.05, mode="bogus", sample=arm.measure_sample(16))


# ---------------------------------------------------------------------------
# select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", sorted(TZ.ZOO))
@pytest.mark.parametrize("platform", ["intel", "amd", "arm", "tpu"])
def test_select_simulated_matches_reference(platform, net):
    """Ground-truth selection on each simulated platform: the simulators'
    ``SimulatedProvider``, the tile platform's ``PallasTileProvider``."""
    got = TS.select(TZ.get(net), TPF.get_platform(platform).cost_provider())
    want = JS.select(JZ.get(net), JPF.get_platform(platform).cost_provider())
    assert got.assignment == want.assignment
    assert got.solver_cost == want.solver_cost and got.optimal == want.optimal


@pytest.mark.parametrize("columns", ["all", "runnable"])
@pytest.mark.parametrize("net", sorted(TZ.ZOO))
def test_select_model_provider_matches_reference(net, columns, arm_models):
    jp, jd, tp, td = arm_models
    cols = None if columns == "all" else TPL._executable_columns(tp)
    got = TS.select(TZ.get(net), TS.ModelProvider(tp, td, columns=cols))
    want = JS.select(JZ.get(net), JS.ModelProvider(jp, jd, columns=cols))
    assert json.dumps(got.assignment) == json.dumps(want.assignment)
    assert got.optimal == want.optimal
    assert abs(got.solver_cost - want.solver_cost) <= COST_RTOL * want.solver_cost
    provider = TS.ModelProvider(tp, td, columns=cols)
    assert TS.network_cost(TZ.get(net), got.assignment, provider) == pytest.approx(
        got.solver_cost, rel=1e-12)


# ---------------------------------------------------------------------------
# optimise, reoptimise, the store across packages
# ---------------------------------------------------------------------------

def test_optimise_warm_from_committed_store(tmp_path):
    store = TA.ArtifactStore(_store_copy(tmp_path), device="cpu")
    opt = TPL.optimise("edge_cnn", "arm", store=store, **OPT_ARGS)
    assert opt.warm_models and opt.warm_selection and opt.warm
    assert opt.selection is None
    assert opt.models.fingerprint() == ARM_MODELS_FP
    assert opt.models.prim.device.type == "cpu"
    assert TPL._spec_fingerprint(opt.spec) == "2ac850cc5712b952"
    want = json.loads(EDGE_CNN_SELECTION.read_text())
    assert {str(k): v for k, v in opt.assignment.items()} == want["assignment"]
    assert opt.predicted_cost_s == want["predicted_cost_s"]
    assert opt.platform.fingerprint() == "sim/arm/noisy=1/mt=60"


def test_optimise_cold_selection_round_trips_to_reference(tmp_path):
    root = _store_copy(tmp_path, selections=False)
    opt = TPL.optimise("edge_cnn", "arm", store=TA.ArtifactStore(root, device="cpu"),
                       **OPT_ARGS)
    assert opt.warm_models and not opt.warm_selection and opt.selection is not None
    want = json.loads(EDGE_CNN_SELECTION.read_text())
    assert {str(k): v for k, v in opt.assignment.items()} == want["assignment"]
    ref = JPL.optimise("edge_cnn", "arm", store=JA.ArtifactStore(root), **OPT_ARGS)
    assert ref.warm_models and ref.warm_selection          # the port's selection
    assert ref.assignment == opt.assignment
    again = TPL.optimise("googlenet", "arm", store=TA.ArtifactStore(root, device="cpu"),
                         **OPT_ARGS)
    ref = JPL.optimise("googlenet", "arm", store=JA.ArtifactStore(root), **OPT_ARGS)
    assert ref.warm_selection and ref.assignment == again.assignment


def test_digest_and_store_round_trip_across_packages(tmp_path, arm_models):
    jp, _, tp, _ = arm_models
    for fields in ({"a": 1, "b": [1, 2]}, {"platform": "sim/arm", "x": None,
                                          "columns": ["p", "q"], "f": 0.5}):
        assert TA.digest(fields) == JA.digest(fields)
    tstore = TA.ArtifactStore(str(tmp_path), device="cpu")
    jstore = JA.ArtifactStore(str(tmp_path))
    tstore.put_model({"role": "port"}, tp)
    assert jstore.get_model({"role": "port"}).fingerprint() == jp.fingerprint()
    jstore.put_model({"role": "ref"}, jp)
    assert tstore.get_model({"role": "ref"}).fingerprint() == jp.fingerprint()
    tstore.put_json("selections", {"k": 1}, {"assignment": {"0": "chw"}})
    assert jstore.get_json("selections", {"k": 1}) == {"assignment": {"0": "chw"}}
    ds = JD.simulate_dlt_dataset("arm")
    jstore.put_dataset({"d": 1}, ds)
    assert tstore.get_dataset({"d": 1}).fingerprint() == ds.fingerprint()
    assert tstore.path("models", {"role": "port"}) == jstore.path("models", {"role": "port"})
    keep = TA.ArtifactStore(str(tmp_path), keep=1, device="cpu")
    keep.put_json("selections", {"k": 2}, {})
    assert len(keep.entries("selections")) == 1


def test_reoptimise_factor_matches_reference(tmp_path):
    tstore = TA.ArtifactStore(_store_copy(tmp_path / "t"), device="cpu")
    jstore = JA.ArtifactStore(_store_copy(tmp_path / "j"))
    topt = TPL.optimise("edge_cnn", "arm", store=tstore, **OPT_ARGS)
    jopt = JPL.optimise("edge_cnn", "arm", store=jstore, **OPT_ARGS)
    sample = topt.platform.measure_sample(16)
    ref_sample = jopt.platform.measure_sample(16)
    assert sample.fingerprint() == ref_sample.fingerprint()
    got = [TPL.reoptimise(topt, sample=sample, mode="factor") for _ in range(2)]
    want = JPL.reoptimise(jopt, sample=ref_sample, mode="factor")
    assert got[0].models.fingerprint() == got[1].models.fingerprint()
    assert got[0].assignment == got[1].assignment == want.assignment
    assert got[0].models.mode == "factor" and got[0].columns == topt.columns
    np.testing.assert_allclose(got[0].models.prim.log_factor,
                               want.models.prim.log_factor, rtol=0, atol=2e-5)
    assert abs(got[0].predicted_cost_s - want.predicted_cost_s) \
        <= COST_RTOL * want.predicted_cost_s
    # through the store, and from served traffic pooled with a peer's
    stored = TPL.reoptimise(topt, sample=sample, mode="factor", store=tstore)
    assert stored.assignment == want.assignment and not stored.warm_models
    plat = topt.platform
    feats = np.array([n.config for n in topt.spec.nodes if isinstance(n, TZ.ConvLayer)],
                     np.float64)
    assigned = [topt.assignment[i] for i, n in enumerate(topt.spec.nodes)
                if isinstance(n, TZ.ConvLayer)]
    served = TD.observations_to_dataset(
        feats, assigned, [(8, plat.profile(feats)[np.arange(len(assigned)),
                                               [plat.columns.index(a) for a in assigned]])],
        columns=plat.columns, platform="arm")
    peer = TD.observations_to_dataset(feats[:3], assigned[:3], [(2, np.full(3, 1e-4))],
                                      columns=plat.columns, platform="arm")
    models = plat.calibrate(topt.models, served=served, pooled=[peer], sample_n=20)
    jplat = jopt.platform
    jserved, jpeer = (JD.PerfDataset(d.feats, d.times, d.columns, d.feature_names,
                                     d.platform) for d in (served, peer))
    jmodels = jplat.calibrate(jopt.models, served=jserved, pooled=[jpeer], sample_n=20)
    assert models.mode == jmodels.mode == "factor"
    assert models.sample_info == jmodels.sample_info
    np.testing.assert_allclose(models.prim.log_factor, jmodels.prim.log_factor,
                               rtol=0, atol=2e-5)


def test_selected_plan_served_matches_reference(tmp_path, rng):
    store = TA.ArtifactStore(_store_copy(tmp_path), device="cpu")
    opt = TPL.optimise("edge_cnn", "arm", store=store, **OPT_ARGS)
    jw = JE.make_weights(JZ.get("edge_cnn"), seed=5)
    server = OptimisedServer(max_batch=8, latency_budget_ms=float("inf"), device="cpu")
    server.register(opt, weights={k: np.asarray(v) for k, v in jw.items()})
    xs = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    jplan = JP.compile_plan(JZ.get("edge_cnn"), opt.assignment)
    want = np.asarray(jplan(jnp.asarray(xs), jw)[jplan.sinks[-1]])
    got = server.serve("edge_cnn", list(xs[:1])) + server.serve("edge_cnn", list(xs[1:]))
    np.testing.assert_allclose(np.stack(got), want, **SERVE_TOL)
    assert all(TC.split_tile(c)[1] is None for c in opt.assignment.values())
