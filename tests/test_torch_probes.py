"""Probe dispatches of the port against the reference on the CPU — the six
tests of ``tests/test_serving_probes.py``, each run in both packages:

  * rate limiting under load — at most one probe per ``1/probe_rate``
    seconds per state, round-robin over the attribution profile;
  * isolation — probes never enter the drift buffer, the served-latency
    wait samples, or the bucket-scale head;
  * attribution — probe measurements surface in the served sample as their
    own single-column rows at the probed (config, column), in the model's
    prediction scale;
  * failures counted and filed in the ledger, an unsupported column
    skipped, validation, and the dataset layer's probe rows.

Both servers execute real plans paced on a fake clock, and a probe measures
exactly 4x the model's prediction for its target (the reference's test rig;
the port's own probe, through ``profiler/device.py``, is held in
``test_torch_serving.py``). Both packages serve the committed arm models'
edge_cnn selection (a copy of ``artifacts/``; the reference's test trains a
16-triplet model cold, and the two packages' cold inits differ), so the
probe ledger — counts, failures, the targets in order, the buffer and wait
sample sizes, the served sample's rows — is held equal, and the probe
values to the models' float rounding (rtol 2e-5).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import shutil
from pathlib import Path

import numpy as np
import pytest

from repro.profiler.dataset import observations_to_dataset as j_obs_to_ds
from repro.service import ArtifactStore as JStore
from repro.service import OptimisedServer as JServer
from repro.service import layer_profile as j_layer_profile
from repro.service import optimise as j_optimise
from repro.service.serving.server import ProbeUnsupported as JUnsupported
from repro_torch.profiler.dataset import observations_to_dataset as t_obs_to_ds
from repro_torch.service import ArtifactStore as TStore
from repro_torch.service import OptimisedServer as TServer
from repro_torch.service import layer_profile as t_layer_profile
from repro_torch.service import optimise as t_optimise
from repro_torch.service.serving.server import ProbeUnsupported as TUnsupported

ROOT = Path(__file__).resolve().parents[1]
PRED_TOL = dict(rtol=2e-5, atol=0.0)
WARM = dict(max_triplets=60, max_iters=2000, executable=True)
PKGS = {"j": (JServer, j_layer_profile, JUnsupported, {}),
        "t": (TServer, t_layer_profile, TUnsupported, {"device": "cpu"})}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def _store_copy(root: Path) -> str:
    for part in ("models", "selections"):
        shutil.copytree(ROOT / "artifacts" / part, root / part)
    return str(root)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe_store")
    jopt = j_optimise("edge_cnn", "arm", store=JStore(_store_copy(root / "j")),
                      **WARM)
    topt = t_optimise("edge_cnn", "arm", store=TStore(
        _store_copy(root / "t"), device="cpu"), device="cpu", **WARM)
    assert jopt.warm and topt.warm and jopt.assignment == topt.assignment
    return {"j": jopt, "t": topt}


def _requests(spec, n, seed=0):
    n0 = spec.nodes[0]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n0.c, n0.im, n0.im)).astype(np.float32)


def _mk(pkg, opt, clock, probe_factor=4.0, **kw):
    """A server of package ``pkg``: real plan execution paced on the fake
    clock; probes measure exactly ``probe_factor`` x the model's prediction
    for the probed target."""
    server_cls, _, _, dev = PKGS[pkg]

    class ProbingServer(server_cls):
        probe_calls = []

        def _run_plan(self, opt_, xs, weights):
            out = super()._run_plan(opt_, xs, weights)
            clock.advance(opt.predicted_cost_s * xs.shape[0])
            return out

        def _run_probe(self, opt_, config, column):
            layers = self._drift.layer_profile(opt_.net)
            key = tuple(float(v) for v in np.asarray(config).reshape(-1))
            for f, c, p in zip(layers.feats, layers.columns, layers.predicted):
                if tuple(float(v) for v in f) == key and c == column:
                    self.probe_calls.append((key, column))
                    return probe_factor * float(p)
            raise AssertionError(f"probe target {(key, column)} not in profile")

    server = ProbingServer(clock=clock, max_batch=4, latency_budget_ms=1e9,
                           drift_threshold=50.0, drift_calib_obs=1, **dev,
                           **kw)
    server.probe_calls = []
    server.register(opt)
    return server


def _both(fn, nets):
    """Run scenario ``fn(pkg, opt)`` in both packages; equal decisions."""
    got = {pkg: fn(pkg, nets[pkg]) for pkg in ("j", "t")}
    assert got["t"] == got["j"]
    return got["t"]


def test_probe_rate_limit_and_round_robin(nets):
    def scenario(pkg, opt):
        clock = FakeClock()
        server = _mk(pkg, opt, clock, probe_rate=1.0)
        xs = _requests(opt.spec, 4)
        counts = []
        try:
            server.serve(opt.net, xs)           # bucket-4 first run: no probe
            counts.append(server.stats(opt.net)["probes"])
            for _ in range(8):                  # one probe, interval unelapsed
                server.serve(opt.net, xs)
            counts.append(server.stats(opt.net)["probes"])
            clock.advance(1.0)
            server.serve(opt.net, xs)
            counts.append(server.stats(opt.net)["probes"])
            assert server.stats(opt.net)["probe_failures"] == 0
            prof = PKGS[pkg][1](opt)
            want = [(tuple(float(v) for v in prof.feats[i]), prof.columns[i])
                    for i in (0, 1)]
            assert server.probe_calls == want   # round-robin, in order
            return counts, server.probe_calls
        finally:
            server.stop()
    counts, _ = _both(scenario, nets)
    assert counts == [0, 1, 2]


def test_probes_excluded_from_buffer_waits_and_bucket_head(nets):
    values = {}

    def scenario(pkg, opt):
        clock = FakeClock()
        server = _mk(pkg, opt, clock, probe_rate=1e9)   # probe every batch
        xs = _requests(opt.spec, 4)
        rounds = 6
        try:
            for _ in range(rounds):
                server.serve(opt.net, xs)
            s = server.stats(opt.net)
            assert s["probes"] == rounds - 1    # every clean dispatch probed
            assert s["observed_dispatches"] == rounds - 1
            with server._cond:
                waits = len(server._drift._stats[opt.net].waits)
            assert waits == rounds              # probes leave no wait sample
            scales = s["bucket_scales"]
            assert scales is None or set(scales) <= {4}
            ds = server.served_sample(opt.net)
            assert ds is not None
            assert ds.served_info["probes"] == s["probes"]
            prof = PKGS[pkg][1](opt)
            probed = {k for k, _ in server.probe_calls}
            n_bucket_rows = ds.n - len(probed)
            rows = {}
            for key, col in sorted(set(server.probe_calls)):
                hits = [i for i in range(n_bucket_rows, ds.n)
                        if tuple(float(v) for v in ds.feats[i]) == key
                        and np.isfinite(ds.times[i, ds.columns.index(col)])]
                assert len(hits) == 1
                i, j = hits[0], ds.columns.index(col)
                pred = next(float(p) for f, c, p in
                            zip(prof.feats, prof.columns, prof.predicted)
                            if tuple(float(v) for v in f) == key and c == col)
                assert ds.times[i, j] == pytest.approx(4.0 * pred, rel=1e-6)
                assert np.isfinite(ds.times[i]).sum() == 1
                rows[(key, col)] = i
            values[pkg] = ds.times[list(rows.values()),
                                   [ds.columns.index(c) for _, c in rows]]
            return (s["probes"], s["observed_dispatches"], waits, ds.n,
                    ds.columns, server.probe_calls, rows)
        finally:
            server.stop()
    _both(scenario, nets)
    np.testing.assert_allclose(values["t"], values["j"], **PRED_TOL)


def test_probe_failure_counts_and_ledger(nets):
    def scenario(pkg, opt):
        clock = FakeClock()
        server = _mk(pkg, opt, clock, probe_rate=1e9)
        server._run_probe = lambda opt_, cfg, col: (_ for _ in ()).throw(
            RuntimeError("probe rig broke"))
        xs = _requests(opt.spec, 4)
        try:
            for _ in range(3):
                server.serve(opt.net, xs)
            s = server.stats(opt.net)
            assert s["probes"] == 0 and s["probe_failures"] == 2
            ledger = server._drift.failure_ledger(opt.net)
            assert ledger[0]["probe"] == 2
            ds = server.served_sample(opt.net)
            assert ds is not None and ds.served_info.get("probes", 0) == 0
            return s["probes"], s["probe_failures"], ledger, ds.n
        finally:
            server.stop()
    _both(scenario, nets)


def test_unsupported_probe_is_skip_not_failure(nets):
    def scenario(pkg, opt):
        clock = FakeClock()
        server = _mk(pkg, opt, clock, probe_rate=1e9)
        unsupported = PKGS[pkg][2]
        server._run_probe = lambda opt_, cfg, col: (_ for _ in ()).throw(
            unsupported(col))
        try:
            for _ in range(3):
                server.serve(opt.net, _requests(opt.spec, 4))
            s = server.stats(opt.net)
            assert s["probes"] == 0 and s["probe_failures"] == 0
            ledger = server._drift.failure_ledger(opt.net)
            assert "probe" not in ledger.get(0, {})
            return s["probes"], s["probe_failures"], ledger
        finally:
            server.stop()
    _both(scenario, nets)


def test_probe_rate_validation_and_default_off(nets):
    for pkg in ("j", "t"):
        with pytest.raises(ValueError):
            PKGS[pkg][0](probe_rate=-1.0, **PKGS[pkg][3])

    def scenario(pkg, opt):
        clock = FakeClock()
        server = _mk(pkg, opt, clock)                  # default: disabled
        try:
            for _ in range(4):
                server.serve(opt.net, _requests(opt.spec, 4))
            assert server.stats(opt.net)["probes"] == 0
            assert server.probe_calls == []
            return server.stats(opt.net)["observed_dispatches"]
        finally:
            server.stop()
    _both(scenario, nets)


def test_observations_to_dataset_probe_rows_pure():
    """The dataset layer's contract in both packages: probe triples become
    their own rows, sorted by (config, column), finite only at the probed
    column; an unknown column raises."""
    feats = np.array([[16, 3, 32, 1, 3]], np.float64)
    probes = [(np.array([32, 16, 30, 1, 3], np.float64), "kn2row", 2e-3),
              (np.array([16, 3, 32, 1, 3], np.float64), "mec-col", 1e-3)]
    out = []
    for fn in (j_obs_to_ds, t_obs_to_ds):
        ds = fn(feats, ("kn2row",), [(1, np.array([1e-3]))],
                columns=["kn2row", "mec-col"], platform="arm", probes=probes)
        assert ds.n == 3                       # 1 bucket row + 2 probe rows
        assert ds.served_info["probes"] == 2
        np.testing.assert_array_equal(ds.feats[1], [16, 3, 32, 1, 3])
        np.testing.assert_array_equal(ds.feats[2], [32, 16, 30, 1, 3])
        j_mec, j_kn = ds.columns.index("mec-col"), ds.columns.index("kn2row")
        assert ds.times[1, j_mec] == pytest.approx(1e-3)
        assert ds.times[2, j_kn] == pytest.approx(2e-3)
        assert np.isfinite(ds.times[1:]).sum() == 2
        with pytest.raises(ValueError):
            fn(feats, ("kn2row",), [(1, np.array([1e-3]))], columns=["kn2row"],
               platform="arm",
               probes=[(np.array([1, 1, 1, 1, 1], np.float64), "nope", 1e-3)])
        out.append(ds)
    np.testing.assert_array_equal(out[0].feats, out[1].feats)
    np.testing.assert_array_equal(out[0].times, out[1].times)
    assert out[0].columns == out[1].columns
    assert out[0].served_info == out[1].served_info
