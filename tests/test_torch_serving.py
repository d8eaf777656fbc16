"""The port's concurrent serving core against the reference on the CPU.

* ``DriftMonitor`` and ``NetQueue`` fed one seeded event sequence in both
  packages: bit-equal triggers, stats, window scales, observations,
  attributions and bucket heads.
* Served-sample telemetry: the committed arm models warm-loaded into both
  packages, both servers driven by one script under a ``FakeClock`` — equal
  attribution profiles and served samples (the models' predictions differ
  by float rounding only, rtol 2e-5), results within 1e-4.
* The reference's drift → recalibrate → hot-swap test, made deterministic:
  plan executions advance the injected clock in proportion to the
  platform's ``time_scale``, so exactly one excursion fires.
* A two-worker burst from four client threads over three networks, the
  predicted-cost router and ``unregister_backend``, the CLI, and probes
  (measured through ``profiler/device.py``, a deliberate divergence from
  the reference's probe).
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import dataclasses
import shutil
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import cnn_zoo as JZ
from repro.primitives import executor as JE
from repro.primitives import plan as JP
from repro.service import ArtifactStore as JStore
from repro.service import OptimisedServer as JServer
from repro.service import optimise as j_optimise
from repro.service.serving import drift as JD
from repro.service.serving import queues as JQ
from repro.service.serving.server import layer_profile as j_layer_profile
from repro_torch.models import cnn_zoo as TZ
from repro_torch.primitives.plan import heuristic_assignment as t_heuristic
from repro_torch.profiler import device as device_profiler
from repro_torch.service import ArtifactStore as TStore
from repro_torch.service import OptimisedNetwork as TNet
from repro_torch.service import OptimisedServer as TServer
from repro_torch.service import make_recalibrator
from repro_torch.service import optimise as t_optimise
from repro_torch.service import safe_assignment as t_safe
from repro_torch.service.platforms import SimulatedPlatform
from repro_torch.service.serving import drift as TD
from repro_torch.service.serving import queues as TQ
from repro_torch.service.serving.server import layer_profile as t_layer_profile
from repro_torch.service.serving.server import main as t_main
from test_torch_plan import kernel_mix_assignment

ROOT = Path(__file__).resolve().parents[1]
RESULT_TOL = dict(rtol=1e-4, atol=1e-4)
PRED_TOL = dict(rtol=2e-5, atol=0.0)       # perf-model predictions, both packages
WARM = dict(max_triplets=60, max_iters=2000, executable=True)


class FakeClock:
    """Deterministic injectable clock: time moves only when a test says so."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3, 32, 32)).astype(np.float32)


def _store_copy(root: Path) -> str:
    for part in ("models", "selections"):
        shutil.copytree(ROOT / "artifacts" / part, root / part)
    return str(root)


def _jax_plan(assignment, weights, xs):
    spec = JZ.get("edge_cnn")
    plan = JP.compile_plan(spec, assignment)
    return np.asarray(plan(jnp.asarray(xs), weights)[plan.sinks[-1]])


# ---------------------------------------------------------------------------
# Pure modules: bit-equal against the reference
# ---------------------------------------------------------------------------

def _layers(mod, rng):
    feats = rng.integers(1, 64, (6, 5)).astype(np.float64)
    return mod.LayerProfile(feats=feats,
                            columns=tuple(f"col{i % 3}" for i in range(6)),
                            predicted=rng.uniform(1e-4, 1e-3, 6))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_monitor_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ticks = iter(np.arange(1e4) * 0.25)
    times = []

    def clock():
        if not times:
            times.append(next(ticks))
        return times[-1]

    kw = dict(threshold=1.4, alpha=0.3, calib_obs=3, obs_cap=24)
    ref, port = JD.DriftMonitor(**kw, clock=clock), TD.DriftMonitor(**kw, clock=clock)
    layer_seed = int(rng.integers(0, 2**31))
    gens = {"a": 0, "b": 0}
    for net in gens:
        ref.reset(net, 0, layers=_layers(JD, np.random.default_rng(layer_seed)))
        port.reset(net, 0, layers=_layers(TD, np.random.default_rng(layer_seed)))
    scale = 1.0
    for step in range(300):
        times.clear()
        net = "ab"[rng.integers(0, 2)]
        op = rng.integers(0, 10)
        gen = gens[net] - int(rng.random() < 0.05)      # a few stale events
        if op < 5:
            if rng.random() < 0.08:
                scale *= float(rng.choice([0.25, 3.0, 5.0]))
            obs = float(2e-3 * scale * rng.lognormal(0, 0.1))
            batch = int(2 ** rng.integers(0, 4)) if rng.random() < 0.9 else None
            got = [m.observe(net, gen, obs, 1e-3, batch=batch)
                   for m in (ref, port)]
        elif op < 8:
            wait = float(rng.exponential(0.02))
            got = [m.observe_wait(net, gen, wait, 0.03) for m in (ref, port)]
        elif op == 8:
            kind = ["error", "fault", "corrupt", "deadline"][rng.integers(0, 4)]
            got = [m.record_failure(net, gen, kind) for m in (ref, port)]
        else:
            cfg = rng.integers(1, 64, 5)
            col = f"col{rng.integers(0, 3)}"
            obs = float(rng.uniform(1e-4, 1e-3))
            got = [m.record_probe(net, gen, cfg, col, obs, 5e-4)
                   for m in (ref, port)]
        assert got[0] == got[1], (step, op)
        if rng.random() < 0.02:                          # a hot swap
            gens[net] += 1
            ref.reset(net, gens[net], layers=_layers(JD, np.random.default_rng(step)))
            port.reset(net, gens[net], layers=_layers(TD, np.random.default_rng(step)))
    triggers = 0
    for net in gens:
        a, b = ref.stats(net), port.stats(net)
        for fld in ("generation", "n", "ref_log", "ewma_log", "in_excursion",
                    "triggers", "window_scale", "waits_since_adjust"):
            assert getattr(a, fld) == getattr(b, fld), fld
        assert list(a.waits) == list(b.waits) and a.probes == b.probes
        triggers += b.triggers
        assert ref.ratio(net) == port.ratio(net)
        assert ref.window_scale(net) == port.window_scale(net)
        assert ([dataclasses.astuple(o) for o in ref.observations(net)]
                == [dataclasses.astuple(o) for o in port.observations(net)])
        assert ref.coverage(net) == port.coverage(net)
        ja, ta = ref.attributed(net, min_obs=2), port.attributed(net, min_obs=2)
        assert (ja is None) == (ta is None)
        if ja is not None:
            np.testing.assert_array_equal(ja[0], ta[0])
            assert ja[1] == ta[1] and ja[3] == ta[3]
            assert [b for b, _ in ja[2]] == [b for b, _ in ta[2]]
            for (_, x), (_, y) in zip(ja[2], ta[2]):
                np.testing.assert_array_equal(x, y)
        jh, th = ref.bucket_head(net), port.bucket_head(net)
        assert (jh is None) == (th is None)
        if jh is not None:
            np.testing.assert_array_equal(jh.log2_buckets, th.log2_buckets)
            np.testing.assert_array_equal(jh.log_scale, th.log_scale)
            assert [jh.scale(b) for b in (1, 3, 8, 64)] == \
                [th.scale(b) for b in (1, 3, 8, 64)]
        jp, tp = ref.probe_attributed(net), port.probe_attributed(net)
        assert (jp is None) == (tp is None)
        if jp is not None:
            assert jp[1] == tp[1]
            for (c1, k1, v1), (c2, k2, v2) in zip(jp[0], tp[0]):
                np.testing.assert_array_equal(c1, c2)
                assert (k1, v1) == (k2, v2)
        assert ref.failures(net) == port.failures(net)
        assert ref.failure_ledger(net) == port.failure_ledger(net)
    assert triggers >= 1
    with pytest.raises(ValueError):
        TD.DriftMonitor(threshold=1.0)


def test_netqueue_matches_reference():
    """Both queues fed one seeded sequence of loose pushes and takes, slab
    groups pushed and taken whole, clock moves, window changes and drains:
    every answer equal."""
    clock = FakeClock(100.0)
    mods = (JQ, TQ)
    queues = [mod.NetQueue(depth=9, batch_cap=4, max_wait_s=0.01,
                           budget_s=0.02, predicted_s=2e-3) for mod in mods]
    rng = np.random.default_rng(0)

    def group(mod, rows):
        ts = [mod.Ticket(net="n", x=np.zeros(1), row=i, submitted_s=clock())
              for i in range(rows)]
        return mod.BatchGroup(tickets=ts, xs=np.zeros((rows, 1)))

    def shape(tickets, groups):
        return ([t.row for t in tickets],
                [[t.row for t in g.tickets] for g in groups])
    for step in range(300):
        op = rng.integers(0, 9)
        if op < 2:
            got = [q.push(mod.Ticket(net="n", x=np.zeros(1),
                                     submitted_s=clock()))
                   for q, mod in zip(queues, mods)]
        elif op == 2:
            n = int(rng.integers(1, 5))
            got = [len(q.take(n)) for q in queues]
        elif op == 3:
            clock.advance(float(rng.exponential(0.004)))
            drain = bool(rng.random() < 0.1)
            got = [q.ready(clock(), drain=drain) for q in queues]
        elif op == 4:
            s = float(rng.choice([1.0, 0.5, 0.25]))
            head = None if rng.random() < 0.5 else (lambda b: 1.0 + 0.1 * b)
            for q in queues:
                q.window_scale, q.bucket_scale = s, head
            got = [q.effective_wait_s() for q in queues]
        elif op == 5:
            rows = int(rng.integers(1, 5))
            got = [q.push_group(group(mod, rows))
                   for q, mod in zip(queues, mods)]
        elif op == 6:
            got = [(q.group_ready(), len(q.take_group().tickets)
                    if q.group_ready() else None) for q in queues]
        elif op == 7 and rng.random() < 0.2:
            got = [shape(*q.drain()) for q in queues]
        else:
            got = [(q.next_deadline(), q.backlog_images(1), len(q),
                    q.ready(clock()), q.group_ready()) for q in queues]
        assert got[0] == got[1], step
    assert shape(*queues[0].drain()) == shape(*queues[1].drain())
    assert not len(queues[0]) and not len(queues[1])
    t = TQ.Ticket(net="n", x=np.zeros(1))
    assert t.slab is None and t.row == -1
    assert t.finish(result=np.ones(1), degraded=True) and t.degraded
    assert not t.finish(error="late") and t.error is None


# ---------------------------------------------------------------------------
# Served-sample telemetry with the committed models, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def warm_nets(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving_store")
    jopt = j_optimise("edge_cnn", "arm",
                      store=JStore(_store_copy(root / "j")), **WARM)
    topt = t_optimise("edge_cnn", "arm", store=TStore(
        _store_copy(root / "t"), device="cpu"), device="cpu", **WARM)
    assert jopt.warm and topt.warm and jopt.assignment == topt.assignment
    return jopt, topt


def _timed(server_cls, per_image_s=1e-3):
    class Timed(server_cls):
        def _run_plan(self, opt, xs, weights):
            out = super()._run_plan(opt, xs, weights)
            self._clock.advance(per_image_s * xs.shape[0])
            return out
    return Timed


def test_served_sample_matches_reference(warm_nets):
    jopt, topt = warm_nets
    jl, tl = j_layer_profile(jopt), t_layer_profile(topt)
    np.testing.assert_array_equal(jl.feats, tl.feats)
    assert jl.columns == tl.columns
    np.testing.assert_allclose(tl.predicted, jl.predicted, **PRED_TOL)
    weights = JE.make_weights(JZ.get("edge_cnn"))
    xs = _requests(20, seed=4)
    samples, results = [], []
    for server_cls, opt, kw in ((JServer, jopt, {}),
                                (TServer, topt, {"device": "cpu"})):
        server = _timed(server_cls)(max_batch=4, latency_budget_ms=1e9,
                                    drift_calib_obs=2, clock=FakeClock(),
                                    **kw)
        server.register(opt, weights={k: np.asarray(v)
                                      for k, v in weights.items()})
        out = []
        for lo, hi in ((0, 4), (4, 8), (8, 11), (11, 15), (15, 20)):
            out += server.serve(opt.net, xs[lo:hi])
        samples.append(server.served_sample(opt.net))
        results.append(np.stack([np.asarray(o) for o in out]))
        assert server.stats(opt.net)["observed_dispatches"] >= 3
    np.testing.assert_allclose(results[1], results[0], **RESULT_TOL)
    np.testing.assert_allclose(results[0], _jax_plan(jopt.assignment,
                                                     weights, xs),
                               **RESULT_TOL)
    ref, port = samples
    assert ref.columns == port.columns and ref.platform == port.platform
    np.testing.assert_array_equal(ref.feats, port.feats)
    np.testing.assert_allclose(port.times, ref.times, **PRED_TOL)
    assert ref.served_info == port.served_info


# ---------------------------------------------------------------------------
# Drifted platform end to end: detect -> calibrate -> re-select -> hot_swap
# ---------------------------------------------------------------------------

class _DriftingServer(TServer):
    """Emulates the serving machine slowing down by the platform's
    ``time_scale``: each plan execution advances the injected clock by a
    fixed per-image cost times the excess scale, so the observed per-image
    latency rises exactly as it would on a slower machine — and nothing
    else moves it."""

    def _run_plan(self, opt, xs, weights):
        out = super()._run_plan(opt, xs, weights)
        scale = getattr(opt.platform, "time_scale", 1.0)
        self._clock.advance(0.004 * xs.shape[0] * scale)
        return out


def _wait_idle(server, timeout=120.0):
    """Join the background recalibration (bounded: a hang fails, it
    decides nothing)."""
    with server._cond:
        threads = list(server._recal_threads)
    for t in threads:
        t.join(timeout)
    assert server.recalibrations_idle(), "recalibration did not finish"


def test_drifted_platform_recalibrates_and_hot_swaps(tmp_path):
    # the committed arm models, warm from a store copy: nothing trains, so
    # the test costs the same on a loaded host as on an idle one
    platform = SimulatedPlatform("arm", max_triplets=60)
    opt = t_optimise("edge_cnn", platform, store=TStore(
        _store_copy(tmp_path), device="cpu"), max_iters=2000,
        executable=True, device="cpu")
    assert opt.warm and opt.predicted_cost_s > 0
    pred0 = opt.predicted_cost_s
    server = _DriftingServer(
        max_batch=4, latency_budget_ms=1e9, max_wait_ms=3.0,
        drift_threshold=1.5, drift_alpha=0.5, drift_calib_obs=2,
        recalibrate=make_recalibrator(sample_n=12, mode="factor",
                                      device="cpu"),
        clock=FakeClock(), device="cpu")
    server.register(opt)
    spec = opt.spec
    tickets = []
    try:
        # establish the reference ratio on the healthy platform
        for i in range(4):
            server.serve(opt.net, _requests(4, seed=i))
        st = server.stats(opt.net)
        assert st["recalibrations"] == 0 and st["observed_dispatches"] == 3

        # the platform drifts: profiling AND execution get 4x slower; the
        # first clean dispatch on it is the excursion
        platform.time_scale = 4.0
        platform.invalidate_datasets()
        tickets += [server.submit(opt.net, x) for x in _requests(4, seed=10)]
        assert server.pump() == 1
        # requests that arrive while the recalibration runs queue up
        tickets += [server.submit(opt.net, x) for x in _requests(4, seed=11)]
        _wait_idle(server)
        st = server.stats(opt.net)
        assert st["recalibrations"] == 1 and st["generation"] == 1, st
        assert st["recal_sample"]["served_rows"] > 0

        # the swap happened mid-stream: nothing dropped, nothing corrupted
        server.pump()
        for seed in range(12, 18):
            tickets += [server.submit(opt.net, x)
                        for x in _requests(4, seed=seed)]
            server.pump()
        assert all(t.done and t.error is None and t.result is not None
                   for t in tickets)
        assert all(t.result.shape == tickets[0].result.shape for t in tickets)

        # recalibration went through platform.calibrate on the served
        # observations: a factor-corrected model, a higher prediction
        with server._cond:
            new_opt = server._nets[opt.net].opt
        assert new_opt.models.prim.kind.startswith("factor-")
        assert 1.5 < new_opt.predicted_cost_s / pred0 < 12.0
        assert new_opt.assignment
    finally:
        server.stop()
    # exactly one excursion -> exactly one recalibration
    assert server.recalibrations_idle()
    st = server.stats(opt.net)
    assert st["recalibrations"] == 1 and st["generation"] == 1


# ---------------------------------------------------------------------------
# Worker pool, router, CLI, probes
# ---------------------------------------------------------------------------

def test_two_workers_serve_three_networks_from_four_clients():
    spec = TZ.get("edge_cnn")
    weights = JE.make_weights(JZ.get("edge_cnn"), seed=1)
    asgs = {"heuristic": t_heuristic(spec), "safe": t_safe(spec),
            "mix": kernel_mix_assignment(spec)}
    server = TServer(max_batch=4, workers=2, max_wait_ms=0.0, device="cpu")
    # the first two plan executions meet at a barrier: both workers are
    # inside a dispatch at once, or the test fails at the barrier timeout
    barrier = threading.Barrier(2, timeout=60.0)
    runners, calls = set(), [0]
    real = server._run_plan

    def meeting(opt, xs, w):
        with server._cond:
            calls[0] += 1
            first = calls[0] <= 2
            runners.add(threading.current_thread().name)
        if first:
            barrier.wait()
        return real(opt, xs, w)
    server._run_plan = meeting
    for name, asg in asgs.items():
        server.register(TNet.from_assignment(spec, asg, net=name),
                        weights={k: np.asarray(v) for k, v in weights.items()})
    xs = _requests(64, seed=9)
    out = {}

    def client(c):
        for i in range(c, 64, 4):
            name = list(asgs)[i % 3]
            out[i] = (name, server.submit(name, xs[i]))
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert all(t.wait(60.0) for _, t in out.values())
        assert server._pool.streams == [None, None]     # the CPU has none
    finally:
        server.stop(timeout=60.0)
    assert len(out) == 64 and len(runners) >= 2
    for name, asg in asgs.items():
        idx = sorted(i for i, (n, _) in out.items() if n == name)
        want = _jax_plan(asg, weights, xs[idx])
        got = np.stack([out[i][1].result for i in idx])
        np.testing.assert_allclose(got, want, **RESULT_TOL)
        st = server.stats(name)
        assert st["failed_dispatches"] == 0 and st["fallback_images"] == 0
        assert st["images"] == len(idx) and st["inflight"] == 0


def test_router_prefers_the_cheaper_backend_and_survives_unregister():
    spec = TZ.get("edge_cnn")
    weights = {k: np.asarray(v) for k, v in JE.make_weights(JZ.get("edge_cnn")).items()}
    clock = FakeClock()
    server = TServer(max_batch=4, latency_budget_ms=1e9, clock=clock,
                     device="cpu")
    for backend, pred, asg in (("arm", 4e-3, t_heuristic(spec)),
                               ("gpu", 1e-3, t_safe(spec))):
        server.register(TNet.from_assignment(spec, asg, net="edge_cnn",
                                             predicted_cost_s=pred),
                        backend=backend, weights=weights)
    assert server.backends("edge_cnn") == ["arm", "gpu"]
    assert server.predict_per_image("edge_cnn#gpu") == pytest.approx(1e-3)
    xs = _requests(12, seed=6)
    ts = [server.submit("edge_cnn", x) for x in xs[:8]]
    # gpu at 1 ms/img takes requests until its backlog costs as much as one
    # arm image (4 ms): the fourth request spills
    assert [t.net for t in ts[:5]] == ["edge_cnn#gpu"] * 3 + [
        "edge_cnn#arm", "edge_cnn#gpu"]
    server.pump()
    st = server.stats("edge_cnn")
    assert st["backends"]["gpu"]["images"] + st["backends"]["arm"]["images"] == 8
    want = _jax_plan(JP.heuristic_assignment(JZ.get("edge_cnn")),
                     {k: jnp.asarray(v) for k, v in weights.items()}, xs)
    np.testing.assert_allclose(np.stack([t.result for t in ts]), want[:8],
                               **RESULT_TOL)
    assert server.unregister_backend("edge_cnn", "gpu")
    assert not server.unregister_backend("edge_cnn", "gpu")
    rest = [server.submit("edge_cnn", x) for x in xs[8:]]
    server.pump()
    assert {t.net for t in rest} == {"edge_cnn#arm"}
    np.testing.assert_allclose(np.stack([t.result for t in rest]), want[8:],
                               **RESULT_TOL)
    assert server.backends("edge_cnn") == ["arm"]


def test_cli_serves_on_the_cpu_from_a_store_copy(tmp_path, capsys):
    store = _store_copy(tmp_path)
    assert t_main(["--net", "edge_cnn", "--platform", "arm", "--workers", "2",
                   "--requests", "16", "--device", "cpu",
                   "--store", store]) == 0
    out = capsys.readouterr().out
    assert "warm" in out and "16 requests" in out and "device cpu" in out


def _host_priced_by_arm(monkeypatch):
    """``HostPlatform``'s measurements priced by the arm simulator instead
    (the CLI's default host pool, 198 configs x 21 primitives x 11 calls,
    takes minutes on this CPU); the platform, its store address and the
    CLI path are the real ones."""
    from repro_torch.profiler import host, simulators
    from repro_torch.profiler.dataset import PerfDataset
    arm = simulators.PLATFORMS["arm"]

    def prim(configs, primitives=None, repeats=9):
        cols, cfg = host.base_columns(primitives), np.asarray(configs, np.int64)
        times = simulators.primitive_time_batch(arm, cfg, columns=tuple(cols))
        return PerfDataset(cfg.astype(np.float64), times, cols,
                           ["k", "c", "im", "s", "f"], host.LABEL)

    def dlt(pairs, repeats=9):
        pr = np.asarray(pairs, np.int64)
        return PerfDataset(pr.astype(np.float64), simulators.dlt_time_batch(arm, pr),
                           device_profiler.dlt_columns(), ["c", "im"], host.LABEL)
    monkeypatch.setattr(host, "profile_primitive_dataset", prim)
    monkeypatch.setattr(host, "profile_dlt_dataset", dlt)


@pytest.mark.parametrize("argv", [["--platform", "tpu"],
                                  ["--backends", "arm,tpu,host"]])
def test_cli_refuses_what_is_not_ported(argv, tmp_path, capsys, monkeypatch):
    """Every platform name now serves (the CLI once refused ``tpu``): the
    simulated tile platform alone, and edge_cnn routed over arm, tpu and
    host backends, each plan served on the CPU from a store copy."""
    _host_priced_by_arm(monkeypatch)
    store = _store_copy(tmp_path / "store")
    assert t_main(["--net", "edge_cnn", "--requests", "16", "--max-iters",
                   "100", "--device", "cpu", "--store", store, *argv]) == 0
    out = capsys.readouterr().out
    assert "for pallas/tpu/cols=" in out and "16 requests" in out
    assert "faults:" not in out
    if "--backends" in argv:
        assert "for sim/arm/noisy=1/mt=60" in out and "for host-cpu/r=9/cols=" in out
        assert all(f"backend {b}:" in out for b in ("arm", "tpu", "host"))


def test_probes_measure_through_the_device_profiler(warm_nets, monkeypatch):
    _, topt = warm_nets
    calls = []
    real = device_profiler.time_callable

    def recording(fn, *args, **kw):
        calls.append(fn.__qualname__)
        return real(fn, *args, **kw)
    monkeypatch.setattr(device_profiler, "time_callable", recording)
    clock = FakeClock()
    server = _timed(TServer)(max_batch=2, latency_budget_ms=1e9,
                             probe_rate=10.0, clock=clock, device="cpu")
    server.register(topt)
    for i in range(6):
        server.serve(topt.net, _requests(2, seed=i))
        clock.advance(0.2)                      # past the probe interval
    st = server.stats(topt.net)
    assert st["probes"] >= 3 and st["probe_failures"] == 0
    assert calls and set(calls) == {"column_callable.<locals>.<lambda>"}
    sample = server.served_sample(topt.net)
    assert sample.served_info["probes"] == st["probes"]
