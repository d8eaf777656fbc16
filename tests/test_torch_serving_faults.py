"""The port's fault-tolerant serving core against the reference on the CPU.

* Pure modules, exact parity: ``CircuitBreaker`` and ``FaultInjector`` fed
  one seeded event sequence in both packages give bit-equal verdicts,
  snapshots, outputs and injection logs; ``classify`` / ``validate_output``
  agree.
* Server decisions, parity: both servers run in pump mode under one
  ``FakeClock`` (each plan execution advances it by a fixed cost per
  image), with the same ``from_assignment`` network, the same weights, the
  same fault rules and the same script of submits, pumps, swaps and clock
  advances. Every ticket's outcome and routed backend, the ``stats()``
  counters and breaker snapshots agree exactly; served results agree
  within 1e-4.
* The reference's supervised-worker tests (hung-worker abandonment, the
  zombie race) in the port, driven by the injected clock: every wait has
  its own timeout and no verdict depends on a wall-clock race.
* The port's own rule: a kernel that does not build or launch, or any other
  exception of the plan, fails its tickets instead of being served by the
  safe plan, and register's warm-up re-raises its failure.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import threading
import time

import numpy as np
import pytest

from repro.models import cnn_zoo as JZ
from repro.primitives import executor as JE
from repro.primitives.plan import heuristic_assignment as j_heuristic
from repro.service import OptimisedNetwork as JNet
from repro.service import OptimisedServer as JServer
from repro.service.serving import faults as JF
from repro.service.serving import health as JH
from repro.service.pipeline import safe_assignment as j_safe
from repro_torch.kernels.common import KernelError
from repro_torch.models import cnn_zoo as TZ
from repro_torch.primitives.plan import heuristic_assignment as t_heuristic
from repro_torch.service import OptimisedNetwork as TNet
from repro_torch.service import OptimisedServer as TServer
from repro_torch.service import safe_assignment as t_safe
from repro_torch.service.serving import faults as TF
from repro_torch.service.serving import health as TH

RESULT_TOL = dict(rtol=1e-4, atol=1e-4)


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


def _wait_for(pred, timeout=60.0, what=""):
    """Poll ``pred`` until it holds; the timeout only bounds a hang, it
    decides nothing."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what or pred}")


# ---------------------------------------------------------------------------
# Pure modules: bit-equal against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,params", [
    (0, dict(failures=3, window=16, rate=0.5, cooldown_s=1.0, probes=1)),
    (1, dict(failures=2, window=6, rate=0.5, cooldown_s=0.3, probes=2)),
    (2, dict(failures=5, window=4, rate=0.25, cooldown_s=0.05, probes=1)),
])
def test_circuit_breaker_matches_reference(seed, params):
    rng = np.random.default_rng(seed)
    ref, port = JH.CircuitBreaker(**params), TH.CircuitBreaker(**params)
    t = 0.0
    for _ in range(400):
        t += float(rng.exponential(0.05))
        op = rng.integers(0, 4)
        if op == 0:
            assert ref.allow(t) == port.allow(t)
        elif op == 1:
            ok = bool(rng.random() < 0.4)
            ref.record(ok, t)
            port.record(ok, t)
        elif op == 2:
            ref.cancel_probe()
            port.cancel_probe()
        assert ref.snapshot(t) == port.snapshot(t)
        assert ref.inflight_probes == port.inflight_probes
    assert ref.opens == port.opens > 0
    assert JH.merge_failures({"a": 1}, {"a": 2, "b": 1}) == \
        TH.merge_failures({"a": 1}, {"a": 2, "b": 1})


def _outcome(inj, key, gen, thunk):
    try:
        return ("ok", inj.run(key, gen, thunk))
    except Exception as e:                    # FaultError of either package
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1])
def test_fault_injector_matches_reference(seed):
    rng = np.random.default_rng(seed)
    keys = ["n#a", "n#b", "solo"]
    rules = []
    for _ in range(6):
        kind = ["raise", "corrupt", "slowdown", "hang"][rng.integers(0, 4)]
        first = int(rng.integers(0, 8))
        rules.append(dict(kind=kind,
                          net=[None, *keys][rng.integers(0, 4)],
                          generation=[None, 0, 1][rng.integers(0, 3)],
                          first=first, last=first + int(rng.integers(1, 12)),
                          every=int(rng.integers(1, 4)), seconds=0.0,
                          factor=float(rng.uniform(2, 9))))
    rules.append(dict(kind="corrupt", net="profile:arm", first=1, factor=3.0))
    rules.append(dict(kind="raise", net="profile:arm", first=4, last=5))
    clock = FakeClock()
    ref = JF.FaultInjector([JF.Fault(**r) for r in rules], clock=clock)
    port = TF.FaultInjector([TF.Fault(**r) for r in rules], clock=clock)
    for i in range(60):
        key = keys[rng.integers(0, 3)]
        gen = int(rng.integers(0, 3))
        out = rng.standard_normal((4, 3)).astype(np.float32)
        a = _outcome(ref, key, gen, lambda: out.copy())
        b = _outcome(port, key, gen, lambda: out.copy())
        assert a[0] == b[0]
        if a[0] == "ok":
            np.testing.assert_array_equal(a[1], b[1])   # NaN rows equal too
        else:
            assert a[1] == b[1]
    for i in range(6):
        times = rng.uniform(1e-4, 1e-2, (5, 7))
        try:
            a = ref.profile("arm", times)
        except JF.FaultError as e:
            with pytest.raises(TF.FaultError, match=str(e)):
                port.profile("arm", times)
            continue
        np.testing.assert_array_equal(a, port.profile("arm", times))
    assert ref.injected == port.injected and len(port.injected) > 10
    assert all(ref.count(k) == port.count(k) for k in [*keys, "profile:arm"])
    # rule matching over a grid, and the refusals
    for r in rules:
        jf, tf = JF.Fault(**r), TF.Fault(**r)
        for key in [*keys, "profile:arm"]:
            for gen in (None, 0, 1, 2):
                assert [jf.matches(key, gen, i) for i in range(20)] == \
                    [tf.matches(key, gen, i) for i in range(20)]
    with pytest.raises(ValueError):
        TF.Fault("explode")
    with pytest.raises(ValueError):
        TF.Fault("raise", every=0)


def test_classify_and_validate_output_match_reference():
    cases = [np.ones((4, 3), np.float32), np.ones((2, 3), np.float32),
             np.array([[1.0, np.nan]], np.float32),
             np.full((4, 2), 3e38, np.float32)]   # sum overflows, values finite
    for arr in cases:
        verdicts = []
        for mod, health in ((JF, JH), (TF, TH)):
            try:
                verdicts.append(("ok", mod.validate_output(arr, 4).shape))
            except health.CorruptOutput as e:
                verdicts.append(("corrupt", str(e), mod.classify(e)))
        assert verdicts[0] == verdicts[1]
    for exc in ("CorruptOutput", "FaultError", "ValueError"):
        j = {"CorruptOutput": JH.CorruptOutput, "FaultError": JF.FaultError,
             "ValueError": ValueError}[exc]("x")
        t = {"CorruptOutput": TH.CorruptOutput, "FaultError": TF.FaultError,
             "ValueError": ValueError}[exc]("x")
        assert JF.classify(j) == TF.classify(t)


def test_poisoned_profiling_matches_reference():
    """``SimulatedPlatform(faults=)``: the profiling hook fails or scales
    measurements exactly as the reference's does."""
    from repro.service.platforms import SimulatedPlatform as JPlatform
    from repro_torch.service.platforms import SimulatedPlatform as TPlatform
    rules = [dict(kind="corrupt", net="profile:arm", first=1, last=3,
                  factor=7.0),
             dict(kind="raise", net="profile:arm", first=3, last=4)]
    samples = []
    for plat_cls, fmod in ((JPlatform, JF), (TPlatform, TF)):
        inj = fmod.FaultInjector([fmod.Fault(**r) for r in rules])
        plat = plat_cls("arm", max_triplets=16, faults=inj)
        got = [plat.measure_sample(6, seed=i).times for i in range(3)]
        with pytest.raises(fmod.FaultError):
            plat.measure_sample(6, seed=3)
        got.append(plat.profile_dlt(np.array([[16, 30], [32, 26]])))
        samples.append((got, inj.injected))
    (ref, ref_log), (port, port_log) = samples
    assert ref_log == port_log
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Server decisions in pump mode: the same script through both servers
# ---------------------------------------------------------------------------

PER_IMAGE_S = 1e-3        # FakeClock seconds a plan execution costs per row


def _timed(server_cls):
    class Timed(server_cls):
        """Each plan execution advances the injected clock by a fixed cost
        per padded row, so busy time, drift and canary timings are exact."""

        def _run_plan(self, opt, xs, weights):
            out = super()._run_plan(opt, xs, weights)
            self._clock.advance(PER_IMAGE_S * xs.shape[0])
            return out
    return Timed


def _fault_rules():
    return [dict(kind="raise", net="edge_cnn#a", first=2, last=6),
            dict(kind="corrupt", net="edge_cnn#b", first=1, last=2),
            dict(kind="raise", net="solo", generation=1)]


def _run_script(pkg):
    """One decision script. Returns (per-ticket trace, per-key stats, drift
    triggers)."""
    if pkg == "ref":
        zoo, net_cls, server_cls, fmod = JZ, JNet, JServer, JF
        heuristic, safe_of, kw = j_heuristic, j_safe, {}
    else:
        zoo, net_cls, server_cls, fmod = TZ, TNet, TServer, TF
        heuristic, safe_of, kw = t_heuristic, t_safe, {"device": "cpu"}
    spec = zoo.get("edge_cnn")
    asg, safe = heuristic(spec), safe_of(spec)
    weights = {k: np.asarray(v) for k, v in
               JE.make_weights(JZ.get("edge_cnn"), seed=3).items()}
    clock = FakeClock()
    inj = fmod.FaultInjector([fmod.Fault(**r) for r in _fault_rules()],
                             clock=clock)
    server = _timed(server_cls)(
        max_batch=4, latency_budget_ms=float("inf"), max_wait_ms=5.0,
        queue_depth=6, drift_threshold=1.5, drift_calib_obs=2,
        breaker_failures=2, breaker_cooldown_ms=10.0, auto_rollback=2,
        faults=inj, clock=clock, **kw)
    for backend, pred in (("a", 2e-3), ("b", 3e-3)):
        server.register(net_cls.from_assignment(spec, asg, net="edge_cnn",
                                                predicted_cost_s=pred),
                        backend=backend, weights=weights)
    server.register(net_cls.from_assignment(spec, asg, net="solo",
                                            predicted_cost_s=1e-3),
                    weights=weights)
    xs = _requests(49, seed=5)
    tickets = []

    def submit(net, i):
        tickets.append(server.submit(net, xs[i]))

    # 1) routing: the cheaper backend a first, b as a spills in
    for i in range(5):
        submit("edge_cnn", i)
    server.pump(drain=False)               # one full batch of 4 on a
    clock.advance(0.006)
    server.pump(drain=False)               # window expired: the rest
    # 2) a raises twice (dispatch + retry) per batch: degraded, breaker opens
    for rnd in range(3):
        for i in range(6 + 3 * rnd, 9 + 3 * rnd):
            submit("edge_cnn", i)
        server.pump()
    # 3) cooldown over: half-open probe to a closes it
    clock.advance(0.02)
    for i in range(15, 19):
        submit("edge_cnn", i)
    server.pump()
    # 4) canary rejects the faulted candidate generation; then an uncanaried
    #    swap to it fails twice and auto-rolls back
    swap_to = net_cls.from_assignment(spec, safe, net="solo",
                                      predicted_cost_s=1e-3)
    for i in range(19, 23):
        submit("solo", i)
    server.pump()
    verdicts = [server.hot_swap("solo", swap_to, canary=True)]
    verdicts.append(server.hot_swap("solo", swap_to, canary=False))
    for rnd in range(3):
        for i in range(23 + 2 * rnd, 25 + 2 * rnd):
            submit("solo", i)
        server.pump()
    keys = ("dispatches", "images", "padded", "rejected", "failed_dispatches",
            "failed_tickets", "retries", "fallback_dispatches",
            "fallback_images", "canary_rejected", "rollbacks", "generation",
            "breaker", "failures", "batch_cap", "busy_s", "inflight",
            "queued", "observed_dispatches", "drift_ratio",
            "queue_wait_p50_ms", "queue_wait_p99_ms", "window_scale")
    a_stats = server.stats("edge_cnn")["backends"]["a"]
    stats = {"edge_cnn#a": {k: a_stats[k] for k in keys}}
    # 5) backpressure and a drift excursion on b: it slows down 4x
    server.unregister_backend("edge_cnn", "a")
    base = server._run_plan

    def slow(opt, xs_, w):
        out = base(opt, xs_, w)
        clock.advance(3 * PER_IMAGE_S * xs_.shape[0])
        return out
    server._run_plan = slow
    for i in range(29, 37):
        submit("edge_cnn", i)                # 6 fit, 2 rejected
    server.pump()
    for rnd in range(3):
        for i in range(37 + 4 * rnd, 41 + 4 * rnd):
            submit("edge_cnn", i)
        server.pump()
    trace = [(t.net, t.error is None, t.rejected, t.degraded) for t in tickets]
    results = [t.result for t in tickets]
    for key, s in (("edge_cnn#b", server.stats("edge_cnn")["backends"]["b"]),
                   ("solo", server.stats("solo"))):
        stats[key] = {k: s[k] for k in keys}
    triggers = {k: server._drift.stats(k).triggers
                for k in ("edge_cnn#b", "solo")}
    backends = server.backends("edge_cnn")
    return trace, results, stats, triggers, verdicts, backends, inj.injected


@pytest.fixture(scope="module")
def scripted():
    return {pkg: _run_script(pkg) for pkg in ("ref", "port")}


def test_pump_decisions_match_reference(scripted):
    ref, port = scripted["ref"], scripted["port"]
    trace, _, stats, triggers, verdicts, backends, injected = port
    assert trace == ref[0]
    assert stats == ref[2]
    assert (triggers, verdicts, backends, injected) == \
        (ref[3], ref[4], ref[5], ref[6])
    # the script exercised what it is meant to
    routed = [net for net, *_ in trace]
    assert {"edge_cnn#a", "edge_cnn#b", "solo"} <= set(routed)
    assert any(d for *_, d in trace) and any(r for _, _, r, _ in trace)
    solo = stats["solo"]
    assert verdicts == [False, True]
    assert solo["canary_rejected"] == 1 and solo["rollbacks"] == 1
    assert solo["generation"] == 2
    assert stats["edge_cnn#a"]["retries"] >= 2
    assert stats["edge_cnn#a"]["fallback_images"] > 0
    assert stats["edge_cnn#a"]["breaker"]["opens"] == 1
    assert stats["edge_cnn#b"]["rejected"] == 2
    assert triggers["edge_cnn#b"] == 1


def test_pump_results_match_reference(scripted):
    ref_results, port_results = scripted["ref"][1], scripted["port"][1]
    served = 0
    for a, b in zip(ref_results, port_results):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, np.asarray(a), **RESULT_TOL)
            served += 1
    assert served >= 30


# ---------------------------------------------------------------------------
# Supervised workers: hung dispatch abandoned, rescued, worker replaced
# ---------------------------------------------------------------------------

def _net(net="edge_cnn", predicted=2e-3):
    spec = TZ.get("edge_cnn")
    return TNet.from_assignment(spec, t_heuristic(spec), net=net,
                                predicted_cost_s=predicted)


def test_hung_worker_is_abandoned_rescued_and_replaced():
    clock = FakeClock()
    inj = TF.FaultInjector(
        [TF.Fault("hang", net="edge_cnn", first=0, last=1, seconds=5.0)],
        clock=clock)
    server = TServer(max_batch=4, workers=1, max_wait_ms=0.0,
                     exec_deadline_ms=100.0, faults=inj, clock=clock,
                     device="cpu")
    server.register(_net())
    xs = _requests(2, seed=2)
    try:
        t1 = server.submit("edge_cnn", xs[0])
        _wait_for(lambda: inj.count("edge_cnn") == 1, what="worker to claim")
        clock.advance(0.2)                     # past the execution deadline
        _wait_for(lambda: t1.done, what="supervisor rescue")
        assert t1.error is None and t1.degraded and t1.result is not None
        s = server.stats("edge_cnn")
        assert s["failures"] == {"deadline": 1}
        assert s["fallback_images"] == 1 and s["images"] == 0
        _wait_for(lambda: server._pool.restarts == 1, what="replacement")
        assert server._pool.zombies == 1

        # the replacement worker serves fresh traffic
        t2 = server.submit("edge_cnn", xs[1])
        _wait_for(lambda: t2.done, what="replacement worker")
        assert t2.error is None and not t2.degraded

        # un-stick the zombie: it completes, loses every settle/finish race,
        # and exits — the rescued ticket's answer must not change
        rescued = t1.result.copy()
        clock.advance(10.0)
        _wait_for(lambda: server._pool.zombies == 0, what="zombie exit")
        assert t1.degraded and server.stats("edge_cnn")["images"] == 1
        np.testing.assert_array_equal(t1.result, rescued)
    finally:
        clock.advance(100.0)                   # free any residual stall
        server.stop(timeout=60.0)


def test_zombie_waking_mid_rescue_cannot_error_the_tickets():
    # The supervisor abandons a hung dispatch and starts the (held) fallback
    # rescue; the zombie's plan completes while the rescue is in flight. It
    # lost the settle race, so it must return without touching the tickets.
    clock = FakeClock()
    inj = TF.FaultInjector(
        [TF.Fault("hang", net="edge_cnn", first=0, last=1, seconds=5.0)],
        clock=clock)
    server = TServer(max_batch=4, workers=1, max_wait_ms=0.0,
                     exec_deadline_ms=100.0, faults=inj, clock=clock,
                     device="cpu")
    server.register(_net())
    rescue_started = threading.Event()
    rescue_resume = threading.Event()
    real_rescue = server._run_fallback

    def held_rescue(batch, err):
        rescue_started.set()
        rescue_resume.wait(60.0)
        return real_rescue(batch, err)

    server._run_fallback = held_rescue
    xs = _requests(2, seed=7)
    try:
        t1 = server.submit("edge_cnn", xs[0])
        _wait_for(lambda: inj.count("edge_cnn") == 1, what="worker to claim")
        clock.advance(0.2)                     # past the execution deadline
        _wait_for(rescue_started.is_set, what="supervisor rescue to start")
        assert not t1.done                     # the rescue is held

        # wake the zombie mid-rescue; a follow-up ticket proves a worker is
        # back in its claim loop
        clock.advance(10.0)
        t2 = server.submit("edge_cnn", xs[1])
        _wait_for(lambda: t2.done, what="worker to serve fresh traffic")
        assert t2.error is None and not t2.degraded
        _wait_for(lambda: server._pool.zombies == 0, what="zombie exit")
        assert not t1.done                     # the zombie did not touch it

        rescue_resume.set()                    # the rescue finishes the job
        _wait_for(lambda: t1.done, what="rescue to settle the ticket")
        assert t1.error is None and t1.degraded and t1.result is not None
        s = server.stats("edge_cnn")
        assert s["failures"] == {"deadline": 1}
        assert s["fallback_images"] == 1 and s["images"] == 1
    finally:
        rescue_resume.set()
        clock.advance(100.0)
        server.stop(timeout=60.0)


def test_fallback_serves_degraded_on_the_server_device():
    """A fault on one backend: its tickets are served by the safe plan
    through the interpreted executor on the server's device, within
    tolerance of the reference's safe plan; its breaker opens (traffic
    spills to the other backend) and recovers through a half-open probe
    once the faults end."""
    clock = FakeClock()
    inj = TF.FaultInjector([TF.Fault("raise", net="edge_cnn#a", last=4)],
                           clock=clock)
    server = TServer(max_batch=4, breaker_failures=2,
                     breaker_cooldown_ms=10.0, faults=inj, clock=clock,
                     device="cpu")
    seen = []
    real = server._fallback_forward

    def spy(*a):
        y = real(*a)
        seen.append(y.device.type)
        return y
    server._fallback_forward = spy
    spec = JZ.get("edge_cnn")
    weights = {k: np.asarray(v) for k, v in JE.make_weights(spec).items()}
    server.register(_net(predicted=2e-3), backend="a", weights=weights)
    server.register(_net(predicted=1.0), backend="b", weights=weights)
    xs = _requests(7, seed=3)
    ts = [server.submit("edge_cnn", x) for x in xs[:3]]
    server.pump()
    ts += [server.submit("edge_cnn", x) for x in xs[3:5]]
    server.pump()
    assert [t.net for t in ts] == ["edge_cnn#a"] * 5
    assert all(t.degraded and t.error is None for t in ts)
    assert seen == ["cpu"] * 5
    st = server.stats("edge_cnn")
    assert st["backends"]["a"]["breaker"]["state"] == "open"
    assert st["fallback_images"] == 5 and st["failed_tickets"] == 0
    assert st["failures"] == {"fault": 2} and st["retries"] == 2
    rep = JE.execute(spec, j_safe(spec), weights=JE.make_weights(spec),
                     x=xs[0], compiled=False)
    from repro.primitives.plan import sink_nodes
    np.testing.assert_allclose(ts[0].result,
                               np.asarray(rep.outputs[sink_nodes(spec)[-1]]),
                               **RESULT_TOL)
    spill = server.submit("edge_cnn", xs[5])   # a is open: spills to b
    server.pump()
    assert spill.net == "edge_cnn#b" and spill.error is None
    clock.advance(0.02)                        # cooldown over, faults spent
    probe = server.submit("edge_cnn", xs[6])
    assert server.stats("edge_cnn")["backends"]["a"]["breaker"]["state"] \
        == "half_open"
    server.pump()
    assert probe.net == "edge_cnn#a"
    assert probe.error is None and not probe.degraded
    br = server.stats("edge_cnn")["backends"]["a"]["breaker"]
    assert br["state"] == "closed" and br["opens"] == 1 and br["closes"] == 1


# ---------------------------------------------------------------------------
# Kernel and plan failures are never served around
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc,kind", [
    (KernelError("matmul: kernel launch failed with cudaError 98"), "kernel"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "error"),
    (ValueError("plan bug"), "error"),
])
def test_kernel_and_plan_failures_fail_tickets_not_degraded(exc, kind):
    """A dispatch whose plan raises anything but an injected fault or a
    corrupt output: one retry, then every ticket fails with the error — the
    safe plan serves nothing although ``fallback`` is on."""
    assert TF.classify(exc) == kind and kind not in TF.DEGRADABLE
    server = TServer(max_batch=4, clock=FakeClock(), device="cpu")
    server.register(_net(), weights=None)
    calls = [0]

    def broken(opt, xs, weights):
        calls[0] += 1
        raise exc
    server._run_plan = broken
    ts = [server.submit("edge_cnn", x) for x in _requests(3, seed=4)]
    server.pump()
    assert calls[0] == 2                        # the dispatch and its retry
    assert all(t.error == str(exc) and not t.degraded and t.result is None
               for t in ts)
    st = server.stats("edge_cnn")
    assert st["fallback_images"] == 0 and st["fallback_dispatches"] == 0
    assert st["failed_tickets"] == 3 and st["failed_dispatches"] == 1
    assert st["failures"] == {kind: 1} and st["retries"] == 1


@pytest.mark.parametrize("exc", [
    KernelError("conv_im2col_batch: nvcc failed"),
    ValueError("plan bug"),
])
def test_register_warm_up_failure_raises(exc, monkeypatch):
    """Register's warm-up re-raises whatever fails it — a kernel that does
    not build or launch above all — after publishing the buckets warmed so
    far (none here); the reference goes on quietly."""
    def bind(opt, weights, shape):
        def run(a):
            raise exc
        return run
    monkeypatch.setattr(TServer, "_bind_plan", staticmethod(bind))
    server = TServer(max_batch=4, clock=FakeClock(), device="cpu")
    with pytest.raises(type(exc)):
        server.register(_net(), weights=None)
    assert server._plan_handles[next(iter(server._plan_handles))][2] == {}
