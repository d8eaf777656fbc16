"""Serving soak of the port on the CPU — the reference's
``tests/test_serving_soak.py``: concurrent submitters x three networks x a
drifting platform, one sustained run holding the system-level invariants
that unit tests cannot see:

  * zero lost tickets — every accepted submission finishes with a result,
    every overflow submission is a marked rejection, nothing hangs;
  * zero duplicated tickets — served image count equals accepted ticket
    count exactly;
  * generations are monotonic, and each drift recalibration is a real
    hot-swap (generation == recalibrations) observed by later traffic;
  * the recalibration calibrated from served observations, not a fresh
    profiling pass.

The drift is injected into the server's clock, not slept: the clock is the
monotonic clock plus an offset, and each plan execution on the drifted
platform advances the offset by the excess cost (0.03 s an image times
``time_scale - 1``, the reference's sleep). The served latency the drift
monitor reads rises exactly as on a slower machine, and the soak costs no
wall time for it. The network starts warm from the committed arm models
(a copy of ``artifacts/``), so nothing trains. Every wait has a timeout.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import shutil
import threading
import time
from pathlib import Path

import numpy as np

from repro_torch.primitives.executor import make_weights
from repro_torch.primitives.plan import heuristic_assignment
from repro_torch.service import (ArtifactStore, OptimisedNetwork,
                                 OptimisedServer, make_recalibrator, optimise)
from repro_torch.service.platforms import SimulatedPlatform

ROOT = Path(__file__).resolve().parents[1]
EXCESS_S = 0.03                    # per image, per unit of slowdown


class OffsetClock:
    """``time.perf_counter()`` plus an offset that only grows."""

    def __init__(self):
        self.offset = 0.0
        self._lock = threading.Lock()

    def __call__(self) -> float:
        return time.perf_counter() + self.offset

    def advance(self, dt: float) -> None:
        with self._lock:
            self.offset += float(dt)


class _DriftingServer(OptimisedServer):
    """A plan execution on a platform slowed by ``time_scale`` advances the
    clock by the excess, as the reference's soak sleeps it."""

    def _run_plan(self, opt, xs, weights):
        out = super()._run_plan(opt, xs, weights)
        scale = getattr(opt.platform, "time_scale", 1.0) or 1.0
        if scale != 1.0:
            self._clock.advance(EXCESS_S * xs.shape[0] * (scale - 1.0))
        return out


def _until(pred, timeout):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.05)
    return pred()


def test_soak_no_lost_tickets_monotonic_generations(tmp_path):
    for part in ("models", "selections"):
        shutil.copytree(ROOT / "artifacts" / part, tmp_path / part)
    platform = SimulatedPlatform("arm", max_triplets=60)
    opt = optimise("edge_cnn", platform, store=ArtifactStore(
        str(tmp_path), device="cpu"), max_iters=2000, executable=True,
        device="cpu")
    assert opt.warm
    spec = opt.spec
    variants = [OptimisedNetwork.from_assignment(
        spec, heuristic_assignment(spec), net=f"edge_cnn@{tag}",
        predicted_cost_s=opt.predicted_cost_s) for tag in ("b", "c")]
    weights = make_weights(spec, device="cpu")

    server = _DriftingServer(
        max_batch=4, latency_budget_ms=1e9, workers=3, max_wait_ms=2.0,
        queue_depth=10_000, drift_threshold=1.5, drift_alpha=0.5,
        drift_calib_obs=2,
        recalibrate=make_recalibrator(sample_n=12, mode="factor",
                                      device="cpu"),
        clock=OffsetClock(), device="cpu")
    server.register(opt, weights=weights)
    for v in variants:
        server.register(v, weights=weights)
    nets = [opt.net] + [v.net for v in variants]

    n0 = spec.nodes[0]
    rng = np.random.default_rng(7)
    images = [rng.standard_normal((n0.c, n0.im, n0.im)).astype(np.float32)
              for _ in range(8)]       # shared read-only request pool

    stop = threading.Event()
    tickets = {net: [] for net in nets}
    t_lock = threading.Lock()

    def submitter(net, seed):
        """Closed loop: submit a burst of 4, wait for it, repeat."""
        local = []
        r = np.random.default_rng(seed)
        while not stop.is_set() and len(local) < 3000:
            burst = [server.submit(net, images[r.integers(len(images))])
                     for _ in range(4)]
            local.extend(burst)
            for t in burst:
                t.wait(30.0)
        with t_lock:
            tickets[net].extend(local)

    generations = []

    def sampler():
        while not stop.is_set():
            generations.append(server.stats(opt.net)["generation"])
            time.sleep(0.003)

    threads = [threading.Thread(target=submitter, args=(net, 10 + i))
               for i, net in enumerate(nets)]
    threads.append(threading.Thread(target=sampler))
    for th in threads:
        th.start()

    try:
        # healthy phase: until the drift reference and the observation
        # buffer are established (clean, post-warm-up dispatches)
        assert _until(lambda: server.stats(opt.net)["observed_dispatches"]
                      >= 6, 60.0), "healthy phase never produced clean observations"
        platform.time_scale = 4.0      # the machine gets 4x slower
        platform.invalidate_datasets()
        _until(lambda: server.stats(opt.net)["recalibrations"] > 0, 60.0)
    finally:
        stop.set()
        for th in threads:
            th.join(60.0)
        server.stop(timeout=60.0)      # drains every queued ticket
        platform.time_scale = 1.0
        platform.invalidate_datasets()
    assert not any(th.is_alive() for th in threads)

    # -- zero lost tickets: everything is finished, nothing hangs ----------
    all_tickets = [t for net in nets for t in tickets[net]]
    assert all_tickets, "soak submitted nothing"
    assert all(t.wait(30.0) for t in all_tickets)
    accepted = [t for t in all_tickets if not t.rejected]
    rejected = [t for t in all_tickets if t.rejected]
    assert all(t.done and t.error is None and t.result is not None
               for t in accepted)
    assert all(t.done and t.result is None for t in rejected)

    # -- zero duplicated tickets: served images == accepted submissions ----
    stats = {net: server.stats(net) for net in nets}
    assert sum(s["images"] for s in stats.values()) == len(accepted)
    assert sum(s["rejected"] for s in stats.values()) == len(rejected)

    # -- drift was detected and every recalibration was a real hot-swap ----
    st = stats[opt.net]
    assert st["recalibrations"] >= 1, f"no recalibration: {st}"
    assert st["generation"] == st["recalibrations"]
    assert st["last_recal_error"] is None
    for v in variants:                 # undrifted nets untouched
        assert stats[v.net]["recalibrations"] == 0
        assert stats[v.net]["generation"] == 0

    # -- the recalibration sample came (mostly) from served traffic --------
    assert st["recal_sample"] is not None
    assert st["recal_sample"]["served_fraction"] >= 0.5

    # -- generations monotonic, and the swap is visible to later traffic ---
    assert generations == sorted(generations)
    out = server.serve(opt.net, [images[0], images[1]])
    assert all(r is not None for r in out)
    assert server.stats(opt.net)["generation"] >= st["generation"]
