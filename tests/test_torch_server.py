"""The port's server in pump mode on the CPU against the reference's
compiled plan: bursts of 1, 3 and 8 (pow2 padding by repeating the last
row), every response equal to ``repro.primitives.plan.compile_plan`` on the
same weights and inputs at the reference's plan tolerance."""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import cnn_zoo as JZ
from repro.primitives import executor as JE
from repro.primitives import plan as JP
from repro_torch.models import cnn_zoo as TZ
from repro_torch.primitives import plan as TP
from repro_torch.service.pipeline import OptimisedNetwork, safe_assignment
from repro_torch.service.serving.queues import NetQueue, Ticket, pow2_ceil, pow2_floor
from repro_torch.service.serving.server import OptimisedServer
from test_torch_plan import kernel_mix_assignment, pbqp_edge_cnn

PLAN_TOL = dict(rtol=2e-3, atol=2e-3)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("rule", ["pbqp", "mix"])
def test_served_bursts_match_reference_plan(rule, rng):
    spec = TZ.get("edge_cnn")
    asg = pbqp_edge_cnn() if rule == "pbqp" else kernel_mix_assignment(spec)
    jw = JE.make_weights(JZ.get("edge_cnn"), seed=3)
    server = OptimisedServer(max_batch=8, latency_budget_ms=float("inf"),
                             device="cpu")
    server.register(OptimisedNetwork.from_assignment(spec, asg),
                    weights={k: np.asarray(v) for k, v in jw.items()})
    xs = rng.standard_normal((12, 3, 32, 32)).astype(np.float32)
    jplan = JP.compile_plan(JZ.get("edge_cnn"), asg)
    want = np.asarray(jplan(jnp.asarray(xs), jw)[jplan.sinks[-1]])
    for lo, hi in ((0, 1), (1, 4), (4, 12)):          # bursts of 1, 3 and 8
        got = server.serve("edge_cnn", list(xs[lo:hi]))
        assert len(got) == hi - lo
        np.testing.assert_allclose(np.stack(got), want[lo:hi], **PLAN_TOL)
    st = server.stats("edge_cnn")
    assert st["dispatches"] == 3 and st["images"] == 12
    assert st["padded"] == 1                   # the burst of 3 ran as 4
    assert st["rejected"] == 0 and st["failed_tickets"] == 0
    assert st["queue_wait_p99_ms"] >= st["queue_wait_p50_ms"] >= 0.0


def test_batch_cap_window_and_backpressure(rng):
    clock = FakeClock()
    spec = TZ.get("edge_cnn")
    server = OptimisedServer(max_batch=4, latency_budget_ms=float("inf"),
                             max_wait_ms=5.0, queue_depth=6, clock=clock,
                             device="cpu")
    server.register(OptimisedNetwork.from_assignment(spec, TP.heuristic_assignment(spec)))
    xs = rng.standard_normal((7, 3, 32, 32)).astype(np.float32)
    ts = [server.submit("edge_cnn", x) for x in xs]
    assert ts[-1].rejected and ts[-1].done and server.stats("edge_cnn")["rejected"] == 1
    assert server.pump(drain=False) == 1         # one full batch of 4
    assert all(t.done and t.error is None for t in ts[:4])
    assert server.pump(drain=False) == 0         # 2 left, window still open
    clock.t += 0.006
    assert server.pump(drain=False) == 1         # window expired
    assert all(t.result.shape == (96, 2, 2) for t in ts[:6])
    with pytest.raises(ValueError):
        server.submit("edge_cnn", xs[0][:, :16])


def test_batch_cap_follows_prediction():
    server = OptimisedServer(max_batch=32, latency_budget_ms=50.0, device="cpu")
    assert server._batch_cap(float("nan"), None) == 32
    assert server._batch_cap(0.004, None) == 8      # 50 ms / 4 ms -> 12 -> 8
    assert server._batch_cap(1.0, None) == 1
    assert pow2_ceil(3) == 4 and pow2_floor(12) == 8 and pow2_ceil(1) == 1


def test_failed_dispatch_errors_its_tickets(rng, monkeypatch):
    spec = TZ.get("edge_cnn")
    server = OptimisedServer(max_batch=4, latency_budget_ms=float("inf"),
                             fallback=False, device="cpu")
    server.register(OptimisedNetwork.from_assignment(spec, TP.heuristic_assignment(spec)))

    def broken(*a, **k):
        raise RuntimeError("device fault")
    monkeypatch.setattr(server, "_run_plan", broken)
    xs = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device fault"):
        server.serve("edge_cnn", list(xs))
    st = server.stats("edge_cnn")
    assert st["failed_dispatches"] == 1 and st["failed_tickets"] == 3


def test_reregister_rejects_queued_tickets(rng):
    spec = TZ.get("edge_cnn")
    server = OptimisedServer(max_batch=4, device="cpu")
    opt = OptimisedNetwork.from_assignment(spec, TP.heuristic_assignment(spec))
    server.register(opt)
    t = server.submit("edge_cnn", rng.standard_normal((3, 32, 32)))
    server.register(OptimisedNetwork.from_assignment(spec, safe_assignment(spec)))
    assert t.rejected and "re-registered" in t.error
    assert server.networks() == ["edge_cnn"]


def test_ticket_and_queue_copy():
    q = NetQueue(depth=2, batch_cap=2, max_wait_s=1.0, budget_s=0.5, predicted_s=0.1)
    assert q.effective_wait_s() == pytest.approx(0.4)
    a, b = Ticket("n", np.zeros(1)), Ticket("n", np.zeros(1))
    assert q.push(a) and q.push(b) and not q.push(Ticket("n", np.zeros(1)))
    assert q.ready(0.0) and q.take(5) == [a, b]
    assert a.finish(result=np.ones(1)) and not a.finish(error="late")
    assert a.wait(0) and a.error is None
