"""Serving core in pump mode — the port of ``repro.service.serving.server``
for one device.

``OptimisedServer`` serves registered optimised networks through the
port's compiled plans:

  * **Perf-model-predicted batching**: a network's batch cap is
    ``latency_budget / predicted_per_image`` rounded down to a power of two
    (``max_batch`` when there is no prediction); a partial batch pads up to
    the next pow2 bucket by repeating its last row, so each network needs
    one bound plan per bucket, and the pad rows are dropped on delivery.
  * **Deadline-aware batch windows** and **backpressure** through
    ``queues.NetQueue``: ``submit`` returns a rejected ticket past
    ``queue_depth``.
  * **Bound plans per bucket**: ``register`` moves the weights to the
    device once and binds (and warms, on zeros) one plan handle per pow2
    bucket, so a dispatch is one host-to-device copy, one plan call and
    one device-to-host copy of the sink.

This slice serves synchronously: ``submit`` then ``pump()`` (or ``serve``)
runs batches on the calling thread. A failed dispatch errors its tickets;
there is no degradation to another plan or device. The reference's worker
pool, multi-backend routing, drift recalibration, fault injection, canary
hot-swap, process front end and probe dispatches are not ported yet: their
knobs raise ``NotImplementedError`` when set to anything but the default.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.primitives.executor import evict_prim_entries, make_weights
from repro_torch.primitives.plan import compile_plan, evict_plans, source_nodes
from repro_torch.service.pipeline import OptimisedNetwork
from repro_torch.service.serving.queues import (NetQueue, Ticket, monotonic,
                                                pow2_ceil, pow2_floor)


def _unported(**knobs) -> None:
    """Raise for any knob set away from its default: this slice serves in
    pump mode on one backend and would otherwise silently ignore it."""
    for name, (value, default) in knobs.items():
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (pump mode only)")


def validate_output(out: np.ndarray, batch: int) -> np.ndarray:
    """Reject a plan output that would silently corrupt results: a wrong
    leading batch dimension or non-finite values."""
    if out.ndim < 1 or out.shape[0] != batch:
        raise RuntimeError(f"plan returned shape {out.shape} for a batch of {batch}")
    if not np.isfinite(out.sum(dtype=np.float64)):
        bad = int(out.size - np.isfinite(out).sum())
        if bad:
            raise RuntimeError(f"plan output contains {bad} non-finite values")
    return out


@dataclasses.dataclass
class _NetState:
    opt: OptimisedNetwork
    weights: Dict[int, torch.Tensor]   # on the server's device
    queue: NetQueue
    latency_budget_ms: Optional[float]
    dispatches: int = 0
    images: int = 0
    padded: int = 0
    rejected: int = 0
    busy_s: float = 0.0
    failed_dispatches: int = 0
    failed_tickets: int = 0
    waits: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=4096))
    # bound plan per pow2-bucket input shape (``_precompile_plans``)
    handles: Dict[Tuple[int, ...], Callable] = dataclasses.field(default_factory=dict)
    # preallocated pow2-bucket batch buffers, reused across dispatches
    pad_scratch: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


class OptimisedServer:
    """Multi-network serving front end on one device, synchronous pump mode:
    ``submit`` then ``pump()`` drains inline on the calling thread."""

    def __init__(self, *, max_batch: int = 32,
                 latency_budget_ms: float = 50.0,
                 workers: int = 0,
                 max_wait_ms: float = 5.0,
                 queue_depth: int = 256,
                 recalibrate: Optional[Callable] = None,
                 canary: bool = False,
                 faults=None,
                 frontend_procs: int = 0,
                 probe_rate: float = 0.0,
                 clock: Optional[Callable[[], float]] = None,
                 device="cuda"):
        _unported(workers=(workers, 0), recalibrate=(recalibrate, None),
                  canary=(canary, False), faults=(faults, None),
                  frontend_procs=(frontend_procs, 0),
                  probe_rate=(probe_rate, 0.0))
        self.max_batch = max_batch
        self.latency_budget_ms = latency_budget_ms
        self.max_wait_ms = max_wait_ms
        self.queue_depth = queue_depth
        self.device = torch.device(device)
        self._clock = clock if clock is not None else monotonic
        self._nets: Dict[str, _NetState] = {}
        self._order: List[str] = []            # round-robin claim fairness
        self._rr = 0

    # -- registration ------------------------------------------------------
    def _budget_s(self, budget_ms: Optional[float]) -> float:
        return (budget_ms if budget_ms is not None
                else self.latency_budget_ms) * 1e-3

    def _batch_cap(self, predicted_cost_s: float,
                   budget_ms: Optional[float]) -> int:
        budget_s = self._budget_s(budget_ms)
        if not np.isfinite(predicted_cost_s) or predicted_cost_s <= 0:
            return pow2_floor(self.max_batch)
        cap = int(np.clip(budget_s / predicted_cost_s, 1, self.max_batch))
        return pow2_floor(cap)

    def register(self, opt: OptimisedNetwork, *, backend: Optional[str] = None,
                 weights: Optional[Dict] = None,
                 latency_budget_ms: Optional[float] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None) -> _NetState:
        """Register an optimised network for serving. ``weights`` (numpy
        arrays or tensors, reference layouts) default to ``make_weights``;
        they move to the server's device once, here. Re-registering a name
        replaces it and rejects its queued tickets."""
        _unported(backend=(backend, None))
        if weights is None:
            weights = make_weights(opt.spec, device=self.device)
        else:
            weights = {int(k): (v if isinstance(v, torch.Tensor)
                                else torch.from_numpy(np.array(v, np.float32))
                                ).to(self.device, torch.float32).contiguous()
                       for k, v in weights.items()}
        pred = opt.predicted_cost_s
        queue = NetQueue(
            depth=queue_depth if queue_depth is not None else self.queue_depth,
            batch_cap=self._batch_cap(pred, latency_budget_ms),
            max_wait_s=(max_wait_ms if max_wait_ms is not None
                        else self.max_wait_ms) * 1e-3,
            budget_s=self._budget_s(latency_budget_ms),
            predicted_s=pred if np.isfinite(pred) and pred > 0 else 0.0)
        state = _NetState(opt=opt, weights=weights, queue=queue,
                          latency_budget_ms=latency_budget_ms,
                          handles=self._precompile_plans(opt, weights))
        old = self._nets.get(opt.net)
        if old is None:
            self._order.append(opt.net)
        self._nets[opt.net] = state
        if old is not None:
            self._evict_retired(old)
            for t in old.queue.drain():
                t.finish(error=f"rejected: {opt.net!r} was re-registered",
                         rejected=True)
        return state

    def _evict_retired(self, old: _NetState) -> None:
        """Drop a replaced registration's plan-cache entries and primitive
        callables no live registration uses."""
        if any(st.opt.spec.name == old.opt.spec.name
               and st.opt.assignment == old.opt.assignment
               for st in self._nets.values()):
            return
        evict_plans(old.opt.spec, old.opt.assignment)
        live = set()
        for st in self._nets.values():
            live.update(st.opt.assignment.values())
        evict_prim_entries(set(old.opt.assignment.values()) - live)

    @staticmethod
    def _bind_plan(opt: OptimisedNetwork, weights: Dict[int, torch.Tensor],
                   shape: Tuple[int, ...]) -> Callable:
        """One bound dispatch handle: the compiled plan for ``shape`` with
        the registration's device weights closed over, returning the served
        sink only."""
        plan = compile_plan(opt.spec, opt.assignment, shape)
        src, sink, fn = plan.sources[0], plan.sinks[-1], plan.fn
        return lambda a: fn({src: a}, weights)[sink]

    def _precompile_plans(self, opt: OptimisedNetwork,
                          weights: Dict[int, torch.Tensor]
                          ) -> Dict[Tuple[int, ...], Callable]:
        """Bind and warm one plan handle per pow2 bucket up to
        ``max_batch`` (single-input specs), running each once on zeros so
        kernel libraries load and the device allocator warms at register
        time, not on the first dispatch."""
        handles: Dict[Tuple[int, ...], Callable] = {}
        srcs = source_nodes(opt.spec)
        if len(srcs) == 1:
            n0 = opt.spec.nodes[srcs[0]]
            b, cap = 1, pow2_ceil(max(int(self.max_batch), 1))
            while b <= cap:
                shape = (b, n0.c, n0.im, n0.im)
                bound = self._bind_plan(opt, weights, shape)
                bound(torch.zeros(shape, device=self.device))
                handles[shape] = bound
                b *= 2
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return handles

    # -- requests ----------------------------------------------------------
    def submit(self, net: str, x: np.ndarray) -> Ticket:
        """Enqueue one request. The returned ticket is already finished (and
        ``rejected``) when the network's queue is full."""
        x = np.array(x, dtype=np.float32)          # the ticket owns its copy
        state = self._nets[net]
        n0 = state.opt.spec.nodes[source_nodes(state.opt.spec)[0]]
        if x.shape != (n0.c, n0.im, n0.im):
            raise ValueError(f"{net!r} expects one ({n0.c}, {n0.im}, "
                             f"{n0.im}) image per request, got {x.shape}")
        t = Ticket(net=net, x=x, submitted_s=self._clock(), clock=self._clock)
        if not state.queue.push(t):
            state.rejected += 1
            t.finish(error=f"rejected: {net!r} at queue depth (backpressure)",
                     rejected=True)
        return t

    def _claim(self, now: float, *, drain: bool) -> Optional[Tuple[str, List[Ticket]]]:
        """Pop the next dispatchable batch, round-robin across networks."""
        n = len(self._order)
        for k in range(n):
            name = self._order[(self._rr + k) % n]
            state = self._nets[name]
            if not state.queue.ready(now, drain=drain):
                continue
            tickets = state.queue.take(state.queue.batch_cap)
            t_claim = self._clock()
            for t in tickets:
                t.dispatched_s = t_claim
                state.waits.append(t.queue_wait_s)
            self._rr = (self._rr + k + 1) % n
            return name, tickets
        return None

    # -- execution ---------------------------------------------------------
    def _run_plan(self, state: _NetState, xs: np.ndarray) -> np.ndarray:
        """Execute one padded batch: copy it to the device, run the bound
        plan for its shape (a shape outside the buckets binds through the
        global plan cache) and copy the sink back."""
        x = torch.from_numpy(xs).to(self.device)
        bound = state.handles.get(xs.shape)
        if bound is None:
            bound = self._bind_plan(state.opt, state.weights, xs.shape)
        return bound(x).cpu().numpy()

    def _assemble(self, state: _NetState, tickets: List[Ticket], b: int) -> np.ndarray:
        """The pow2-padded batch: rows in ticket order, the last row repeated
        into the pad, in the state's reused bucket buffer."""
        if b == 1:
            return tickets[0].x[None]
        row = tickets[0].x
        xs = state.pad_scratch.get(b)
        if xs is None or xs.shape[1:] != row.shape:
            xs = np.empty((b,) + row.shape, np.float32)
            state.pad_scratch[b] = xs
        for j, t in enumerate(tickets):
            xs[j] = t.x
        xs[len(tickets):] = xs[len(tickets) - 1]
        return xs

    def execute(self, name: str, tickets: List[Ticket]) -> None:
        """Run one claimed batch to completion and settle every ticket."""
        state = self._nets[name]
        take = len(tickets)
        b = pow2_ceil(take)
        t0 = self._clock()
        try:
            xs = self._assemble(state, tickets, b)
            out = validate_output(self._run_plan(state, xs), b)
        except Exception as e:               # errors its tickets, nothing else
            state.failed_dispatches += 1
            state.failed_tickets += take
            for t in tickets:
                t.finish(error=f"{type(e).__name__}: {e}")
            return
        state.busy_s += self._clock() - t0
        state.dispatches += 1
        state.images += take
        state.padded += b - take
        for j, t in enumerate(tickets):
            t.finish(result=out[j])

    def pump(self, drain: bool = True) -> int:
        """Serve queued tickets inline, returning the dispatch count.
        ``drain=True`` ignores batch windows (pump IS the arrival of serving
        capacity); ``drain=False`` dispatches only batches that are ready
        (full, or window expired against the injected clock)."""
        dispatches = 0
        while True:
            claim = self._claim(self._clock(), drain=drain)
            if claim is None:
                return dispatches
            self.execute(*claim)
            dispatches += 1

    def serve(self, net: str, xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Submit a burst and drain it. Raises if any request failed; a burst
        larger than ``queue_depth`` drains mid-submission instead of
        tripping backpressure."""
        tickets = []
        for x in xs:
            t = self.submit(net, x)
            if t.rejected:                 # queue full: drain, retry once
                self.pump()
                t = self.submit(net, x)
            tickets.append(t)
        self.pump()
        failed = [t.error for t in tickets if t.error]
        if failed:
            raise RuntimeError(f"{len(failed)} request(s) failed: {failed[0]}")
        return [t.result for t in tickets]

    # -- introspection -----------------------------------------------------
    def stats(self, net: str) -> Dict:
        s = self._nets[net]
        waits = np.asarray(s.waits, np.float64)
        return {"batch_cap": s.queue.batch_cap,
                "latency_budget_ms": self._budget_s(s.latency_budget_ms) * 1e3,
                "dispatches": s.dispatches, "images": s.images,
                "padded": s.padded, "busy_s": s.busy_s,
                "images_per_s": (s.images / s.busy_s if s.busy_s else 0.0),
                "queued": len(s.queue), "rejected": s.rejected,
                "failed_dispatches": s.failed_dispatches,
                "failed_tickets": s.failed_tickets,
                "effective_wait_ms": s.queue.effective_wait_s() * 1e3,
                "queue_wait_p50_ms": (float(np.percentile(waits, 50)) * 1e3
                                      if waits.size else 0.0),
                "queue_wait_p99_ms": (float(np.percentile(waits, 99)) * 1e3
                                      if waits.size else 0.0)}

    def networks(self) -> List[str]:
        return list(self._order)
