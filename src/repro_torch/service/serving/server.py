"""Concurrent serving core on one device — the port of
``repro.service.serving.server`` (DESIGN.md §8).

``OptimisedServer`` serves any number of registered optimised networks
through the port's compiled plans (``repro_torch.primitives.plan``),
closing the paper's loop end to end:

    profile → model → select → serve → observe → recalibrate → hot_swap

  * **Perf-model-predicted batching**: a network's batch cap is
    ``latency_budget / predicted_per_image`` rounded down to a power of two;
    a partial batch pads up to the next pow2 bucket by repeating its last
    row, and the pad rows are dropped on delivery.
  * **Deadline-aware batch windows** (``queues.NetQueue``): a batch
    dispatches when it is full or when its oldest ticket has waited the
    effective window; the drift monitor shrinks the window when observed
    p99 queueing latency exceeds the budget.
  * **Worker pool + backpressure** (``workers.WorkerPool``): ``workers`` > 0
    runs dispatches on supervised threads, each with its own CUDA stream;
    ``submit`` returns a *rejected* ticket past ``queue_depth``.
    ``workers=0`` keeps the synchronous ``pump()`` mode.
  * **Drift-triggered recalibration** (``drift.DriftMonitor``): served
    per-image latency (host clock, ending in the dispatch's device-to-host
    copy) is tracked against the model's prediction; an excursion runs
    ``recalibrate`` on a background thread and ``hot_swap``s the result in,
    exactly once per excursion, calibrating from the served observations.
  * **Faults** (``faults``, ``health``): one retry, then degradation to the
    network's safe plan (``pipeline.safe_assignment``: no hand-written
    kernel) on the server's device — for an injected fault, a corrupt
    output or a hung dispatch only. A kernel that does not build or launch,
    or any other exception of the plan, fails its tickets: a broken kernel
    is never served around. Per-backend circuit breakers; a canary batch
    gating ``hot_swap``; a bounded rollback ring and auto-rollback.
  * **Predicted-cost cross-backend routing**: ``register(opt,
    backend="gpu")`` adds one backend of a logical network; ``submit`` sends
    each request to the backend whose predicted marginal cost is lowest,
    spilling on backpressure and skipping open breakers.
  * **Probes**: rate-limited single-layer measurements of assigned (config,
    column) pairs, timed as the measured platform profiles them
    (``profiler/device.py``), so a probe row and a profiled row mean the
    same thing.
  * **Process front end** (``frontend.py``): ``frontend_procs`` > 0 (with
    ``workers`` >= 1) lets ``frontend()`` start intake processes that
    assemble request batches in shared-memory slabs; the workers execute a
    slab batch whole (``_submit_group``). On a cuda server the slabs are
    page-locked once, so a slab batch reaches the card in one asynchronous
    copy on the worker's stream; loose tickets keep the pageable upload.

Device discipline: registered weights live on ``device``; every path that
publishes weights or bound plan handles made on one thread to the workers
(``register``, ``hot_swap`` and its canary, ``rollback``, the recalibration
thread, which swaps through ``hot_swap``) synchronises the device first. A
claimed batch keeps its own ``opt``/``weights`` until its device-to-host
copy returns, so a swap never frees weights a stream still reads.

Timing is injectable: ``clock=`` replaces the monotonic clock everywhere a
window or queueing decision reads time.

CLI:

    python -m repro_torch.service.server --net edge_cnn --platform arm \\
        --workers 2 --max-wait-ms 5 --latency-budget-ms 50 \\
        [--frontend-procs 2]
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import itertools
import math
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.cnn_zoo import ConvLayer
from repro_torch.primitives.conv import is_runnable
from repro_torch.primitives.executor import (evict_prim_entries, execute as
                                             execute_reference, make_weights)
from repro_torch.primitives.plan import (compile_plan, evict_plans, sink_nodes,
                                         source_nodes)
from repro_torch.profiler import device as device_profiler
from repro_torch.profiler.dataset import observations_to_dataset
from repro_torch.service.pipeline import (OptimisedNetwork, optimise,
                                          reoptimise, safe_assignment)
from repro_torch.service.serving.drift import DriftMonitor, LayerProfile
from repro_torch.service.serving.faults import (DEGRADABLE, FaultInjector,
                                                classify, validate_output)
from repro_torch.service.serving.health import CircuitBreaker, merge_failures
from repro_torch.service.serving.queues import (BatchGroup, NetQueue, Ticket,
                                                monotonic, pow2_ceil,
                                                pow2_floor)
from repro_torch.service.serving.workers import WorkerPool

# batch-shape cost model (DESIGN.md §12.3): fit the per-bucket scale head
# once this many clean observations are buffered, refit every this many more
BUCKET_MIN_OBS = 8
BUCKET_REFRESH_EVERY = 8
# a probe is the median of this many timed calls after two warm-ups
PROBE_REPEATS = 3


class ProbeUnsupported(Exception):
    """The probe target's column cannot execute here (simulated-only
    primitive) — the probe is skipped, not counted as a failure."""


def layer_profile(opt: OptimisedNetwork) -> Optional[LayerProfile]:
    """The attribution profile for served-sample telemetry: the network's
    assigned conv-layer configs, their assigned primitive columns, and the
    model-predicted per-image runtimes (DESIGN.md §8.5). None when the
    network carries no models (``from_assignment``) or nothing attributable —
    such networks are still drift-monitored, just not sample-buffered."""
    if opt.models is None:
        return None
    model = opt.models.prim
    rows, cols = [], []
    for i, node in enumerate(opt.spec.nodes):
        if not isinstance(node, ConvLayer):
            continue
        prim = opt.assignment.get(i)
        if prim is None or prim not in model.columns:
            continue
        rows.append(node.config)
        cols.append(prim)
    if not rows:
        return None
    feats = np.asarray(rows, np.float64)
    pred = model.predict(feats)
    idx = [model.columns.index(c) for c in cols]
    predicted = pred[np.arange(len(rows)), idx]
    if not (np.isfinite(predicted).all() and (predicted > 0).all()
            and np.isfinite(predicted.sum())):
        return None
    return LayerProfile(feats=feats, columns=tuple(cols), predicted=predicted)


@dataclasses.dataclass
class _Batch:
    """One claimed dispatch: tickets already popped from the queue, the
    network's in-flight slot already taken. Snapshots opt/weights at claim
    time so an already-claimed batch finishes on the plan it was claimed
    under even if a hot_swap lands before execution (and the weights it
    reads stay alive until its device-to-host copy returns), and carries
    the _NetState so accounting survives a re-register replacing the state.

    ``claimed_s`` is the claim timestamp the worker supervisor ages against
    the execution deadline; ``settled`` guards the release of the in-flight
    slot — the executing worker, its ``finally``, a late zombie, and the
    supervisor's ``abandon`` may all race to settle, and exactly one wins
    (DESIGN.md §11.3).

    A slab batch from the process front end carries its pre-assembled,
    pow2-padded ``xs`` (a zero-copy shared-memory view) and the group's
    ``on_done``, fired exactly once when the dispatch settles."""
    net: str
    tickets: List[Ticket]
    generation: int
    state: "_NetState"
    opt: OptimisedNetwork
    weights: Dict
    claimed_s: float = 0.0
    settled: bool = False              # mutated only under the server lock
    xs: Optional[np.ndarray] = None    # slab batch: the padded view
    on_done: Optional[Callable] = None


@dataclasses.dataclass
class _NetState:
    opt: OptimisedNetwork
    weights: Dict[int, torch.Tensor]   # on the server's device
    queue: NetQueue
    max_inflight: int
    latency_budget_ms: Optional[float]
    logical: str = ""                  # the network name requests route under
    backend: Optional[str] = None      # None = plain single-backend entry
    generation: int = 0                # bumped by hot_swap
    inflight: int = 0
    dispatches: int = 0
    images: int = 0
    padded: int = 0
    rejected: int = 0
    recalibrations: int = 0
    last_recal_error: Optional[str] = None
    last_recal_sample: Optional[Dict] = None   # served/fresh mix (§8.5)
    busy_s: float = 0.0
    # fault tolerance (DESIGN.md §11)
    breaker: Optional[CircuitBreaker] = None   # set by register()
    history: Deque = dataclasses.field(        # rollback ring: (gen, opt)
        default_factory=deque)
    fallback_asg: Optional[Dict[int, str]] = None   # lazily-built safe plan
    retries: int = 0                   # primary attempts retried
    failed_dispatches: int = 0         # dispatches whose primary path failed
    failed_tickets: int = 0            # tickets finished with error=
    fallback_dispatches: int = 0       # failed dispatches rescued (≥1 ticket)
    fallback_images: int = 0           # tickets served degraded
    canary_rejected: int = 0           # hot_swap candidates the canary vetoed
    last_canary: Optional[str] = None  # last canary rejection reason
    rollbacks: int = 0                 # generations reverted (manual + auto)
    # consecutive primary failures since this generation went live; -1 once
    # it has ANY success (a proven generation is never auto-rolled-back)
    gen_bad_streak: int = 0
    # batch-shape cost model (DESIGN.md §12.3)
    bucket_head: Optional[object] = None
    bucket_obs_at_fit: int = 0
    # (generation, batch_bucket) -> completion time of the FIRST execution:
    # a dispatch that STARTED before it may have paid first-call costs (plan
    # lowering, allocator growth) and must not feed the drift EWMA
    bucket_ready: Dict[Tuple[int, int], float] = dataclasses.field(
        default_factory=dict)
    waits: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=4096))
    # preallocated pow2-bucket batch buffers, reused when max_inflight == 1
    pad_scratch: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)
    # probe dispatches (DESIGN.md §14.4)
    probes: int = 0                    # probes measured successfully
    probe_failures: int = 0            # probes that raised / were faulted
    last_probe_s: float = -math.inf    # rate-limit clock, server lock held
    probe_rr: int = 0                  # round-robin layer cursor
    # drift-pool manifests already acted on by poll_pool
    pool_seen: set = dataclasses.field(default_factory=set)

    @property
    def batch_cap(self) -> int:
        return self.queue.batch_cap


class OptimisedServer:
    """Multi-network serving front end on one device. ``workers=0``
    (default) is the synchronous mode: ``submit`` then ``pump()`` drains
    inline on the calling thread. ``workers>0`` starts a thread pool at
    first ``register`` and ``serve``/``Ticket.wait`` block on completion
    events instead."""

    def __init__(self, *, max_batch: int = 32,
                 latency_budget_ms: float = 50.0,
                 workers: int = 0,
                 max_wait_ms: float = 5.0,
                 queue_depth: int = 256,
                 max_inflight: int = 1,
                 recalibrate: Optional[Callable] = None,
                 drift_threshold: float = 1.5,
                 drift_alpha: float = 0.25,
                 drift_calib_obs: int = 3,
                 obs_cap: int = 256,
                 exec_deadline_ms: Optional[float] = None,
                 fallback: bool = True,
                 canary: bool = False,
                 canary_batch: int = 2,
                 canary_slowdown: float = 8.0,
                 auto_rollback: int = 3,
                 rollback_history: int = 4,
                 breaker_failures: int = 3,
                 breaker_window: int = 16,
                 breaker_rate: float = 0.5,
                 breaker_cooldown_ms: float = 250.0,
                 breaker_probes: int = 1,
                 faults: Optional[FaultInjector] = None,
                 bucket_cost_model: bool = True,
                 frontend_procs: int = 0,
                 frontend_slots: int = 16,
                 probe_rate: float = 0.0,
                 clock: Optional[Callable[[], float]] = None,
                 device="cuda"):
        """The reference's knobs, on ``device``. ``exec_deadline_ms`` is the
        per-dispatch execution deadline the worker supervisor enforces;
        ``fallback`` degrades a dispatch that failed by an injected fault,
        a corrupt output or its deadline to the safe plan (a kernel or plan
        error fails its tickets whatever the knob);
        ``canary``/``canary_batch``/``canary_slowdown`` gate ``hot_swap``
        candidates; ``auto_rollback`` consecutive never-succeeded failures
        of a fresh generation revert it (0 disables); ``rollback_history``
        bounds the undo ring; ``breaker_*`` configure the per-backend
        circuit breakers; ``faults`` injects a deterministic fault plan into
        every plan execution, canary batch and probe; ``bucket_cost_model``
        fits a per-bucket scale head from served traffic; ``probe_rate`` >
        0 allows that many single-layer probes a second per state;
        ``frontend_procs`` intake processes (``frontend()``, which needs
        ``workers`` >= 1) share ``frontend_slots`` slabs per pow2 bucket."""
        self.max_batch = max_batch
        self.latency_budget_ms = latency_budget_ms
        self.max_wait_ms = max_wait_ms
        self.queue_depth = queue_depth
        self.max_inflight = max_inflight
        self.device = torch.device(device)
        self.exec_deadline_s = (exec_deadline_ms * 1e-3
                                if exec_deadline_ms else None)
        self.fallback = fallback
        self.canary_default = canary
        self.canary_batch = max(int(canary_batch), 1)
        self.canary_slowdown = canary_slowdown
        self.auto_rollback = int(auto_rollback)
        self.rollback_history = max(int(rollback_history), 0)
        self._breaker_kw = dict(failures=breaker_failures,
                                window=breaker_window, rate=breaker_rate,
                                cooldown_s=breaker_cooldown_ms * 1e-3,
                                probes=breaker_probes)
        self._faults = faults
        self._clock = clock if clock is not None else monotonic
        self._nets: Dict[str, _NetState] = {}
        # logical net -> state keys. A plain register keeps key == net;
        # register(backend=...) keys the state "net#backend" and submit()
        # routes each request to the predicted-cheapest member
        self._routes: Dict[str, List[str]] = {}
        self._order: List[str] = []            # round-robin claim fairness
        self._rr = 0
        self._cond = threading.Condition()
        self._drift = DriftMonitor(threshold=drift_threshold,
                                   alpha=drift_alpha,
                                   calib_obs=drift_calib_obs,
                                   obs_cap=obs_cap,
                                   clock=self._clock)
        self._recalibrate = recalibrate
        self._recal_served = _accepts_served(recalibrate)
        self._recal_threads: List[threading.Thread] = []
        self._pool = WorkerPool(self, workers) if workers > 0 else None
        self.bucket_cost_model = bool(bucket_cost_model)
        if frontend_procs > 0 and workers < 1:
            raise ValueError(
                "frontend_procs requires workers >= 1: intake processes "
                "feed pre-assembled batches to the worker pool; pump mode "
                "has no concurrent consumer")
        self.frontend_procs = int(frontend_procs)
        self.frontend_slots = int(frontend_slots)
        self._frontend = None
        # page-locked slab segments, (address, bytes): a batch whose bytes
        # lie inside one uploads with one asynchronous copy
        self._pinned: List[Tuple[int, int]] = []
        if probe_rate < 0:
            raise ValueError(f"probe_rate must be >= 0, got {probe_rate}")
        self.probe_rate = float(probe_rate)
        # per-generation bound plan handles, (id(opt), id(weights)) ->
        # (opt, weights, {input shape: bound plan}); opt/weights are pinned
        # in the value so a live key can never alias recycled ids; entries
        # drop when the generation retires
        self._plan_handles: Dict[Tuple[int, int],
                                 Tuple[OptimisedNetwork, Dict, Dict]] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "OptimisedServer":
        if self._pool is not None:
            self._pool.start()
        return self

    def frontend(self, procs: Optional[int] = None, *,
                 slots: Optional[int] = None):
        """The process front end, created and started on first use — intake
        processes assembling request batches in shared-memory slabs
        (``frontend.ProcessFrontend``). Register every network first: the
        front end sizes its slab pools from the registered image shapes and
        batch caps."""
        if self._frontend is None:
            from repro_torch.service.serving.frontend import ProcessFrontend
            n = procs if procs is not None else self.frontend_procs
            if n < 1:
                raise ValueError("frontend requires procs >= 1 (pass procs= "
                                 "or construct with frontend_procs=)")
            if self._pool is None:
                raise ValueError(
                    "the process front end requires workers >= 1: intake "
                    "processes feed pre-assembled batches to the worker "
                    "pool; pump mode has no concurrent consumer")
            self.start()
            fe = ProcessFrontend(
                self, n,
                slots=slots if slots is not None else self.frontend_slots)
            fe.start()
            self._frontend = fe
        return self._frontend

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the front end's intake, drain queued tickets, stop workers,
        then unpin and close the slabs (no dispatch reads them any more),
        and join pending recalibrations."""
        fe, self._frontend = self._frontend, None
        if fe is not None:
            fe.stop_intake(timeout)
        try:
            if self._pool is not None:
                self._pool.stop(timeout)
        finally:
            if fe is not None:
                fe.close()
        with self._cond:
            pending = list(self._recal_threads)
        for t in pending:
            t.join(timeout)
        with self._cond:
            self._recal_threads = [t for t in self._recal_threads
                                   if t.is_alive()]

    def wake_all(self) -> None:
        """Wake every thread blocked in ``claim_blocking`` (WorkerPool stop)."""
        with self._cond:
            self._cond.notify_all()

    def __enter__(self) -> "OptimisedServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _sync_device(self) -> None:
        """Finish every stream's work on the server's device: what a thread
        made there (weights, warmed plan handles, a canary's caches) is
        complete before another thread's stream may read it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- page-locked slabs (the process front end) -------------------------
    def _pin_slabs(self, pools) -> None:
        """Page-lock every data segment of the front end's slab ``pools``
        on a cuda server (``cudaHostRegister``), so a slab batch reaches
        the card in one asynchronous copy. A failed register unpins what
        was pinned and raises: the front end never falls back quietly to
        pageable copies. Nothing to do on the CPU."""
        if self.device.type != "cuda":
            return
        cudart = torch.cuda.cudart()
        for pool in pools:
            for addr, nbytes in pool.segments():
                rc = int(cudart.cudaHostRegister(addr, nbytes, 0))
                if rc != 0:
                    self._unpin_slabs()
                    raise RuntimeError(
                        f"cudaHostRegister of a {nbytes}-byte slab segment "
                        f"failed (cudaError {rc})")
                with self._cond:
                    self._pinned.append((addr, nbytes))

    def _unpin_slabs(self) -> None:
        """Unregister every pinned segment, after a device sync (no copy
        from one is still in flight). Called before the segments close."""
        with self._cond:
            pinned, self._pinned = self._pinned, []
        if not pinned:
            return
        torch.cuda.synchronize(self.device)
        cudart = torch.cuda.cudart()
        failed = [(addr, rc) for addr, _ in pinned
                  if (rc := int(cudart.cudaHostUnregister(addr))) != 0]
        if failed:
            raise RuntimeError(f"cudaHostUnregister failed for "
                               f"{len(failed)} slab segment(s): {failed}")

    def _is_pinned(self, xs: np.ndarray) -> bool:
        """Whether ``xs``'s bytes lie inside one page-locked segment."""
        lo = xs.__array_interface__["data"][0]
        return any(a <= lo and lo + xs.nbytes <= a + n
                   for a, n in self._pinned)

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

    def _bucket_batch_cap_locked(self, state: _NetState) -> int:
        """Batch-shape-aware batch cap (DESIGN.md §12.3): the largest pow2
        bucket whose *bucket-scaled* predicted execution fits the backend's
        latency budget — ``pred × scale(b) × b <= budget``. Falls back to
        the linear ``_batch_cap`` until a head is fitted."""
        pred = state.queue.predicted_s
        head = state.bucket_head if self.bucket_cost_model else None
        if head is None or not (np.isfinite(pred) and pred > 0):
            return self._batch_cap(pred if pred > 0
                                   else state.opt.predicted_cost_s,
                                   state.latency_budget_ms)
        budget_s = self._budget_s(state.latency_budget_ms)
        cap, b = 1, 1
        top = pow2_floor(self.max_batch)
        while b <= top:
            if pred * head.scale(b) * b <= budget_s:
                cap = b
            b *= 2
        return cap

    def _per_image_locked(self, state: _NetState,
                          bucket: Optional[int] = None, *,
                          observed_first: bool = False) -> float:
        """Predicted per-image cost of this backend, optionally conditioned
        on the pow2 ``bucket`` through the fitted scale head. 0.0 when no
        usable base exists (modelless entry, nothing served)."""
        per = 0.0
        if observed_first and state.images:
            per = state.busy_s / state.images
        if not (np.isfinite(per) and per > 0):
            per = state.queue.predicted_s
        if not (np.isfinite(per) and per > 0) and state.images:
            per = state.busy_s / state.images
        if not (np.isfinite(per) and per > 0):
            return 0.0
        head = state.bucket_head if self.bucket_cost_model else None
        if head is not None and bucket is not None:
            per *= head.scale(bucket)
        return per

    def predict_per_image(self, net: str,
                          bucket: Optional[int] = None) -> float:
        """Model-predicted per-image cost for ``net`` (a state key or an
        unambiguous logical name), batch-shape-conditioned when ``bucket``
        is given and a scale head has been fitted from served traffic."""
        with self._cond:
            key = self._resolve_key_locked(net)
            return self._per_image_locked(self._nets[key], bucket)

    def _device_weights(self, opt: OptimisedNetwork,
                        weights: Optional[Dict]) -> Dict[int, torch.Tensor]:
        """Weights (numpy arrays or tensors, reference layouts; default
        ``make_weights``) as float32 tensors on the server's device."""
        if weights is None:
            return make_weights(opt.spec, device=self.device)
        return {int(k): (v if isinstance(v, torch.Tensor)
                         else torch.from_numpy(np.array(v, np.float32))
                         ).to(self.device, torch.float32).contiguous()
                for k, v in weights.items()}

    def register(self, opt: OptimisedNetwork, *, backend: Optional[str] = None,
                 weights: Optional[Dict] = None,
                 latency_budget_ms: Optional[float] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 max_inflight: Optional[int] = None) -> _NetState:
        """Register an optimised network for serving. ``weights`` move to
        the server's device once, here. Per-network overrides fall back to
        the server-wide knobs. Re-registering a key replaces it and rejects
        its queued tickets.

        ``backend`` names this registration as one backend of the logical
        network ``opt.net``: the state is keyed ``"net#backend"``, gets its
        own queue and in-flight limit, and ``submit(net, ...)`` routes each
        request to the predicted-cheapest registered backend. Every backend
        of one logical network must serve the same topology."""
        key = opt.net if backend is None else f"{opt.net}#{backend}"
        pred = opt.predicted_cost_s
        queue = NetQueue(
            depth=queue_depth if queue_depth is not None else self.queue_depth,
            batch_cap=self._batch_cap(pred, latency_budget_ms),
            max_wait_s=(max_wait_ms if max_wait_ms is not None
                        else self.max_wait_ms) * 1e-3,
            budget_s=self._budget_s(latency_budget_ms),
            predicted_s=pred if np.isfinite(pred) and pred > 0 else 0.0)
        state = _NetState(
            opt=opt,
            weights=self._device_weights(opt, weights),
            queue=queue,
            max_inflight=(max_inflight if max_inflight is not None
                          else self.max_inflight),
            latency_budget_ms=latency_budget_ms,
            logical=opt.net, backend=backend,
            breaker=CircuitBreaker(**self._breaker_kw),
            history=deque(maxlen=self.rollback_history))
        self._sync_device()
        with self._cond:
            route = self._routes.setdefault(opt.net, [])
            for k in route:
                if k != key and self._nets[k].opt.spec.name != opt.spec.name:
                    raise ValueError(
                        f"backend {backend!r} of {opt.net!r} serves topology "
                        f"{opt.spec.name!r}, but the route already serves "
                        f"{self._nets[k].opt.spec.name!r}")
            old = self._nets.get(key)
            if old is None:
                self._order.append(key)
                route.append(key)
            else:
                # replacing a live registration must not strand its queued
                # tickets, and must not reuse its generation numbers
                stranded, sgroups = old.queue.drain()
                state.generation = old.generation + 1
            self._nets[key] = state
            if old is not None:
                self._evict_retired_locked(old.opt)
        if old is not None:
            self._reject(stranded, sgroups,
                         f"rejected: {key!r} was re-registered")
        self._precompile_plans(opt, state.weights)
        self._drift.reset(key, state.generation, layers=layer_profile(opt))
        self.start()
        return state

    def unregister_backend(self, net: str, backend: str) -> bool:
        """Remove one backend of ``net`` from the route. Its queued tickets
        are rejected; an in-flight batch keeps its own state reference and
        completes normally. False when no such backend is registered."""
        key = f"{net}#{backend}"
        with self._cond:
            state = self._nets.pop(key, None)
            if state is None:
                return False
            if key in self._order:
                self._order.remove(key)
                self._rr = 0
            route = self._routes.get(net)
            if route and key in route:
                route.remove(key)
            stranded, sgroups = state.queue.drain()
            self._evict_retired_locked(state.opt)
            self._cond.notify_all()
        self._reject(stranded, sgroups, f"rejected: backend {backend!r} of "
                                        f"{net!r} was unregistered")
        return True

    def _reject(self, tickets: List[Ticket], groups: List[BatchGroup],
                err: str) -> None:
        """Finish drained tickets and groups rejected; each group's
        ``on_done`` fires so the front end recycles its slab."""
        for t in tickets:
            t.finish(error=err, rejected=True)
        for g in groups:
            for t in g.tickets:
                t.finish(error=err, rejected=True)
            self._notify_done(g, None)

    def hot_swap(self, net: str, opt: OptimisedNetwork, *,
                 latency_budget_ms: Optional[float] = None,
                 expect_generation: Optional[int] = None,
                 canary: Optional[bool] = None) -> bool:
        """Atomically replace ``net``'s assignment (platform recalibrated).
        Weights are kept; already-claimed batches finish on the old plan.
        Drift stats reset: the new model predicts on a new scale.
        ``expect_generation`` makes the swap conditional (returns False when
        it fails). ``net`` may be a state key (``"net#backend"``).

        ``canary`` (None = the server-wide default) gates the swap behind a
        canary batch (DESIGN.md §11.4): the candidate serves a deterministic
        synthetic batch *before* commit and is rejected if it raises,
        corrupts output, or runs slower than ``canary_slowdown`` × the live
        generation's observed (else predicted) per-image cost. The committed
        swap pushes the outgoing generation onto the rollback ring."""
        if canary is None:
            canary = self.canary_default
        if not canary:
            self._sync_device()
        with self._cond:
            net = self._resolve_key_locked(net)
            state = self._nets[net]
            if opt.spec.name != state.opt.spec.name:
                raise ValueError(f"hot_swap topology mismatch: {opt.spec.name!r} "
                                 f"vs {state.opt.spec.name!r}")
            if (expect_generation is not None
                    and state.generation != expect_generation):
                return False
            if not canary:
                self._commit_swap_locked(state, opt,
                                         latency_budget_ms=latency_budget_ms)
                generation = state.generation
            else:
                before = state.generation
                # the gate compares per-image cost AT THE CANARY BUCKET
                baseline = self._per_image_locked(
                    state, pow2_ceil(self.canary_batch),
                    observed_first=True)
        if not canary:
            self._drift.reset(net, generation, layers=layer_profile(opt))
            self._precompile_plans(opt, state.weights)
            return True
        # canary outside the lock: the live generation keeps serving while
        # the candidate proves itself (under the CANDIDATE generation)
        if not self._canary_gate(net, state, opt, before + 1, baseline):
            return False
        self._sync_device()
        with self._cond:
            if (self._nets.get(net) is not state
                    or state.generation != before):
                return False       # re-registered or swapped while canarying
            self._commit_swap_locked(state, opt,
                                     latency_budget_ms=latency_budget_ms)
            generation = state.generation
        self._drift.reset(net, generation, layers=layer_profile(opt))
        self._precompile_plans(opt, state.weights)
        return True

    def _commit_swap_locked(self, state: _NetState, opt: OptimisedNetwork, *,
                            latency_budget_ms: Optional[float] = None,
                            remember: bool = True) -> None:
        """The swap itself (caller holds the lock). ``remember`` pushes the
        outgoing (generation, opt) onto the rollback ring — rollbacks pass
        False so the reverted-FROM generation cannot be rolled back INTO."""
        if remember and self.rollback_history > 0:
            state.history.append((state.generation, state.opt))
        if latency_budget_ms is not None:
            state.latency_budget_ms = latency_budget_ms
        outgoing = state.opt
        state.opt = opt
        # in-flight batches hold their own opt/weights refs and bind through
        # compile_plan, so eviction never breaks an already-claimed dispatch
        self._evict_retired_locked(outgoing)
        state.fallback_asg = None      # rebuild lazily for the new opt
        pred = opt.predicted_cost_s
        state.queue.batch_cap = self._batch_cap(pred,
                                                state.latency_budget_ms)
        state.queue.budget_s = self._budget_s(state.latency_budget_ms)
        state.queue.predicted_s = (pred if np.isfinite(pred) and pred > 0
                                   else 0.0)
        state.queue.window_scale = 1.0     # re-learn under the new model
        state.bucket_head = None
        state.bucket_obs_at_fit = 0
        state.queue.bucket_scale = None
        state.generation += 1
        state.gen_bad_streak = 0           # unproven: auto-rollback is armed
        state.bucket_ready = {k: v for k, v in state.bucket_ready.items()
                              if k[0] >= state.generation}
        self._cond.notify_all()

    def _canary_gate(self, key: str, state: _NetState, opt: OptimisedNetwork,
                     generation: int, baseline: float) -> bool:
        """Serve one deterministic canary batch on the candidate, pre-commit
        (DESIGN.md §11.4). Two executions: the first warms (or cache-hits)
        the plan, the second is the timed verdict. Per-image cost divides by
        the real row count, not the pow2 bucket."""
        take = self.canary_batch
        b = pow2_ceil(take)
        n0 = opt.spec.nodes[0]
        rng = np.random.default_rng(generation)    # deterministic inputs
        xs = rng.standard_normal((b, n0.c, n0.im, n0.im)).astype(np.float32)
        reason = None
        try:
            self._run_faulted(key, generation, opt, xs, state.weights)
            t0 = self._clock()
            out = self._run_faulted(key, generation, opt, xs, state.weights)
            t1 = self._clock()
            validate_output(out, b)
            per_image = (t1 - t0) / take
            if (np.isfinite(baseline) and baseline > 0
                    and per_image > self.canary_slowdown * baseline):
                reason = (f"canary slowdown: {per_image * 1e3:.3f} ms/img vs "
                          f"baseline {baseline * 1e3:.3f} ms/img "
                          f"(gate {self.canary_slowdown:g}x)")
        except Exception as e:
            reason = f"canary failed: {e}"
        if reason is None:
            return True
        with self._cond:
            state.canary_rejected += 1
            state.last_canary = reason
        self._drift.record_failure(key, generation, "canary")
        return False

    # -- rollback ----------------------------------------------------------
    def rollback(self, net: str) -> bool:
        """Revert ``net`` (a state key for routed networks) to the previous
        generation's assignment from the rollback ring. False when there is
        no history to revert to."""
        return self._rollback(net, expect_generation=None)

    def _rollback(self, net: str,
                  expect_generation: Optional[int]) -> bool:
        self._sync_device()
        with self._cond:
            try:
                key = self._resolve_key_locked(net)
            except KeyError:
                return False
            state = self._nets[key]
            if (expect_generation is not None
                    and state.generation != expect_generation):
                return False       # a newer swap already replaced the bad one
            if not state.history:
                return False
            bad_generation = state.generation
            _old_gen, old_opt = state.history.pop()
            self._commit_swap_locked(state, old_opt, remember=False)
            state.rollbacks += 1
            generation = state.generation
        self._drift.record_failure(key, bad_generation, "rollback")
        self._drift.reset(key, generation, layers=layer_profile(old_opt))
        self._precompile_plans(old_opt, state.weights)
        return True

    # -- request path ------------------------------------------------------
    def _route_keys_locked(self, net: str) -> List[str]:
        """State keys a request for ``net`` may land on: the exact state
        key when it exists, else the logical net's live route."""
        if net in self._nets:
            return [net]
        keys = [k for k in self._routes.get(net, ()) if k in self._nets]
        if not keys:
            raise KeyError(f"network {net!r} not registered")
        return keys

    def _resolve_key_locked(self, net: str) -> str:
        """One state key for ``net``; routed networks must name the backend
        explicitly (``"net#backend"``) when more than one is registered."""
        keys = self._route_keys_locked(net)
        if len(keys) > 1:
            raise KeyError(f"{net!r} has backends "
                           f"{[self._nets[k].backend for k in keys]}; "
                           f"address one as 'net#backend'")
        return keys[0]

    def _route_score_locked(self, state: _NetState) -> float:
        """Predicted cost of sending ONE MORE image to this backend: its
        per-image cost (observed when it has served, else predicted), at
        the bucket its next dispatch would run, times its backlog."""
        backlog = state.queue.backlog_images(state.inflight)
        bucket = pow2_ceil(max(min(backlog + 1,
                                   max(state.queue.batch_cap, 1)), 1))
        per_image = self._per_image_locked(state, bucket,
                                           observed_first=True)
        if not (np.isfinite(per_image) and per_image > 0):
            per_image = 1e-6           # modelless entry: load-balance only
        return per_image * (backlog + 1)

    def submit(self, net: str, x: np.ndarray) -> Ticket:
        """Enqueue one request (the ticket owns a float32 copy of ``x``).
        The returned ticket is already finished (and ``rejected``) when the
        network's queue is full — backpressure instead of unbounded memory.

        Routed networks: the request goes to the backend with the cheapest
        predicted marginal cost, spilling to the next-cheapest on
        backpressure; backends whose circuit breaker is open are skipped (a
        half-open breaker admits up to its probe quota). When EVERY breaker
        refuses, the full route is used anyway."""
        x = np.array(x, dtype=np.float32)
        with self._cond:
            keys = self._route_keys_locked(net)
            spec = self._nets[keys[0]].opt.spec
            n0 = spec.nodes[source_nodes(spec)[0]]
            if x.shape != (n0.c, n0.im, n0.im):
                raise ValueError(f"{net!r} expects one ({n0.c}, {n0.im}, "
                                 f"{n0.im}) image per request, got {x.shape}")
            granted: List[str] = []
            if len(keys) > 1:       # plain registrations skip the gate/scorer
                now = self._clock()
                allowed = []
                for k in keys:
                    if self._nets[k].breaker.allow(now):
                        allowed.append(k)
                        granted.append(k)
                keys = allowed if allowed else keys
                keys.sort(key=lambda k:
                          self._route_score_locked(self._nets[k]))
            t = Ticket(net=keys[0], x=x, submitted_s=self._clock(),
                       clock=self._clock)
            pushed = None
            for k in keys:
                t.net = k
                if self._nets[k].queue.push(t):
                    pushed = k
                    break
            # probe slots granted to backends the ticket did NOT land on are
            # returned
            for k in granted:
                if k != pushed:
                    self._nets[k].breaker.cancel_probe()
            if pushed is not None:
                self._cond.notify()
                return t
            self._nets[keys[0]].rejected += 1
            t.finish(error=f"rejected: every backend of {net!r} at queue "
                           f"depth (backpressure)", rejected=True)
        return t

    def _notify_done(self, holder, out: Optional[np.ndarray]) -> None:
        """Fire a group/batch ``on_done`` exactly once (the executing
        worker's ``finally``, the supervisor's ``abandon``, and a drain all
        converge here — the callback swap under the lock picks one winner).
        ``out`` is the primary plan's padded output when every ticket was
        served by it, else None (results travel per ticket)."""
        with self._cond:
            cb, holder.on_done = holder.on_done, None
        if cb is None:
            return
        try:
            cb(holder.tickets, out)
        except Exception:
            pass                       # front-end delivery is best-effort

    def _submit_group(self, net: str, xs: np.ndarray, rows: int, *,
                      handle=None, on_done: Optional[Callable] = None
                      ) -> BatchGroup:
        """Enqueue one pre-assembled slab batch from the process front end:
        ``xs`` is the pow2-padded batch (a zero-copy shared-memory view),
        ``rows`` of it real. Routing mirrors ``submit`` — breaker-gated,
        cheapest-predicted-first, spilling on backpressure, whole-group —
        so the fault-tolerance contracts hold unchanged for slab
        dispatches. When every candidate queue is full the group is
        rejected whole: tickets finish rejected and ``on_done`` fires so
        the front end recycles the slab."""
        now = self._clock()
        tickets = [Ticket(net=net, x=xs[i], slab=handle, row=i,
                          submitted_s=now, clock=self._clock)
                   for i in range(rows)]
        g = BatchGroup(tickets=tickets, xs=xs, on_done=on_done)
        err = None
        with self._cond:
            try:
                keys = self._route_keys_locked(net)
            except KeyError as e:
                keys, err = [], str(e)
            granted: List[str] = []
            if len(keys) > 1:
                allowed = []
                for k in keys:
                    if self._nets[k].breaker.allow(now):
                        allowed.append(k)
                        granted.append(k)
                keys = allowed if allowed else keys
                keys.sort(key=lambda k:
                          self._route_score_locked(self._nets[k]))
            pushed = None
            for k in keys:
                for t in tickets:
                    t.net = k
                if self._nets[k].queue.push_group(g):
                    pushed = k
                    break
            for k in granted:
                if k != pushed:
                    self._nets[k].breaker.cancel_probe()
            if pushed is not None:
                self._cond.notify()
                return g
            if keys:
                self._nets[keys[0]].rejected += len(tickets)
                err = (f"rejected: every backend of {net!r} at queue "
                       f"depth (backpressure)")
        for t in tickets:
            t.finish(error=err, rejected=True)
        self._notify_done(g, None)
        return g

    # -- scheduling --------------------------------------------------------
    def _claim_locked(self, now: float, *, drain: bool = False) -> Optional[_Batch]:
        """Pop the next dispatchable batch (round-robin across networks),
        honouring in-flight limits and batch windows. Caller holds the lock."""
        n = len(self._order)
        for k in range(n):
            name = self._order[(self._rr + k) % n]
            state = self._nets[name]
            if state.inflight >= state.max_inflight:
                continue
            if not state.queue.ready(now, drain=drain):
                continue
            if state.queue.group_ready():
                # pre-assembled slab batch: dispatch whole, payload already
                # padded in shared memory (its window ran in the intake)
                group = state.queue.take_group()
                tickets, gxs, gdone = group.tickets, group.xs, group.on_done
            else:
                tickets = state.queue.take(state.queue.batch_cap)
                gxs = gdone = None
            state.inflight += 1
            t_claim = self._clock()
            for t in tickets:
                t.dispatched_s = t_claim
                state.waits.append(t.queue_wait_s)
            scale = self._drift.observe_wait(name, state.generation,
                                             tickets[0].queue_wait_s,
                                             state.queue.budget_s)
            if scale is not None:
                state.queue.window_scale = scale
            self._rr = (self._rr + k + 1) % n
            return _Batch(net=name, tickets=tickets,
                          generation=state.generation, state=state,
                          opt=state.opt, weights=state.weights,
                          claimed_s=t_claim, xs=gxs, on_done=gdone)
        return None

    def claim_blocking(self, stop_event: threading.Event) -> Optional[_Batch]:
        """Worker-pool entry: block until a batch is dispatchable. During
        shutdown (``stop_event`` set) windows are ignored so queued tickets
        drain; returns None once stopping and every queue is empty."""
        idle = 0
        with self._cond:
            while True:
                stopping = stop_event.is_set()
                batch = self._claim_locked(self._clock(), drain=stopping)
                if batch is not None:
                    return batch
                now = self._clock()
                deadlines = [s.queue.next_deadline()
                             for s in self._nets.values()
                             if len(s.queue) and s.inflight < s.max_inflight]
                deadlines = [d for d in deadlines if d is not None]
                if stopping:
                    if not any(len(s.queue) for s in self._nets.values()):
                        return None
                    timeout = 0.01     # draining: re-check promptly
                elif deadlines:
                    gap = min(deadlines) - now
                    if gap <= 0.0:
                        # window expired yet the claim was refused (in-flight
                        # cap, a competing pump won): geometric backoff
                        timeout = min(1e-4 * (1 << min(idle, 7)), 0.01)
                        idle += 1
                    else:
                        idle = 0
                        timeout = gap + 1e-4
                else:
                    idle = 0
                    timeout = None     # idle: sleep until notified
                self._cond.wait(timeout)

    # -- execution ---------------------------------------------------------
    @staticmethod
    def _bind_plan(opt: OptimisedNetwork, weights: Dict[int, torch.Tensor],
                   shape: Tuple[int, ...]) -> Callable:
        """One bound dispatch handle: the compiled plan for ``shape`` with
        the generation's device weights closed over, returning the served
        sink only."""
        plan = compile_plan(opt.spec, opt.assignment, shape)
        src, sink, fn = plan.sources[0], plan.sinks[-1], plan.fn
        return lambda a: fn({src: a}, weights)[sink]

    def _precompile_plans(self, opt: OptimisedNetwork,
                          weights: Dict[int, torch.Tensor]) -> None:
        """Bind AND WARM one plan handle per pow2 bucket up to
        ``max_batch`` (single-input specs), on the calling thread — each
        runs once on zeros, the device is synchronised, then the handle is
        published (smallest buckets first). Dispatches that arrive before a
        bucket is warm bind through the global plan cache. A warm-up that
        fails publishes the buckets warmed so far and raises: a plan whose
        kernels do not build or launch is never registered quietly (the
        reference goes on)."""
        def publish() -> None:
            # skip (and drop) if the generation retired while warming
            with self._cond:
                if any(st.opt is opt for st in self._nets.values()):
                    self._plan_handles[(id(opt), id(weights))] = (
                        opt, weights, dict(handles))
                else:
                    self._plan_handles.pop((id(opt), id(weights)), None)

        handles: Dict[Tuple[int, ...], Callable] = {}
        try:
            srcs = source_nodes(opt.spec)
            if len(srcs) == 1:
                n0 = opt.spec.nodes[srcs[0]]
                b, cap = 1, pow2_ceil(max(int(self.max_batch), 1))
                while b <= cap:
                    shape = (b, n0.c, n0.im, n0.im)
                    bound = self._bind_plan(opt, weights, shape)
                    bound(torch.zeros(shape, device=self.device))
                    self._sync_device()
                    handles[shape] = bound
                    publish()
                    b *= 2
        except Exception:
            publish()
            raise

    def _evict_retired_locked(self, old_opt: OptimisedNetwork) -> int:
        """Drop compiled-plan state for a retired generation: its bound
        handles, its global plan-cache entries, and cached primitive
        callables no live registration serves any more. Skipped (handles
        aside) when another live backend serves the identical (spec,
        assignment) pair. Caller holds the lock."""
        for k in [k for k, v in self._plan_handles.items()
                  if v[0] is old_opt]:
            del self._plan_handles[k]
        for st in self._nets.values():
            if (st.opt is not old_opt
                    and st.opt.spec.name == old_opt.spec.name
                    and st.opt.assignment == old_opt.assignment):
                return 0
        n = evict_plans(old_opt.spec, old_opt.assignment)
        live: set = set()
        for st in self._nets.values():
            live.update(st.opt.assignment.values())
        evict_prim_entries(set(old_opt.assignment.values()) - live)
        return n

    def _run_plan(self, opt: OptimisedNetwork, xs: np.ndarray,
                  weights: Dict) -> np.ndarray:
        """Execute one padded batch: copy it to the device, run the bound
        plan for its shape (a shape or generation without a warm handle
        binds through the global plan cache) and copy the sink back on the
        calling thread's stream. A batch in a page-locked slab goes up in
        one asynchronous copy on that stream, which the closing copy back
        waits for; any other batch takes the pageable copy. Isolated so
        tests can wrap it."""
        ent = self._plan_handles.get((id(opt), id(weights)))
        bound = None
        if ent is not None and ent[0] is opt and ent[1] is weights:
            bound = ent[2].get(xs.shape)
        if bound is None:
            bound = self._bind_plan(opt, weights, xs.shape)
        x = torch.from_numpy(np.ascontiguousarray(xs))
        x = x.to(self.device, non_blocking=self._is_pinned(xs))
        return bound(x).cpu().numpy()

    def _run_faulted(self, key: str, generation: int, opt: OptimisedNetwork,
                     xs: np.ndarray, weights: Dict) -> np.ndarray:
        """One plan execution, through the fault injector when one is
        configured — the single choke point of dispatches and canaries."""
        if self._faults is not None:
            return self._faults.run(key, generation,
                                    lambda: self._run_plan(opt, xs, weights))
        return self._run_plan(opt, xs, weights)

    def _attempt(self, batch: _Batch, xs: np.ndarray, b: int) -> np.ndarray:
        """One primary execution attempt, output-validated (a silently
        corrupt result is a failure, not a delivery)."""
        out = self._run_faulted(batch.net, batch.generation, batch.opt, xs,
                                batch.weights)
        return validate_output(out, b)

    def _settle(self, batch: _Batch, *, primary_ok: bool, take: int, b: int,
                t0: float, t1: float) -> Tuple[bool, bool, bool]:
        """Release one claim exactly once: the in-flight slot, serving
        counters, first-execution bookkeeping, and the per-generation
        failure streak. Idempotent; the first caller wins. Returns
        ``(settled_now, clean_timing, rollback_due)``."""
        state = batch.state
        clean = False
        roll = False
        with self._cond:
            if batch.settled:
                return False, False, False
            batch.settled = True
            state.inflight -= 1
            if primary_ok:
                state.dispatches += 1
                state.images += take
                state.padded += b - take
                state.busy_s += t1 - t0
                ready_at = state.bucket_ready.get((batch.generation, b))
                if ready_at is None:
                    state.bucket_ready[(batch.generation, b)] = t1
                else:
                    clean = t0 >= ready_at
                if state.generation == batch.generation:
                    state.gen_bad_streak = -1   # proven: never auto-rolled
            else:
                state.failed_dispatches += 1
                if (state.generation == batch.generation
                        and state.gen_bad_streak >= 0):
                    state.gen_bad_streak += 1
                    # == (not >=): concurrent failing batches of the same
                    # generation must trigger ONE rollback, not one each
                    roll = (self.auto_rollback > 0
                            and state.gen_bad_streak == self.auto_rollback
                            and len(state.history) > 0)
            self._cond.notify_all()
        return True, clean, roll

    def _fallback_asg(self, state: _NetState) -> Optional[Dict[int, str]]:
        """The state's safe-plan assignment, built lazily (``{}`` caches an
        unbuildable spec)."""
        if state.fallback_asg is None:
            try:
                asg = safe_assignment(state.opt.spec)
            except Exception:
                asg = {}
            with self._cond:
                state.fallback_asg = asg
        return state.fallback_asg or None

    def _fallback_forward(self, opt: OptimisedNetwork, asg: Dict[int, str],
                          weights: Dict, x: np.ndarray) -> torch.Tensor:
        """One image through the safe plan on the interpreted executor, on
        the server's device (plain torch: no hand-written kernel). Returns
        the served sink's tensor, on the device."""
        rep = execute_reference(opt.spec, asg, weights=weights, x=x,
                                compiled=False, device=self.device)
        return rep.outputs[sink_nodes(opt.spec)[-1]]

    def _run_fallback(self, batch: _Batch, err: str) -> bool:
        """Degrade a failed dispatch to the safe plan (DESIGN.md §11.1):
        each ticket is served individually through the interpreted executor
        — independent of the compiled machinery that just failed. One
        pathological input fails its own ticket, not its batch peers.
        Returns True when the batch's tickets were all settled here."""
        state = batch.state
        asg = self._fallback_asg(state)
        if asg is None:
            return False
        served = 0
        for t in batch.tickets:
            if t.done:
                continue               # already settled (late rescue race)
            try:
                out = self._fallback_forward(batch.opt, asg, batch.weights,
                                             t.x).cpu().numpy()
                if t.finish(result=out, degraded=True):
                    served += 1
            except Exception as e:
                t.finish(error=f"{err}; fallback also failed: {e}")
        with self._cond:
            if served:
                state.fallback_dispatches += 1
                state.fallback_images += served
        return True

    def _assemble(self, state: _NetState, tickets: List[Ticket],
                  b: int) -> np.ndarray:
        """The pow2-padded batch: rows in ticket order, the last row
        repeated into the pad — in the state's reused bucket buffer when at
        most one batch of the state is in flight."""
        take = len(tickets)
        if b == 1:
            return np.asarray(tickets[0].x)[None]
        if state.max_inflight == 1:
            row = np.asarray(tickets[0].x)
            xs = state.pad_scratch.get(b)
            if (xs is None or xs.shape[1:] != row.shape
                    or xs.dtype != row.dtype):
                xs = np.empty((b,) + row.shape, row.dtype)
                state.pad_scratch[b] = xs
            for j, t in enumerate(tickets):
                xs[j] = t.x
            if b != take:
                xs[take:] = xs[take - 1]
            return xs
        xs = np.stack([t.x for t in tickets])
        if b != take:
            pad = np.broadcast_to(xs[-1:], (b - take,) + xs.shape[1:])
            xs = np.concatenate([xs, pad])
        return xs

    def execute(self, batch: _Batch) -> None:
        """Run one claimed batch to completion: assemble and pad to the pow2
        bucket, execute the compiled plan (one retry on failure, then
        degrade to the safe plan when the failure is ``DEGRADABLE``, else
        fail the tickets with the error), deliver results, feed the breaker
        / failure ledger / drift monitor, release the in-flight slot. Never
        raises and never leaks: the ``finally`` settle guarantees the slot
        and every ticket are released."""
        state = batch.state
        tickets = batch.tickets
        take = len(tickets)
        b = batch.xs.shape[0] if batch.xs is not None else pow2_ceil(take)
        err: Optional[str] = None
        kind: Optional[str] = None
        out = None
        abandoned = False
        t0 = t1 = self._clock()
        try:
            try:
                # a slab batch is already assembled, padded and pow2-bucketed
                # in shared memory: no copy here
                xs = (batch.xs if batch.xs is not None
                      else self._assemble(state, tickets, b))
                t0 = self._clock()
                try:
                    out = self._attempt(batch, xs, b)
                except Exception as e:
                    kind = classify(e)
                    with self._cond:
                        state.retries += 1
                    try:   # one retry: a transient fault costs a retry
                        out = self._attempt(batch, xs, b)
                    except Exception as e2:
                        err, kind = str(e2), classify(e2)
                t1 = self._clock()
            except Exception as e:     # batch assembly / bookkeeping failed
                err, kind = str(e), "error"
                t1 = self._clock()

            settled, clean_timing, roll = self._settle(
                batch, primary_ok=err is None, take=take, b=b, t0=t0, t1=t1)
            if not settled:
                # abandoned by the supervisor: it owns the outcome
                abandoned = True
                return
            with self._cond:
                state.breaker.record(err is None, self._clock())
            if err is None:
                for j, t in enumerate(tickets):
                    t.finish(result=out[j])
                pred = batch.opt.predicted_cost_s
                if (clean_timing and np.isfinite(pred) and pred > 0
                        and self._drift.observe(batch.net, batch.generation,
                                                (t1 - t0) / b, pred, batch=b)):
                    self._schedule_recalibration(batch.net, batch.generation)
                if clean_timing and self.bucket_cost_model:
                    self._refresh_bucket_head(batch.net, state)
                if clean_timing and self.probe_rate > 0:
                    self._maybe_probe(batch)
                return
            self._drift.record_failure(batch.net, batch.generation,
                                       kind or "error")
            if not (kind in DEGRADABLE and self.fallback
                    and self._run_fallback(batch, err)):
                for t in tickets:
                    t.finish(error=err)
            with self._cond:
                state.failed_tickets += sum(1 for t in tickets
                                            if t.error is not None)
            if roll:
                self._rollback(batch.net,
                               expect_generation=batch.generation)
        finally:
            self._settle(batch, primary_ok=False, take=take, b=b,
                         t0=t0, t1=t1)
            if not abandoned:
                for t in tickets:
                    t.finish(error=err or "internal serving error")
                # slab batches: tell the front end this batch settled (every
                # ticket finished above) so it can recycle the slab and ship
                # results; an abandoned batch's supervisor owns it
                self._notify_done(batch, out if err is None else None)

    def abandon(self, batch: _Batch, reason: str) -> None:
        """Give up on a claim whose worker hung past the execution deadline
        or died (called by the ``WorkerPool`` supervisor). Settles the batch
        (no-op if the dispatch finished first), trips the breaker/ledger,
        and rescues the tickets through the fallback plan. The zombie's own
        settle/finish attempts lose the race by construction."""
        take = len(batch.tickets)
        b = pow2_ceil(take)
        settled, _clean, roll = self._settle(batch, primary_ok=False,
                                             take=take, b=b, t0=0.0, t1=0.0)
        if not settled:
            return
        kind = "deadline" if reason == "deadline" else "died"
        with self._cond:
            batch.state.breaker.record(False, self._clock())
        self._drift.record_failure(batch.net, batch.generation, kind)
        msg = (f"abandoned: worker {reason} executing {batch.net!r} "
               f"generation {batch.generation}")
        try:
            rescued = self.fallback and self._run_fallback(batch, msg)
        except Exception:
            rescued = False
        if not rescued:
            for t in batch.tickets:
                t.finish(error=msg)
        self._notify_done(batch, None)
        if roll:
            self._rollback(batch.net, expect_generation=batch.generation)

    # -- batch-shape cost model -------------------------------------------
    def _refresh_bucket_head(self, key: str, state: _NetState) -> None:
        """Refit the per-bucket scale head from the served-traffic buffer
        once enough clean observations accumulated, then re-derive the
        queue's ``bucket_scale`` and the backend's batch cap."""
        n_obs = len(self._drift.observations(key))
        with self._cond:
            if (n_obs < BUCKET_MIN_OBS
                    or n_obs - state.bucket_obs_at_fit < BUCKET_REFRESH_EVERY):
                return
            state.bucket_obs_at_fit = n_obs
        head = self._drift.bucket_head(key, min_obs=2)
        with self._cond:
            if self._nets.get(key) is not state:
                return                 # re-registered while fitting
            state.bucket_head = head
            state.queue.bucket_scale = (head.scale if head is not None
                                        else None)
            state.queue.batch_cap = self._bucket_batch_cap_locked(state)

    # -- probe dispatches (DESIGN.md §14.4) --------------------------------
    def _maybe_probe(self, batch: _Batch) -> None:
        """Rate-limited single-layer probe after a clean dispatch, on the
        same worker thread: at most one per ``1/probe_rate`` seconds per
        state, targets round-robin over the generation's attribution
        profile. Probes run under the fault injector but never enter the
        queue, so served latency and the bucket head cannot see them."""
        state = batch.state
        interval = 1.0 / self.probe_rate
        now = self._clock()
        with self._cond:
            if (self._nets.get(batch.net) is not state
                    or state.generation != batch.generation
                    or now - state.last_probe_s < interval):
                return
            state.last_probe_s = now
            idx = state.probe_rr
            state.probe_rr += 1
        layers = self._drift.layer_profile(batch.net)
        if layers is None or not len(layers.columns):
            return
        i = idx % len(layers.columns)
        cfg = layers.feats[i]
        col = layers.columns[i]
        pred = float(layers.predicted[i])
        try:
            if self._faults is not None:
                obs = self._faults.run(batch.net, batch.generation,
                                       lambda: self._run_probe(batch.opt,
                                                               cfg, col))
            else:
                obs = self._run_probe(batch.opt, cfg, col)
            obs = float(obs)
            if not (np.isfinite(obs) and obs > 0):
                raise ValueError(f"probe measured {obs!r}")
        except ProbeUnsupported:
            return                     # column not runnable here: skip
        except Exception:
            with self._cond:
                state.probe_failures += 1
            self._drift.record_failure(batch.net, batch.generation, "probe")
            return
        if self._drift.record_probe(batch.net, batch.generation, cfg, col,
                                    obs, pred):
            with self._cond:
                state.probes += 1

    def _run_probe(self, opt: OptimisedNetwork, config, column: str) -> float:
        """Measure one (config, primitive) as the measured platform profiles
        it: ``profiler/device.py`` times ``column_callable`` (the base impl,
        or a tile column's kernel route) with ``time_callable`` — the median
        wall time to a sync of the worker's own stream of ``PROBE_REPEATS``
        calls after two warm-ups, on the server's device. Returns per-image seconds. (The
        reference times one ``run_primitive`` call, a tile column's base
        impl, on its injectable clock.)"""
        if not is_runnable(column):
            raise ProbeUnsupported(column)
        k, c, im, s, f = (int(v) for v in np.asarray(config).reshape(-1))
        return device_profiler.profile_primitive(
            column, k, c, im, s, f, repeats=PROBE_REPEATS,
            device=self.device).wall

    def poll_pool(self, store, *, host: Optional[str] = None) -> int:
        """Check the shared store for fleet drift evidence this server has
        not yet acted on (DESIGN.md §14.3): for each registered state whose
        platform fingerprint has fresh ``drift_pool`` entries from other
        hosts, schedule one background recalibration. Returns how many
        were scheduled; a faulty backend read skips the poll."""
        scheduled = 0
        with self._cond:
            items = list(self._nets.items())
        for key, state in items:
            platform = state.opt.platform
            if platform is None:
                continue
            try:
                entries = store.drift_entries(platform.pool_fingerprint(),
                                              exclude_host=host)
            except OSError:
                continue
            fresh = [m for m in entries
                     if m.get("key") not in state.pool_seen]
            if not fresh:
                continue
            with self._cond:
                if self._nets.get(key) is not state:
                    continue
                state.pool_seen.update(m.get("key") for m in fresh)
                gen = state.generation
            self._schedule_recalibration(key, gen)
            scheduled += 1
        return scheduled

    # -- drift-triggered recalibration ------------------------------------
    def served_sample(self, net: str):
        """The buffered served observations attributed to layer configs, as
        a ``PerfDataset`` ready for ``platform.calibrate(served=...)`` —
        None when nothing attributable was served (§8.5). Probe
        measurements ride along as their own single-column rows."""
        att = self._drift.attributed(net)
        pro = self._drift.probe_attributed(net)
        if att is None and pro is None:
            return None
        if att is not None:
            feats, cols, bucket_rows, info = att
        else:
            layers = self._drift.layer_profile(net)
            width = layers.feats.shape[1] if layers is not None else 5
            feats = np.empty((0, width), np.float64)
            cols, bucket_rows, info = (), [], {}
        probe_rows, probe_info = pro if pro is not None else ([], {})
        info = {**info, **probe_info}
        with self._cond:
            state = self._nets.get(net)
            platform = state.opt.platform if state is not None else None
        columns = sorted(set(cols) | {c for _, c, _ in probe_rows})
        return observations_to_dataset(
            feats, cols, bucket_rows, columns=columns,
            platform=platform.name if platform is not None else "served",
            info=info, probes=probe_rows or None)

    def _schedule_recalibration(self, net: str, generation: int) -> None:
        if self._recalibrate is None:
            return
        th = threading.Thread(target=self._recalibration_worker,
                              args=(net, generation), daemon=True,
                              name=f"recal-{net}-g{generation}")
        with self._cond:
            self._recal_threads = [t for t in self._recal_threads
                                   if t.is_alive()]
            self._recal_threads.append(th)
        th.start()

    def _recalibration_worker(self, net: str, generation: int) -> None:
        state = self._nets.get(net)
        if state is None:
            return                   # backend unregistered while scheduled
        with self._cond:
            if state.generation != generation:
                return               # swapped while we were scheduled
            opt = state.opt
        try:
            if self._recal_served:
                new_opt = self._recalibrate(opt,
                                            served=self.served_sample(net))
            else:
                new_opt = self._recalibrate(opt)
        except Exception as e:       # serving continues on the stale model
            with self._cond:
                state.last_recal_error = str(e)
            return
        # hot_swap synchronises the device before it publishes the result
        if self.hot_swap(net, new_opt, expect_generation=generation):
            with self._cond:
                state.recalibrations += 1
                state.last_recal_sample = getattr(new_opt.models,
                                                  "sample_info", None)

    def recalibrations_idle(self) -> bool:
        """True when no background recalibration is in flight (tests/CLI)."""
        with self._cond:
            self._recal_threads = [t for t in self._recal_threads
                                   if t.is_alive()]
            return not self._recal_threads

    # -- synchronous path --------------------------------------------------
    def pump(self, drain: bool = True, idle_wait_s: float = 0.0) -> int:
        """Serve queued tickets inline on the calling thread, returning the
        dispatch count. ``drain=True`` ignores batch windows (pump IS the
        arrival of serving capacity); ``drain=False`` dispatches only ready
        batches (full, or window expired against the injected clock).
        ``idle_wait_s`` > 0 blocks once, up to that long, when nothing is
        dispatchable (woken by ``submit`` or the earliest window)."""
        dispatches = 0
        waited = False
        while True:
            with self._cond:
                batch = self._claim_locked(self._clock(), drain=drain)
                if (batch is None and idle_wait_s > 0.0 and not waited
                        and dispatches == 0):
                    waited = True
                    now = self._clock()
                    deadlines = [d for d in
                                 (s.queue.next_deadline()
                                  for s in self._nets.values()
                                  if len(s.queue))
                                 if d is not None]
                    timeout = idle_wait_s
                    if deadlines:
                        timeout = min(idle_wait_s,
                                      max(min(deadlines) - now, 0.0) + 1e-4)
                    self._cond.wait(timeout)
                    batch = self._claim_locked(self._clock(), drain=drain)
            if batch is None:
                return dispatches
            self.execute(batch)
            dispatches += 1

    def serve(self, net: str, xs: Sequence[np.ndarray], *,
              timeout: float = 120.0) -> List[np.ndarray]:
        """Submit a burst and block until every ticket finishes. Raises if
        any request failed or was rejected. In pump mode the caller IS the
        drain, so a burst larger than ``queue_depth`` drains mid-submission
        instead of tripping backpressure."""
        if self._pool is not None and self._pool.running:
            tickets = [self.submit(net, x) for x in xs]
            deadline = self._clock() + timeout
            for t in tickets:
                if not t.wait(max(deadline - self._clock(), 0.0)):
                    raise TimeoutError(f"{net!r}: ticket not served within "
                                       f"{timeout:.1f}s")
        else:
            tickets = []
            for x in xs:
                t = self.submit(net, x)
                if t.rejected:               # queue full: drain, retry once
                    self.pump()
                    t = self.submit(net, x)
                tickets.append(t)
            self.pump()
        failed = [t.error for t in tickets if t.error]
        if failed:
            raise RuntimeError(f"{len(failed)} request(s) failed: {failed[0]}")
        return [t.result for t in tickets]

    # -- introspection -----------------------------------------------------
    def _state_stats_locked(self, key: str) -> Dict:
        s = self._nets[key]
        waits = np.asarray(s.waits, np.float64)
        head = s.bucket_head
        return {"batch_cap": s.queue.batch_cap, "generation": s.generation,
                "latency_budget_ms": self._budget_s(s.latency_budget_ms)
                * 1e3,
                "predicted_per_image_ms": self._per_image_locked(
                    s, s.queue.batch_cap) * 1e3,
                "bucket_scales": ({int(b): head.scale(b)
                                   for b in head.buckets()}
                                  if head is not None else None),
                "dispatches": s.dispatches, "images": s.images,
                "padded": s.padded, "busy_s": s.busy_s,
                "images_per_s": (s.images / s.busy_s if s.busy_s else 0.0),
                "queued": len(s.queue), "inflight": s.inflight,
                "rejected": s.rejected,
                "recalibrations": s.recalibrations,
                "last_recal_error": s.last_recal_error,
                "recal_sample": s.last_recal_sample,
                "window_scale": s.queue.window_scale,
                "effective_wait_ms": s.queue.effective_wait_s() * 1e3,
                "queue_wait_p50_ms": (float(np.percentile(waits, 50)) * 1e3
                                      if waits.size else 0.0),
                "queue_wait_p99_ms": (float(np.percentile(waits, 99)) * 1e3
                                      if waits.size else 0.0),
                "breaker": (s.breaker.snapshot(self._clock())
                            if s.breaker is not None else None),
                "retries": s.retries,
                "failed_dispatches": s.failed_dispatches,
                "failed_tickets": s.failed_tickets,
                "fallback_dispatches": s.fallback_dispatches,
                "fallback_images": s.fallback_images,
                "canary_rejected": s.canary_rejected,
                "last_canary": s.last_canary,
                "rollbacks": s.rollbacks,
                "probes": s.probes,
                "probe_failures": s.probe_failures}

    def stats(self, net: str) -> Dict:
        """Serving stats for ``net`` — a state key or a logical name. A
        routed network aggregates its backends (sums for counters, pooled
        percentiles for queue waits) and adds a ``"backends"`` map of the
        full per-backend stats."""
        with self._cond:
            keys = self._route_keys_locked(net)
            per = {k: self._state_stats_locked(k) for k in keys}
            names = {k: self._nets[k].backend for k in keys}
            pooled = [np.asarray(self._nets[k].waits, np.float64)
                      for k in keys]
        for k in keys:
            per[k]["drift_ratio"] = self._drift.ratio(k)
            per[k]["observed_dispatches"] = len(self._drift.observations(k))
            per[k]["failures"] = self._drift.failures(k)
        if len(keys) == 1 and names[keys[0]] is None:
            return per[keys[0]]                # plain single-backend network
        out: Dict = {"backends": {names[k] or k: per[k] for k in keys}}
        for fld in ("dispatches", "images", "padded", "rejected", "queued",
                    "inflight", "recalibrations", "observed_dispatches",
                    "retries", "failed_dispatches", "failed_tickets",
                    "fallback_dispatches", "fallback_images",
                    "canary_rejected", "rollbacks", "probes",
                    "probe_failures"):
            out[fld] = sum(per[k][fld] for k in keys)
        failures: Dict[str, int] = {}
        for k in keys:
            merge_failures(failures, per[k]["failures"])
        out["failures"] = failures
        out["busy_s"] = sum(per[k]["busy_s"] for k in keys)
        out["images_per_s"] = (out["images"] / out["busy_s"]
                               if out["busy_s"] else 0.0)
        for fld in ("batch_cap", "generation", "window_scale",
                    "effective_wait_ms"):
            out[fld] = max(per[k][fld] for k in keys)
        ratios = [per[k]["drift_ratio"] for k in keys
                  if per[k]["drift_ratio"] is not None]
        out["drift_ratio"] = max(ratios) if ratios else None
        for fld in ("last_recal_error", "recal_sample", "last_canary"):
            out[fld] = next((per[k][fld] for k in keys
                             if per[k][fld] is not None), None)
        waits = (np.concatenate(pooled) if any(w.size for w in pooled)
                 else np.empty(0))
        out["queue_wait_p50_ms"] = (float(np.percentile(waits, 50)) * 1e3
                                    if waits.size else 0.0)
        out["queue_wait_p99_ms"] = (float(np.percentile(waits, 99)) * 1e3
                                    if waits.size else 0.0)
        return out

    def backends(self, net: str) -> List[str]:
        """Registered backend names for ``net`` (empty for a plain
        single-backend registration)."""
        with self._cond:
            return sorted(self._nets[k].backend
                          for k in self._routes.get(net, ())
                          if k in self._nets
                          and self._nets[k].backend is not None)

    def networks(self) -> List[str]:
        """Registered state keys, in registration order."""
        with self._cond:
            return list(self._order)


def _accepts_served(recalibrate: Optional[Callable]) -> bool:
    """Whether ``recalibrate`` takes the served-sample keyword — legacy
    single-argument recalibrators stay supported (fresh-profiling path)."""
    if recalibrate is None:
        return False
    try:
        params = inspect.signature(recalibrate).parameters
    except (TypeError, ValueError):
        return False
    return ("served" in params
            or any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values()))


def make_recalibrator(*, store=None, sample_n: int = 16, mode: str = "factor",
                      budget: Optional[float] = None,
                      max_iters: Optional[int] = None,
                      seed: int = 0,
                      use_served: bool = True,
                      pool: bool = False,
                      host: Optional[str] = None,
                      device="cuda") -> Callable:
    """Default drift-recalibration policy (DESIGN.md §8.3/§8.5). With
    ``use_served`` (default) the server's buffered served observations form
    the calibration sample, freshly measuring only the configs the buffer
    misses; without them it freshly measures ``sample_n`` configs on the
    network's platform. Either way: ``calibrate`` the current models onto
    the sample, re-solve the PBQP, return the new ``OptimisedNetwork`` for
    ``hot_swap``. The sample seed advances per call. ``budget`` overrides
    served reuse with a plain budgeted re-calibration. ``pool`` (needs
    ``store``) publishes this host's served evidence under the platform
    fingerprint and folds the fleet's pooled datasets in; ``host`` names
    this machine (``platforms.device_machine_id``). Models that train
    without a store train on ``device``."""
    counter = itertools.count()

    def recalibrate(opt: OptimisedNetwork,
                    served=None) -> OptimisedNetwork:
        k = next(counter)
        pooled = None
        if pool and store is not None and opt.platform is not None:
            fp = opt.platform.pool_fingerprint()
            if served is not None and host is not None:
                try:
                    store.publish_drift(fp, served, host=host, net=opt.net)
                except OSError:
                    pass
            try:
                pooled = store.pooled_drift(fp, exclude_host=host) or None
            except OSError:
                pooled = None
        if (use_served and budget is None
                and (served is not None or pooled)):
            return reoptimise(opt, served=served, pooled=pooled,
                              sample_n=sample_n, mode=mode, store=store,
                              seed=seed + k, max_iters=max_iters,
                              device=device)
        sample = (opt.platform.measure_sample(sample_n, seed=seed + k)
                  if budget is None else None)
        return reoptimise(opt, sample=sample,
                          budget=0.05 if budget is None else budget,
                          mode=mode, store=store, seed=seed,
                          max_iters=max_iters, device=device)

    return recalibrate


# ---------------------------------------------------------------------------
# CLI: optimise-on-arrival, then serve
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Optimise a CNN for a platform and serve it on one "
                    "device (concurrent worker-pool serving core).")
    ap.add_argument("--net", default="edge_cnn")
    ap.add_argument("--platform", default="arm",
                    help="intel | amd | arm (simulated) | tpu | pallas (the "
                         "simulated tile platform; its plans run the "
                         "hand-written kernels) | host (this machine's CPU, "
                         "measured) | gpu (the card, measured through the "
                         "hand-written kernels)")
    ap.add_argument("--device", default="cuda",
                    help="where models load and plans serve (cpu only on "
                         "request)")
    ap.add_argument("--backends", default=None, metavar="P1,P2,...",
                    help="register the net on each of these platforms "
                         "(any --platform name) as a routed backend and "
                         "dispatch every request to the predicted-cheapest "
                         "one; every plan serves on --device (default: the "
                         "single --platform backend, unrouted)")
    ap.add_argument("--transfer-from", default=None, metavar="PLATFORM",
                    help="calibrate from this platform's pretrained model "
                         "(the paper's §4.4 path) instead of native training")
    ap.add_argument("--calib-budget", type=float, default=0.01,
                    help="calibration sample budget (fraction or row count)")
    ap.add_argument("--store", default="artifacts",
                    help="artifact store root ('' disables warm-start)")
    ap.add_argument("--store-backend", choices=("local", "object"),
                    default="local",
                    help="artifact-store backend: 'local' (directory at "
                         "--store) or 'object' (in-process simulated object "
                         "store)")
    ap.add_argument("--pool-drift", action="store_true",
                    help="publish this host's served drift evidence to the "
                         "store and fold the fleet's pooled datasets into "
                         "every drift recalibration")
    ap.add_argument("--probe-rate", type=float, default=0.0,
                    help="max single-layer probe dispatches per second "
                         "(0 disables)")
    ap.add_argument("--keep", type=int, default=None,
                    help="artifact GC: keep only the newest K artifacts per "
                         "category after each put (default: keep all)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--latency-budget-ms", "--budget-ms", dest="budget_ms",
                    type=float, default=50.0,
                    help="per-request latency budget: sets the perf-model "
                         "batch cap and caps each batch window")
    ap.add_argument("--workers", type=int, default=0,
                    help="serving worker threads; 0 = synchronous pump mode")
    ap.add_argument("--frontend-procs", type=int, default=0,
                    help="intake processes assembling request batches in "
                         "shared-memory slabs and handing them to the "
                         "worker pool by reference (requires --workers >= "
                         "1); 0 = thread-only front end")
    ap.add_argument("--no-bucket-cost-model", action="store_true",
                    help="disable the batch-shape-aware cost model")
    ap.add_argument("--backend-budget-ms", default=None,
                    metavar="P1=MS,P2=MS,...",
                    help="per-backend latency budgets for routed serving")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="batch window cap")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="per-network queue bound; submits beyond it are "
                         "rejected (backpressure)")
    ap.add_argument("--drift-threshold", type=float, default=1.5,
                    help="served/predicted latency EWMA ratio that triggers "
                         "background recalibration + hot swap")
    ap.add_argument("--drift-alpha", type=float, default=0.25,
                    help="EWMA smoothing for the drift ratio")
    ap.add_argument("--obs-cap", type=int, default=256,
                    help="served-observation buffer size per network")
    ap.add_argument("--recal-sample-n", type=int, default=16,
                    help="calibration sample size for drift recalibration")
    ap.add_argument("--no-served-reuse", action="store_true",
                    help="drift recalibration always freshly profiles its "
                         "full sample")
    ap.add_argument("--max-triplets", type=int, default=60,
                    help="simulated profiling pool size")
    ap.add_argument("--max-iters", type=int, default=2000)
    ap.add_argument("--hot-swap", action="store_true",
                    help="recalibrate mid-run and hot-swap the assignment")
    ap.add_argument("--exec-deadline-ms", type=float, default=None,
                    help="per-dispatch execution deadline (default: "
                         "disabled)")
    ap.add_argument("--no-fallback", action="store_true",
                    help="a dispatch failed by a fault, a corrupt output "
                         "or its deadline fails its tickets instead of "
                         "retrying them on the safe plan (a kernel failure "
                         "fails them always)")
    ap.add_argument("--canary", action="store_true",
                    help="gate every hot_swap behind a canary batch")
    ap.add_argument("--breaker-failures", type=int, default=3)
    ap.add_argument("--breaker-window", type=int, default=16)
    ap.add_argument("--breaker-rate", type=float, default=0.5)
    ap.add_argument("--breaker-cooldown-ms", type=float, default=250.0)
    ap.add_argument("--rollback-history", type=int, default=4)
    args = ap.parse_args(argv)

    from repro_torch.service.artifacts import ArtifactStore
    from repro_torch.service.platforms import device_machine_id, get_platform
    from repro_torch.service.store_backends import get_backend

    store = (ArtifactStore(args.store, keep=args.keep,
                           backend=get_backend(args.store_backend,
                                               args.store),
                           device=args.device)
             if args.store else None)
    pool_host = device_machine_id(args.device) if args.pool_drift else None
    specs = ([s.strip() for s in args.backends.split(",") if s.strip()]
             if args.backends else [args.platform])
    routed = len(specs) > 1

    base = None
    if args.transfer_from:
        base_plat = get_platform(args.transfer_from,
                                 max_triplets=args.max_triplets)
        base = base_plat.pretrain("nn2", store=store,
                                  max_iters=args.max_iters,
                                  device=args.device)
        print(f"[serve] base model: {args.transfer_from} "
              f"({'warm' if base.warm else 'cold'}, {base.seconds:.2f}s)")

    opts = []
    for spec_name in specs:
        # measured platforms persist their profiled datasets through the
        # store; the host measures the CPU whatever --device is
        plat_kw = ({"store": store, "device": args.device} if spec_name == "gpu"
                   else {"store": store} if spec_name == "host"
                   else {"max_triplets": args.max_triplets})
        platform = get_platform(spec_name, **plat_kw)
        opt = optimise(args.net, platform, store=store, base=base,
                       budget=args.calib_budget, executable=True,
                       max_iters=args.max_iters, device=args.device)
        print(f"[serve] optimised {opt.net} for {platform.fingerprint()}: "
              f"{'warm' if opt.warm else 'cold'} in {opt.seconds:.2f}s, "
              f"predicted {opt.predicted_cost_s*1e3:.3f} ms/img")
        opts.append((spec_name, opt))
    opt = opts[0][1]

    budgets: Dict[str, float] = {}
    if args.backend_budget_ms:
        for part in args.backend_budget_ms.split(","):
            name, _, ms = part.partition("=")
            if not ms:
                raise SystemExit(f"--backend-budget-ms expects P=MS pairs, "
                                 f"got {part!r}")
            budgets[name.strip()] = float(ms)

    server = OptimisedServer(latency_budget_ms=args.budget_ms,
                             workers=args.workers,
                             max_wait_ms=args.max_wait_ms,
                             queue_depth=args.queue_depth,
                             drift_threshold=args.drift_threshold,
                             drift_alpha=args.drift_alpha,
                             obs_cap=args.obs_cap,
                             exec_deadline_ms=args.exec_deadline_ms,
                             fallback=not args.no_fallback,
                             canary=args.canary,
                             breaker_failures=args.breaker_failures,
                             breaker_window=args.breaker_window,
                             breaker_rate=args.breaker_rate,
                             breaker_cooldown_ms=args.breaker_cooldown_ms,
                             rollback_history=args.rollback_history,
                             bucket_cost_model=not args.no_bucket_cost_model,
                             frontend_procs=args.frontend_procs,
                             probe_rate=args.probe_rate,
                             recalibrate=make_recalibrator(
                                 store=store,
                                 sample_n=args.recal_sample_n,
                                 use_served=not args.no_served_reuse,
                                 pool=args.pool_drift and store is not None,
                                 host=pool_host, device=args.device),
                             device=args.device)
    for spec_name, o in opts:
        # routed backends serve one at a time each; the worker pool overlaps
        # them across backends instead
        server.register(o, backend=spec_name if routed else None,
                        latency_budget_ms=budgets.get(spec_name),
                        max_inflight=1 if routed else None)
    s = server.stats(opt.net)
    print(f"[serve] batch cap {s['batch_cap']} "
          f"(budget {args.budget_ms:.0f} ms), workers={args.workers}, "
          f"window={args.max_wait_ms:.1f} ms "
          f"(effective {s['effective_wait_ms']:.2f} ms), device "
          f"{server.device}")

    n0 = opt.spec.nodes[0]
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((args.requests, n0.c, n0.im, n0.im)).astype(np.float32)
    server.serve(opt.net, xs[: min(4, args.requests)])   # warm the plan
    t0 = time.perf_counter()
    server.serve(opt.net, xs)
    dt = time.perf_counter() - t0
    s = server.stats(opt.net)
    print(f"[serve] {args.requests} requests in {dt*1e3:.0f} ms "
          f"({args.requests/dt:.1f} img/s, {s['dispatches']} dispatches, "
          f"{s['padded']} padded, queue p50/p99 "
          f"{s['queue_wait_p50_ms']:.2f}/{s['queue_wait_p99_ms']:.2f} ms, "
          f"{s['observed_dispatches']} observations buffered)")
    if routed:
        for b, bs in s["backends"].items():
            print(f"[serve]   backend {b}: {bs['dispatches']} dispatches, "
                  f"{bs['images']} images, queue p50/p99 "
                  f"{bs['queue_wait_p50_ms']:.2f}/"
                  f"{bs['queue_wait_p99_ms']:.2f} ms, "
                  f"breaker {bs['breaker']['state']}")
    if s["failed_dispatches"] or s["fallback_images"]:
        print(f"[serve] faults: {s['failed_dispatches']} failed dispatches "
              f"({s['retries']} retried), {s['fallback_images']} images "
              f"served degraded, ledger {s['failures']}")
    if args.probe_rate > 0:
        print(f"[serve] probes: {s['probes']} measured, "
              f"{s['probe_failures']} failed (rate cap "
              f"{args.probe_rate:g}/s)")

    if args.pool_drift and store is not None:
        served = server.served_sample(opt.net)
        if served is not None:
            plat_fp = opt.platform.pool_fingerprint()
            store.publish_drift(plat_fp, served, host=pool_host, net=opt.net)
            print(f"[serve] published {served.n} drift-evidence rows for "
                  f"{plat_fp} as host {pool_host}")
        polled = server.poll_pool(store, host=pool_host)
        print(f"[serve] fleet pool: {len(store.entries('drift_pool'))} "
              f"entries, {polled} recalibrations scheduled from other "
              f"hosts' evidence")

    if args.hot_swap:
        spec_name, o = opts[0]
        recal = optimise(args.net, o.platform, store=store, base=o.models,
                         budget=max(args.calib_budget * 5, 0.05),
                         mode="finetune", executable=True,
                         max_iters=args.max_iters, device=args.device)
        key = f"{opt.net}#{spec_name}" if routed else opt.net
        server.hot_swap(key, recal)
        server.serve(opt.net, xs[:8])
        print(f"[serve] hot-swapped to recalibrated assignment "
              f"(generation {server.stats(key)['generation']})")

    if args.frontend_procs > 0:
        fe = server.frontend()
        agg = fe.drive(opt.net, args.requests, seed=1)
        print(f"[serve] frontend: {args.frontend_procs} intake procs, "
              f"{agg['requests']} requests -> {agg['served']} served "
              f"({agg['degraded']} degraded, {agg['failed']} failed, "
              f"{agg['rejected']} rejected) at {agg['images_per_s']:.1f} "
              f"img/s, mean latency {agg['latency_mean_ms']:.2f} ms")
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
