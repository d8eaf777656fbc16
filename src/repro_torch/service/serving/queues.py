"""Tickets, pre-assembled slab batches and per-network request queues with
deadline-aware batch windows — the port's own copy of
``repro.service.serving.queues`` (pure Python and numpy; DESIGN.md §8.1,
§8.5, §12).

A ``Ticket`` is one queued inference request. It carries a
``threading.Event`` so a submitting thread can block on exactly its own
result while worker threads dispatch batches concurrently.

A ``NetQueue`` is a bounded FIFO for one network. It does NOT lock itself:
the serving core serialises all queue mutation under one lock. What it
*does* own is the batching policy:

  * dispatch when ``len(queue) >= batch_cap``            (the batch is full)
  * or when ``oldest ticket age >= effective max_wait``  (the window expired)

The *effective* window is deadline-aware: ``max_wait`` capped by the
latency budget minus the model-predicted execution of the pending pow2
batch (batch-shape-aware when a ``bucket_scale`` head is fitted), all scaled
by ``window_scale`` (the drift monitor shrinks it when observed p99 queueing
latency exceeds the budget, and restores it when the queue drains).
``push`` refuses tickets beyond ``depth`` (backpressure).

A ``BatchGroup`` is a batch the process front end already assembled,
pow2-padded, in one shared-memory slab (``frontend.py``): it shares the
queue's depth bound with loose tickets, makes the queue ready at once (its
window ran in the intake process) and dispatches whole.

This module imports numpy only: the front end's intake processes import it
and must not load torch.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np


def monotonic() -> float:
    """One clock for every queue/window decision; tests inject their own
    through the server."""
    return time.perf_counter()


def pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def pow2_ceil(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


@dataclasses.dataclass
class Ticket:
    """One queued inference request. ``result``/``error`` are set by the
    dispatching worker; ``wait()`` blocks until then. A failed or rejected
    dispatch marks its tickets instead of losing them."""

    net: str
    x: np.ndarray                      # (c, im, im) — for slab-backed
    # tickets this is a zero-copy row view into a shared-memory slab
    result: Optional[np.ndarray] = None
    slab: Optional[object] = None      # SlabHandle provenance (frontend.py)
    row: int = -1                      # row index inside the slab, -1 = none
    done: bool = False
    error: Optional[str] = None
    rejected: bool = False             # refused at submit (backpressure)
    degraded: bool = False             # served by the safe fallback plan
    submitted_s: float = 0.0           # clock timestamps
    dispatched_s: float = 0.0
    completed_s: float = 0.0
    clock: Optional[Callable[[], float]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)
    _finish_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until this ticket is finished (True) or ``timeout`` expires
        (False). Finished covers success, failure, and rejection."""
        return self._done_event.wait(timeout)

    @property
    def queue_wait_s(self) -> float:
        """Time spent queued before a dispatch claimed the ticket."""
        return max(self.dispatched_s - self.submitted_s, 0.0)

    def finish(self, *, result: Optional[np.ndarray] = None,
               error: Optional[str] = None, rejected: bool = False,
               degraded: bool = False) -> bool:
        """Settle the ticket. First finish wins: a supervisor abandoning a
        hung dispatch and the dispatch eventually completing must not both
        deliver — whichever settles first is the result the waiter saw, and
        the loser's call is a no-op (returns False). This is what makes
        "zero duplicated tickets" a structural property rather than a timing
        accident."""
        with self._finish_lock:
            if self.done:
                return False
            self.result = result
            self.error = error
            self.rejected = rejected
            self.degraded = degraded
            self.completed_s = (self.clock or monotonic)()
            self.done = True
        self._done_event.set()
        return True


@dataclasses.dataclass
class BatchGroup:
    """A pre-assembled dispatch from the process front end: tickets whose
    payload rows already live contiguously — and pow2-padded — in one
    shared-memory slab. ``xs`` is the zero-copy padded batch view the worker
    executes directly; ``on_done(tickets, out)`` fires exactly once when the
    dispatch settles (delivered, degraded, failed, or rejected) so the front
    end can ship results back and recycle the slab."""

    tickets: List[Ticket]
    xs: np.ndarray                     # (pow2 bucket, c, im, im) padded view
    on_done: Optional[Callable[[List[Ticket],
                                Optional[np.ndarray]], None]] = None


class NetQueue:
    """Bounded FIFO + deadline-aware batch window for one network. All
    methods must be called under the serving core's lock."""

    def __init__(self, *, depth: int, batch_cap: int, max_wait_s: float,
                 budget_s: Optional[float] = None,
                 predicted_s: float = 0.0,
                 bucket_scale: Optional[Callable[[int], float]] = None):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self.batch_cap = batch_cap
        self.max_wait_s = max_wait_s
        self.budget_s = budget_s
        self.predicted_s = predicted_s
        # batch-shape correction (BucketScaleHead.scale): per-image cost as
        # a function of the pending batch's pow2 bucket. None = linear.
        self.bucket_scale = bucket_scale
        self.window_scale = 1.0        # shrunk/restored by the drift monitor
        self._q: Deque[Ticket] = deque()
        self._groups: Deque[BatchGroup] = deque()

    def __len__(self) -> int:
        return len(self._q) + sum(len(g.tickets) for g in self._groups)

    def effective_wait_s(self) -> float:
        """``max_wait`` capped by the latency budget minus the predicted
        execution of the pending batch's pow2 bucket (bucket-scaled when a
        head is fitted), times ``window_scale``; never negative — a pending
        batch whose predicted execution alone exceeds the budget dispatches
        immediately."""
        w = self.max_wait_s
        if (self.budget_s is not None and math.isfinite(self.budget_s)
                and self.predicted_s > 0.0
                and math.isfinite(self.predicted_s)):
            b = pow2_ceil(len(self._q)) if self._q else 1
            per = self.predicted_s
            if self.bucket_scale is not None:
                per *= float(self.bucket_scale(b))
            w = min(w, self.budget_s - per * b)
        return max(w, 0.0) * self.window_scale

    def backlog_images(self, inflight: int = 0) -> int:
        """Queued images plus an in-flight allowance (``inflight`` batches
        at ``batch_cap`` each) — the cross-backend router's load proxy."""
        return len(self) + inflight * self.batch_cap

    def push(self, t: Ticket) -> bool:
        """Enqueue; False when the queue is at depth (backpressure)."""
        if len(self) >= self.depth:
            return False
        self._q.append(t)
        return True

    def push_group(self, g: BatchGroup) -> bool:
        """Enqueue a pre-assembled slab batch; False when the group would
        push the queue past depth (backpressure, same bound as ``push``)."""
        if len(self) + len(g.tickets) > self.depth:
            return False
        self._groups.append(g)
        return True

    def group_ready(self) -> bool:
        return bool(self._groups)

    def take_group(self) -> BatchGroup:
        """Pop the oldest pre-assembled batch (caller checked group_ready)."""
        return self._groups.popleft()

    def drain(self) -> Tuple[List[Ticket], List[BatchGroup]]:
        """Empty the queue entirely: loose tickets and pre-assembled groups
        (re-register / unregister: nothing may be stranded queued)."""
        tickets, groups = list(self._q), list(self._groups)
        self._q.clear()
        self._groups.clear()
        return tickets, groups

    def ready(self, now: float, *, drain: bool = False) -> bool:
        """Should a batch dispatch now? A pre-assembled group (its window
        already ran in the intake process), full batch, expired window, or
        an explicit drain (synchronous pump / shutdown)."""
        if self._groups:
            return True
        if not self._q:
            return False
        if drain or len(self._q) >= self.batch_cap:
            return True
        return now - self._q[0].submitted_s >= self.effective_wait_s()

    def next_deadline(self) -> Optional[float]:
        """Clock time at which the oldest ticket's window expires (the
        worker-pool wait bound); None when empty. A pending group is ready
        immediately."""
        if self._groups:
            return self._groups[0].tickets[0].submitted_s
        if not self._q:
            return None
        return self._q[0].submitted_s + self.effective_wait_s()

    def take(self, n: int) -> List[Ticket]:
        """Pop up to ``n`` loose tickets in FIFO order (groups dispatch
        whole, via ``take_group``)."""
        out = []
        while self._q and len(out) < n:
            out.append(self._q.popleft())
        return out
