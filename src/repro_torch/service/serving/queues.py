"""Tickets and per-network request queues with deadline-aware batch windows
— the port's own copy of ``repro.service.serving.queues`` (pure Python and
numpy), without the process front end's slab groups.

A ``Ticket`` is one queued inference request; ``wait()`` blocks until it is
settled. A ``NetQueue`` is a bounded FIFO for one network that owns the
batching policy: dispatch when ``len(queue) >= batch_cap`` or when the
oldest ticket has waited the effective window — ``max_wait`` capped by the
latency budget minus the predicted execution of the pending pow2 batch.
``push`` refuses tickets beyond ``depth`` (backpressure).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional

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
    dispatch; a failed or rejected dispatch marks its tickets instead of
    losing them."""

    net: str
    x: np.ndarray                      # (c, im, im)
    result: Optional[np.ndarray] = None
    done: bool = False
    error: Optional[str] = None
    rejected: bool = False             # refused at submit (backpressure)
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
        """Block until this ticket is finished (True) or ``timeout`` expires."""
        return self._done_event.wait(timeout)

    @property
    def queue_wait_s(self) -> float:
        """Time spent queued before a dispatch claimed the ticket."""
        return max(self.dispatched_s - self.submitted_s, 0.0)

    def finish(self, *, result: Optional[np.ndarray] = None,
               error: Optional[str] = None, rejected: bool = False) -> bool:
        """Settle the ticket; the first finish wins, later calls return False."""
        with self._finish_lock:
            if self.done:
                return False
            self.result = result
            self.error = error
            self.rejected = rejected
            self.completed_s = (self.clock or monotonic)()
            self.done = True
        self._done_event.set()
        return True


class NetQueue:
    """Bounded FIFO + deadline-aware batch window for one network."""

    def __init__(self, *, depth: int, batch_cap: int, max_wait_s: float,
                 budget_s: Optional[float] = None,
                 predicted_s: float = 0.0):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self.batch_cap = batch_cap
        self.max_wait_s = max_wait_s
        self.budget_s = budget_s
        self.predicted_s = predicted_s
        self._q: Deque[Ticket] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def effective_wait_s(self) -> float:
        """``max_wait`` capped by the latency budget minus the predicted
        execution of the pending batch's pow2 bucket; never negative."""
        w = self.max_wait_s
        if (self.budget_s is not None and math.isfinite(self.budget_s)
                and self.predicted_s > 0.0 and math.isfinite(self.predicted_s)):
            b = pow2_ceil(len(self._q)) if self._q else 1
            w = min(w, self.budget_s - self.predicted_s * b)
        return max(w, 0.0)

    def push(self, t: Ticket) -> bool:
        """Enqueue; False when the queue is at depth (backpressure)."""
        if len(self) >= self.depth:
            return False
        self._q.append(t)
        return True

    def drain(self) -> List[Ticket]:
        """Empty the queue (re-register: nothing may be stranded queued)."""
        out = list(self._q)
        self._q.clear()
        return out

    def ready(self, now: float, *, drain: bool = False) -> bool:
        """Should a batch dispatch now? Full batch, expired window, or an
        explicit drain."""
        if not self._q:
            return False
        if drain or len(self._q) >= self.batch_cap:
            return True
        return now - self._q[0].submitted_s >= self.effective_wait_s()

    def take(self, n: int) -> List[Ticket]:
        """Pop up to ``n`` tickets in FIFO order."""
        out = []
        while self._q and len(out) < n:
            out.append(self._q.popleft())
        return out
