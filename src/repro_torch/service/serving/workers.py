"""Supervised worker pool: threads that claim and execute batches, plus a
supervisor that detects hung or dead workers (DESIGN.md §8.2, §11.3) — the
port of ``repro.service.serving.workers``.

Each worker slot owns one ``torch.cuda.Stream`` on the server's device and
runs its whole claim → execute loop inside it. Every kernel launches on the
current stream (``kernels/common.stream_of``), so a worker's stream carries
all of its dispatch's work, and the dispatch's closing device-to-host copy
waits on that work only — one network's result never waits for another
network's batch, as ``block_until_ready`` on one computation does in the
reference. A replacement worker gets a fresh stream. On the CPU there is no
stream and the loop runs as it is.

The port replays a plan op by op in Python, so two workers overlap one
network's host-side replay with another's device work, not two replays: the
GIL serialises the Python. The pool stays deliberately dumb about
*scheduling*: every decision (timed windows, per-state in-flight limits,
fairness) lives in the serving core's ``claim_blocking``; a worker loops
claim → execute.

What the pool does own is *liveness* (DESIGN.md §11.3). Each worker runs in
a slot that records its in-progress claim; a supervisor thread polls the
slots and intervenes when:

  * the worker thread **died** mid-claim (an exception escaped everything —
    should be unreachable, ``execute`` never raises, but a supervisor that
    assumes that is not a supervisor): the claim is ``abandon``ed (in-flight
    slot released, tickets rescued or failed) and a fresh worker takes the
    slot;
  * the claim **exceeded the execution deadline** (``core.exec_deadline_s``,
    measured on the core's injectable clock from claim time): a hung plan —
    stuck device, runaway kernel — cannot be interrupted from Python, so the
    claim is abandoned the same way and the stuck thread is *replaced*: a
    fresh worker takes the slot and the zombie, still blocked inside the
    plan, discovers on completion that it was replaced and exits. Its
    eventual settle attempt is a no-op: the core's per-batch settle guard
    and the tickets' first-finish-wins make duplicate delivery structurally
    impossible.

Multi-backend networks (DESIGN.md §9) need no pool support: each backend
registration is its own claimable state with its own queue and in-flight
limit, so with ``workers >= 2`` and per-backend ``max_inflight=1`` two
backends of one network execute concurrently.

``stop()`` is graceful by default: workers first drain every queued ticket
(windows ignored — shutdown must not strand requests), then exit.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional

import torch

SUPERVISOR_POLL_S = 0.01      # real-time poll; deadlines use the core clock


class _Slot:
    """One worker position: the live thread, its in-progress claim and the
    CUDA stream its dispatches run on (None on the CPU)."""

    def __init__(self, index: int):
        self.index = index
        self.thread: Optional[threading.Thread] = None
        self.claim = None            # the _Batch being executed, else None
        self.stream = None           # torch.cuda.Stream of the live thread
        self.dispatches = 0          # claims executed from this slot


class WorkerPool:
    """N daemon threads running ``core.claim_blocking`` → ``core.execute``,
    under a supervisor enforcing liveness.

    ``core`` duck-type: ``claim_blocking(stop_event) -> Optional[claim]``
    (None means "stopping and nothing left to drain") and ``execute(claim)``.
    Supervision additionally uses, when present: ``abandon(claim, reason)``
    (rescue/fail a claim whose worker is gone), ``exec_deadline_s`` (per-
    dispatch execution deadline; None disables), ``_clock`` (the core's
    injectable clock — deadlines must be drivable from tests) and ``device``
    (a CUDA device gives every worker its own stream there).
    """

    def __init__(self, core, workers: int, name: str = "serve"):
        if workers < 1:
            raise ValueError(f"worker count must be >= 1, got {workers}")
        self.core = core
        self.workers = workers
        self.name = name
        self.restarts = 0            # workers replaced (hung or died)
        self._slots: List[_Slot] = []
        self._zombies: List[threading.Thread] = []
        self._supervisor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._spawn_seq = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "WorkerPool":
        with self._lock:
            if any(s.thread is not None and s.thread.is_alive()
                   for s in self._slots):
                return self
            # a FRESH event per pool incarnation: each worker captures its
            # own, so a zombie from a timed-out stop() keeps seeing its (set)
            # event and can never be revived by a later start()
            self._stop = threading.Event()
            self._slots = [_Slot(i) for i in range(self.workers)]
            for s in self._slots:
                self._spawn_locked(s, self._stop)
            self._supervisor = threading.Thread(
                target=self._supervise, args=(self._stop,), daemon=True,
                name=f"{self.name}-supervisor")
            self._supervisor.start()
        return self

    def _new_stream(self):
        """A fresh stream on the core's CUDA device, else None."""
        device = torch.device(getattr(self.core, "device", "cpu"))
        return torch.cuda.Stream(device) if device.type == "cuda" else None

    def _spawn_locked(self, slot: _Slot, stop: threading.Event) -> None:
        self._spawn_seq += 1
        slot.stream = self._new_stream()
        t = threading.Thread(target=self._run, args=(slot, stop, slot.stream),
                             daemon=True,
                             name=f"{self.name}-worker-{slot.index}"
                                  f".{self._spawn_seq}")
        slot.thread = t
        t.start()

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Signal shutdown and join. Workers drain queued tickets first so
        no submitted request is stranded undone. Threads that outlive the
        join timeout (zombies stuck in a hung plan included) are left to
        die with the process — daemonised, never revivable."""
        self._stop.set()
        self.core.wake_all()
        with self._lock:
            threads = [s.thread for s in self._slots if s.thread is not None]
            threads += self._zombies
            sup = self._supervisor
        for t in threads:
            t.join(timeout)
        if sup is not None:
            sup.join(timeout)
        with self._lock:
            self._zombies = [t for t in self._zombies if t.is_alive()]
            for s in self._slots:
                if s.thread is not None and not s.thread.is_alive():
                    s.thread = None
            self._slots = [s for s in self._slots if s.thread is not None]
            self._supervisor = None

    @property
    def running(self) -> bool:
        with self._lock:
            return any(s.thread is not None and s.thread.is_alive()
                       for s in self._slots)

    # -- worker body -------------------------------------------------------
    def _run(self, slot: _Slot, stop: threading.Event, stream) -> None:
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            self._loop(slot, stop)

    def _loop(self, slot: _Slot, stop: threading.Event) -> None:
        me = threading.current_thread()
        while True:
            with self._lock:
                if slot.thread is not me:
                    return           # replaced while executing: zombie exits
            claim = self.core.claim_blocking(stop)
            if claim is None:
                return
            with self._lock:
                if slot.thread is me:
                    slot.claim = claim
            try:
                self.core.execute(claim)
            except BaseException:    # execute() never raises by contract;
                # if it somehow does, the claim must not leak its in-flight
                # slot or strand its tickets — rescue, then keep serving
                abandon = getattr(self.core, "abandon", None)
                if abandon is not None:
                    abandon(claim, "died")
            finally:
                with self._lock:
                    slot.dispatches += 1
                    if slot.claim is claim:
                        slot.claim = None

    # -- supervisor --------------------------------------------------------
    def _supervise(self, stop: threading.Event) -> None:
        clock = getattr(self.core, "_clock", time.monotonic)
        abandon = getattr(self.core, "abandon", None)
        while not stop.is_set():
            time.sleep(SUPERVISOR_POLL_S)
            deadline = getattr(self.core, "exec_deadline_s", None)
            with self._lock:
                self._zombies = [t for t in self._zombies if t.is_alive()]
                now = clock()
                for slot in self._slots:
                    t, claim = slot.thread, slot.claim
                    if t is None or stop.is_set():
                        continue
                    dead = not t.is_alive()
                    # a settled claim is a finished dispatch whose worker has
                    # not yet cleared its slot field — slow, not hung
                    hung = (not dead and claim is not None
                            and deadline is not None
                            and not getattr(claim, "settled", False)
                            and now - getattr(claim, "claimed_s", now)
                            > deadline)
                    if not dead and not hung:
                        continue
                    if claim is not None and abandon is not None:
                        reason = "died" if dead else "deadline"
                        # release the pool lock around abandon: it takes the
                        # core lock and may execute a fallback plan
                        slot.claim = None
                        self._lock.release()
                        try:
                            abandon(claim, reason)
                        finally:
                            self._lock.acquire()
                    if not dead:
                        self._zombies.append(t)   # stuck in the plan: shed it
                    self.restarts += 1
                    self._spawn_locked(slot, stop)

    @property
    def dispatches(self) -> List[int]:
        """Claims executed per worker slot (a replacement worker continues
        its slot's count)."""
        with self._lock:
            return [s.dispatches for s in self._slots]

    @property
    def busy(self) -> int:
        """Worker slots inside ``execute`` now (a dispatch's tickets finish
        before its drift observation and probes: 0 means those are done)."""
        with self._lock:
            return sum(1 for s in self._slots if s.claim is not None)

    @property
    def streams(self) -> list:
        """The live worker slots' CUDA streams (None entries on the CPU)."""
        with self._lock:
            return [s.stream for s in self._slots]

    @property
    def zombies(self) -> int:
        """Hung worker threads shed by the supervisor and still running."""
        with self._lock:
            return sum(1 for t in self._zombies if t.is_alive())
