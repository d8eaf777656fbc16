"""Deterministic fault injection for the serving layer (DESIGN.md §11) —
the port's own copy of ``repro.service.serving.faults`` (pure Python and
numpy). A plan execution hands the injector its output as a host array
(the server copies the served sink back before validating it).

A fault-tolerant serving core is only trustworthy if its failure paths are
*exercised*, and failure paths exercised by real flakiness are untestable.
This module makes faults first-class, injectable, and deterministic: a
``FaultPlan`` is a list of :class:`Fault` rules, each matching dispatches by
state key, generation, and per-key dispatch index; a :class:`FaultInjector`
counts dispatches and applies the matching rules around the real execution.

Injection points:

  * ``OptimisedServer(faults=injector)`` — every compiled-plan execution
    (including canary batches, which run under the *candidate* generation,
    so a fault plan can poison exactly the generation a recalibration would
    swap in) runs through :meth:`FaultInjector.run`.
  * ``SimulatedPlatform(faults=injector)`` — profiling measurements run
    through :meth:`FaultInjector.profile` under the key ``"profile:<name>"``,
    so a *recalibration source* can be poisoned (a broken measurement rig
    producing garbage times) independently of plan execution.

Fault kinds:

  * ``"raise"``     — the dispatch raises :class:`FaultError` before running.
  * ``"hang"``      — execution stalls for ``seconds`` on the injector's
                      clock before running (a stuck device/kernel; under a
                      fake clock the stall lasts until a test advances it —
                      exactly what the worker-deadline supervisor is for).
  * ``"slowdown"``  — execution runs, then stalls for ``seconds`` (a
                      pathologically slow plan: the canary gate's prey).
  * ``"corrupt"``   — execution runs, then the output's first row is
                      overwritten with NaN (silent data corruption; the
                      server's output validation turns it into a failure).
                      On the profile hook, measurements are scaled by
                      ``factor`` instead (poisoned profiling).

Determinism: matching depends only on (key, generation, per-key dispatch
index) — no randomness, no wall clock. Every injected fault is appended to
``injector.injected`` so tests can assert the exact schedule that ran.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.kernels.common import KernelError
from repro_torch.service.serving.health import CorruptOutput


class FaultError(RuntimeError):
    """An injected execution failure."""


def wait_until(clock: Callable[[], float], t_end: float,
               poll_s: float = 0.0005) -> None:
    """Stall until ``clock() >= t_end``. With the real clock this is a plain
    sleep; with an injected fake clock it polls (tiny real sleeps) until a
    test advances the clock — so hang/slowdown faults are drivable from a
    deterministic harness."""
    while clock() < t_end:
        time.sleep(poll_s)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injection rule. A dispatch matches when every given selector
    does: ``net`` (state key, e.g. ``"edge_cnn#a"``, or ``"profile:arm"``
    for the platform hook; None = any), ``generation`` (None = any), and the
    per-key dispatch index ``first <= i < last`` with ``i % every == 0``
    relative to ``first``."""

    kind: str                          # raise | hang | slowdown | corrupt
    net: Optional[str] = None
    generation: Optional[int] = None
    first: int = 0
    last: Optional[int] = None         # None = open-ended
    every: int = 1
    seconds: float = 0.0               # hang/slowdown stall duration
    factor: float = 1e6                # profile-corrupt measurement scale

    KINDS = ("raise", "hang", "slowdown", "corrupt")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {self.KINDS}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")

    def matches(self, net: str, generation: Optional[int], index: int) -> bool:
        if self.net is not None and self.net != net:
            return False
        if (self.generation is not None and generation is not None
                and self.generation != generation):
            return False
        if index < self.first:
            return False
        if self.last is not None and index >= self.last:
            return False
        return (index - self.first) % self.every == 0


class FaultInjector:
    """Applies a ``FaultPlan`` around executions, counting dispatches per
    state key. Thread-safe: the counter and the injected-event log are
    locked; the stall itself runs unlocked (a hang must not block other
    backends' dispatches)."""

    def __init__(self, faults: List[Fault],
                 clock: Optional[Callable[[], float]] = None):
        self.faults = list(faults)
        self.clock = clock if clock is not None else time.monotonic
        self.injected: List[Tuple[str, Optional[int], int, str]] = []
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def count(self, net: str) -> int:
        """Dispatches seen so far for ``net``'s state key."""
        with self._lock:
            return self._counts.get(net, 0)

    def _next(self, net: str, generation: Optional[int]) -> List[Fault]:
        with self._lock:
            i = self._counts.get(net, 0)
            self._counts[net] = i + 1
            hits = [f for f in self.faults if f.matches(net, generation, i)]
            for f in hits:
                self.injected.append((net, generation, i, f.kind))
            return hits

    # -- plan-execution hook ------------------------------------------------
    def run(self, net: str, generation: Optional[int],
            thunk: Callable[[], np.ndarray]) -> np.ndarray:
        """Execute ``thunk`` under this dispatch's matching faults."""
        hits = self._next(net, generation)
        for f in hits:
            if f.kind == "raise":
                raise FaultError(f"injected fault: {net} dispatch raises")
            if f.kind == "hang":
                wait_until(self.clock, self.clock() + f.seconds)
        out = thunk()
        for f in hits:
            if f.kind == "slowdown":
                wait_until(self.clock, self.clock() + f.seconds)
            elif f.kind == "corrupt":
                out = np.asarray(out, np.float32).copy()
                out[:1] = np.nan
        return out

    # -- profiling hook (SimulatedPlatform) ---------------------------------
    def profile(self, platform_name: str, times: np.ndarray) -> np.ndarray:
        """Apply matching faults to one profiling call's measurements, under
        the key ``"profile:<platform>"``. ``raise`` fails the measurement rig;
        ``corrupt`` scales every time by ``factor`` (pathological readings a
        calibration would faithfully learn)."""
        key = f"profile:{platform_name}"
        hits = self._next(key, None)
        for f in hits:
            if f.kind == "raise":
                raise FaultError(f"injected fault: {key} measurement failed")
            if f.kind == "hang" and f.seconds:
                wait_until(self.clock, self.clock() + f.seconds)
            if f.kind == "corrupt":
                times = np.asarray(times, np.float64) * f.factor
        return times


# The failure kinds a dispatch may be served degraded for by the safe plan:
# an injected fault and an output that failed validation. A kernel that
# does not build or launch ("kernel") and any other exception of the plan
# ("error") fail their tickets instead, so a broken kernel is never served
# around (the reference degrades every kind).
DEGRADABLE = frozenset({"fault", "corrupt"})


def classify(exc: BaseException) -> str:
    """Ledger kind for one execution failure (DESIGN.md §11.1). The port
    adds ``"kernel"``: a :class:`~repro_torch.kernels.common.KernelError`."""
    if isinstance(exc, CorruptOutput):
        return "corrupt"
    if isinstance(exc, FaultError):
        return "fault"
    if isinstance(exc, KernelError):
        return "kernel"
    return "error"


def validate_output(out, batch: int) -> np.ndarray:
    """Reject a plan output that would silently corrupt results: wrong
    leading batch dimension or non-finite values. Raises
    :class:`~repro_torch.service.serving.health.CorruptOutput`."""
    arr = np.asarray(out)
    if arr.ndim < 1 or arr.shape[0] != batch:
        raise CorruptOutput(f"plan returned shape {arr.shape} for a "
                            f"batch of {batch}")
    # A finite sum proves every element finite without materialising the
    # full isfinite mask (per-dispatch hot path, DESIGN.md §13.3); a
    # non-finite sum can also be mere overflow of large finite values, so
    # only then pay for the exact elementwise check.
    if not np.isfinite(arr.sum(dtype=np.float64)):
        bad = int(np.size(arr) - np.isfinite(arr).sum())
        if bad:
            raise CorruptOutput(f"plan output contains {bad} "
                                f"non-finite values")
    return arr

