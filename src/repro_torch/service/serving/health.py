"""Backend health: per-backend circuit breakers (DESIGN.md §11.2) — the
port's own copy of ``repro.service.serving.health`` (pure Python).

A backend that starts failing should stop receiving traffic *before* its
queue fills with doomed tickets — the router's cost×backlog score cannot see
failures, only slowness. :class:`CircuitBreaker` is the classic three-state
machine:

  * **closed** — traffic flows; failures are recorded into a sliding window.
    Too many consecutive failures, or too high an error rate over the
    window, trips the breaker open.
  * **open** — ``allow()`` refuses admission; the router spills submissions
    to healthy backends. After ``cooldown_s`` the breaker transitions to
    half-open on the next ``allow()`` call.
  * **half-open** — up to ``probes`` in-flight dispatches are admitted as
    probes. A probe success closes the breaker (window cleared); a probe
    failure re-opens it and restarts the cooldown.

Locking: like ``NetQueue``, the breaker is NOT self-locking — every method
is called with the owning server's ``_cond`` held. This keeps the breaker
decision atomic with the routing decision that consumes it.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional


class CorruptOutput(RuntimeError):
    """A plan produced output that failed validation (non-finite values or
    a wrong batch dimension). Treated as an execution failure: it triggers
    retry/fallback and feeds the failure ledger under kind ``"corrupt"``."""


class CircuitBreaker:
    """Three-state (closed / open / half-open) breaker over one backend.

    Parameters
    ----------
    failures : consecutive failures that trip the breaker open.
    window : sliding window of recent outcomes for the error-rate trip.
    rate : error-rate over a full window that trips the breaker open.
    cooldown_s : seconds to hold open before probing.
    probes : concurrent probe dispatches admitted while half-open.
    """

    def __init__(self, *, failures: int = 3, window: int = 16,
                 rate: float = 0.5, cooldown_s: float = 1.0,
                 probes: int = 1):
        if failures < 1:
            raise ValueError("failures must be >= 1")
        if probes < 1:
            raise ValueError("probes must be >= 1")
        self.failures = int(failures)
        self.window = int(window)
        self.rate = float(rate)
        self.cooldown_s = float(cooldown_s)
        self.probes = int(probes)

        self.state = "closed"
        self.consecutive = 0
        self.recent: deque = deque(maxlen=self.window)
        self.opened_s: Optional[float] = None
        self.inflight_probes = 0
        self.opens = 0          # lifetime trips (telemetry)
        self.closes = 0         # lifetime recoveries (telemetry)

    # -- admission ----------------------------------------------------------
    def allow(self, now: float) -> bool:
        """May a new dispatch be admitted to this backend at ``now``?
        Transitions open→half-open when the cooldown has elapsed; while
        half-open, admits at most ``probes`` concurrent probe dispatches
        (callers that are refused must try another backend or queue the
        refusal — they do NOT hold a probe slot)."""
        if self.state == "open":
            if self.opened_s is not None and \
                    now - self.opened_s >= self.cooldown_s:
                self.state = "half_open"
                self.inflight_probes = 0
            else:
                return False
        if self.state == "half_open":
            if self.inflight_probes >= self.probes:
                return False
            self.inflight_probes += 1
            return True
        return True

    def cancel_probe(self) -> None:
        """Release a probe slot granted by ``allow()`` when the admitted
        dispatch never actually started (e.g. the queue refused the push
        and the ticket spilled elsewhere)."""
        if self.state == "half_open" and self.inflight_probes > 0:
            self.inflight_probes -= 1

    # -- outcomes -----------------------------------------------------------
    def record(self, ok: bool, now: float) -> None:
        """Record a finished dispatch's outcome. In half-open state this is
        a probe verdict: success closes, failure re-opens."""
        if self.state == "half_open":
            if self.inflight_probes > 0:
                self.inflight_probes -= 1
            if ok:
                self.state = "closed"
                self.closes += 1
                self.consecutive = 0
                self.recent.clear()
                self.opened_s = None
                self.inflight_probes = 0
            else:
                self._trip(now)
            return
        self.recent.append(bool(ok))
        if ok:
            self.consecutive = 0
            return
        self.consecutive += 1
        if self.state == "closed" and self._should_trip():
            self._trip(now)

    def _should_trip(self) -> bool:
        if self.consecutive >= self.failures:
            return True
        if len(self.recent) >= self.window:
            errs = sum(1 for ok in self.recent if not ok)
            if errs / len(self.recent) >= self.rate:
                return True
        return False

    def _trip(self, now: float) -> None:
        self.state = "open"
        self.opened_s = now
        self.opens += 1
        self.inflight_probes = 0

    # -- telemetry ----------------------------------------------------------
    def snapshot(self, now: float) -> Dict[str, object]:
        cooldown_left = 0.0
        if self.state == "open" and self.opened_s is not None:
            cooldown_left = max(0.0, self.cooldown_s - (now - self.opened_s))
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive,
            "window_errors": sum(1 for ok in self.recent if not ok),
            "window_size": len(self.recent),
            "opens": self.opens,
            "closes": self.closes,
            "cooldown_left_s": cooldown_left,
        }


def merge_failures(into: Dict[str, int], more: Dict[str, int]) -> Dict[str, int]:
    """Merge two failure-ledger kind→count maps (stats aggregation)."""
    for kind, n in more.items():
        into[kind] = into.get(kind, 0) + int(n)
    return into


Clock = Callable[[], float]
