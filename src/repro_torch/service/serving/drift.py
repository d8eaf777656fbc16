"""Calibration-drift detection and serving telemetry (DESIGN.md §8.3, §8.5)
— the port's own copy of ``repro.service.serving.drift`` (pure Python and
numpy; ``BucketScaleHead`` from the port's ``core/perfmodel.py``).

The perf model predicts per-image runtime on the platform it was calibrated
for; the server observes per-image runtime on the machine actually executing
plans. Those live on different absolute scales (a simulated-arm model serves
on a real CPU), so raw observed/predicted ratios mean nothing — what carries
signal is the ratio *moving*. Per (network, generation) the monitor:

  1. learns a **reference** log-ratio from the first ``calib_obs``
     observations (the platform-to-host scale at calibration time),
  2. tracks an **EWMA** of the log-ratio afterwards,
  3. flags an **excursion** when ``|ewma - reference| > log(threshold)``.

``observe`` returns True exactly once per excursion — the trigger for one
background recalibration (``platform.calibrate`` on fresh measurements +
re-select + ``hot_swap``). The excursion latch clears only when the ratio
returns inside threshold/2 (hysteresis) or the generation changes (the swap
resets the stats, because the new model has a new prediction scale).

Per-observation log-ratios are clamped to ±``clamp`` so a single pathological
dispatch (GC pause, page fault storm) cannot fake a sustained drift.

Beyond detection, the monitor is the serving-telemetry sink:

* **Observation buffer** (``record`` via ``observe(batch=...)``): every
  cleanly-timed dispatch (jit-compile dispatches excluded by the server) is
  one free measurement of the drifted platform. A bounded per-network deque
  keeps ``(batch bucket, clamped log-ratio, timestamp)``; ``attributed()``
  turns it into per-layer-config runtimes (see below) so drift-triggered
  recalibration can calibrate from served traffic instead of paying
  ``measure_sample`` profiling.
* **Window caps** (``observe_wait``): per-batch queueing waits feed a p99
  estimate; when it exceeds the latency budget the monitor halves the
  network's batch-window cap (``window_scale``), and doubles it back once
  p99 drops under half the budget — load-adaptive deadline batching.

Attribution: a dispatch times the *whole* compiled plan, not one layer. The
model's per-layer predictions give the split: a dispatch observed at drift
``exp(δ)`` relative to the calibration reference contributes
``predicted_j * exp(δ)`` for every assigned layer config j. δ is estimated
per batch bucket with an exponentially-weighted mean of the buffered
log-ratios minus the reference, so (a) fresh post-drift entries dominate a
buffer that still holds pre-drift history, and (b) the sample stays in the
*model's* prediction scale — mixing cleanly with freshly profiled top-up
rows instead of smuggling in the serving host's absolute clock.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.perfmodel import BucketScaleHead

# window-cap adaptation: adjust at most every WAIT_EVERY recorded waits once
# WAIT_MIN_OBS samples exist; the cap never shrinks below MIN_WINDOW_SCALE
WAIT_MIN_OBS = 16
WAIT_EVERY = 32
MIN_WINDOW_SCALE = 1.0 / 16.0


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """The served network's assigned layer configs and their model-predicted
    per-image runtimes — the attribution key for turning whole-plan dispatch
    timings into per-layer observations."""

    feats: np.ndarray              # (L, 5) conv-layer (k, c, im, s, f) rows
    columns: Tuple[str, ...]       # (L,) assigned primitive per layer
    predicted: np.ndarray          # (L,) model-predicted per-image seconds

    def __post_init__(self):
        if not (len(self.feats) == len(self.columns) == len(self.predicted)):
            raise ValueError("feats/columns/predicted lengths differ")


@dataclasses.dataclass(frozen=True)
class ServedObservation:
    """One cleanly-timed dispatch: its pow2 batch bucket, the clamped
    log(observed/predicted) per-image ratio, and when it was recorded."""

    batch: int
    log_r: float
    t: float


@dataclasses.dataclass
class DriftStats:
    """EWMA state for one (network, generation)."""
    generation: int
    n: int = 0                         # observations consumed
    ref_log: float = 0.0               # reference log-ratio (after calib)
    ewma_log: float = 0.0
    in_excursion: bool = False
    triggers: int = 0                  # excursions flagged
    layers: Optional[LayerProfile] = None
    buffer: Deque[ServedObservation] = dataclasses.field(
        default_factory=lambda: deque(maxlen=256))
    # queueing-wait telemetry driving the batch-window cap
    waits: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=512))
    window_scale: float = 1.0
    waits_since_adjust: int = 0
    # probe-dispatch telemetry (DESIGN.md §14.4): per (config, column) the
    # EW mean clamped log(observed/predicted), observation count, and the
    # model's predicted per-image seconds. Kept OUTSIDE the dispatch buffer
    # so probes never feed excursion detection or BucketScaleHead fitting.
    probes: Dict[Tuple[Tuple[float, ...], str], Tuple[float, int, float]] = \
        dataclasses.field(default_factory=dict)

    def ratio(self) -> float:
        """Current drift ratio: 1.0 = serving exactly as calibrated."""
        if self.n == 0:
            return 1.0
        return math.exp(self.ewma_log - self.ref_log)


class DriftMonitor:
    """Thread-safe served-vs-predicted latency tracker for many networks."""

    def __init__(self, *, threshold: float = 1.5, alpha: float = 0.25,
                 calib_obs: int = 3, clamp: float = math.log(8.0),
                 obs_cap: int = 256, obs_alpha: float = 0.5,
                 clock: Optional[Callable[[], float]] = None):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if obs_cap < 1:
            raise ValueError(f"obs_cap must be >= 1, got {obs_cap}")
        if not 0.0 < obs_alpha <= 1.0:
            raise ValueError(f"obs_alpha must be in (0, 1], got {obs_alpha}")
        self.threshold = threshold
        self.alpha = alpha
        self.calib_obs = max(int(calib_obs), 1)
        self.clamp = clamp
        self.obs_cap = int(obs_cap)
        self.obs_alpha = obs_alpha
        self.clock = clock if clock is not None else time.monotonic
        self._stats: Dict[str, DriftStats] = {}
        # failure ledger (DESIGN.md §11.1): net -> generation -> kind ->
        # count. Kept OUTSIDE _stats on purpose: a hot_swap resets drift
        # stats (new prediction scale) but must not erase the record of why
        # previous generations failed — the ledger is the post-incident
        # audit trail, keyed by the generation that misbehaved.
        self._failures: Dict[str, Dict[int, Dict[str, int]]] = {}
        self._lock = threading.Lock()

    def reset(self, net: str, generation: int,
              layers: Optional[LayerProfile] = None) -> DriftStats:
        """Start fresh stats for ``net`` at ``generation`` (register /
        hot_swap: the model — and so the prediction scale — changed).
        ``layers`` is the new assignment's attribution profile; without it
        dispatches are still drift-tracked but not buffered as samples."""
        with self._lock:
            s = DriftStats(generation=generation, layers=layers,
                           buffer=deque(maxlen=self.obs_cap))
            self._stats[net] = s
            return s

    def stats(self, net: str) -> Optional[DriftStats]:
        with self._lock:
            return self._stats.get(net)

    def observe(self, net: str, generation: int, observed_s: float,
                predicted_s: float, batch: Optional[int] = None) -> bool:
        """Feed one dispatch's per-image (observed, predicted) runtimes.
        Returns True exactly when a new excursion starts — i.e. at most once
        between resets, the moment recalibration should be scheduled.

        ``batch`` (the dispatch's pow2 bucket) additionally records the
        observation into the served-sample buffer; the server passes it only
        for cleanly-timed dispatches (jit-compile dispatches excluded)."""
        if (not math.isfinite(observed_s) or observed_s <= 0.0
                or not math.isfinite(predicted_s) or predicted_s <= 0.0):
            return False
        with self._lock:
            s = self._stats.get(net)
            if s is None or s.generation != generation:
                return False           # stale: a swap raced this dispatch
            log_r = math.log(observed_s / predicted_s)
            s.n += 1
            if s.n <= self.calib_obs:  # learning the reference scale
                if s.n > 1:            # clamp here too: one pathological
                    # dispatch must not poison the reference either
                    log_r = min(max(log_r, s.ref_log - self.clamp),
                                s.ref_log + self.clamp)
                s.ref_log += (log_r - s.ref_log) / s.n
                s.ewma_log = s.ref_log
                self._record_locked(s, batch, log_r)
                return False
            log_r = min(max(log_r, s.ref_log - self.clamp),
                        s.ref_log + self.clamp)
            self._record_locked(s, batch, log_r)
            s.ewma_log += self.alpha * (log_r - s.ewma_log)
            excess = abs(s.ewma_log - s.ref_log)
            if s.in_excursion:
                if excess < math.log(self.threshold) / 2:
                    s.in_excursion = False      # recovered without recal
                return False
            if excess > math.log(self.threshold):
                s.in_excursion = True
                s.triggers += 1
                return True
            return False

    def _record_locked(self, s: DriftStats, batch: Optional[int],
                       log_r: float) -> None:
        if batch is None or s.layers is None:
            return
        s.buffer.append(ServedObservation(batch=int(batch), log_r=log_r,
                                          t=self.clock()))

    # -- served-sample telemetry -------------------------------------------
    def observations(self, net: str) -> List[ServedObservation]:
        """Snapshot of the buffered (non-compile) dispatch observations."""
        with self._lock:
            s = self._stats.get(net)
            return list(s.buffer) if s is not None else []

    def _ew_by_bucket(self, entries: Sequence[ServedObservation]
                      ) -> Tuple[Dict[int, float], Dict[int, int]]:
        """Exponentially-weighted mean log-ratio and count per pow2 bucket,
        oldest → newest (the EW mean converges onto the most recent
        observations) — shared by ``attributed`` and ``bucket_head``."""
        by_bucket: Dict[int, float] = {}
        counts: Dict[int, int] = {}
        for e in entries:
            if e.batch in by_bucket:
                by_bucket[e.batch] += self.obs_alpha * (e.log_r
                                                        - by_bucket[e.batch])
            else:
                by_bucket[e.batch] = e.log_r
            counts[e.batch] = counts.get(e.batch, 0) + 1
        return by_bucket, counts

    def bucket_head(self, net: str, *, min_obs: int = 1):
        """Fit a :class:`~repro_torch.core.perfmodel.BucketScaleHead` from the
        buffered served observations — the batch-shape correction the server
        threads through batch caps, deadline windows, router scores, and the
        canary gate (DESIGN.md §12.3). None when nothing is buffered."""
        with self._lock:
            s = self._stats.get(net)
            entries = list(s.buffer) if s is not None else []
        return BucketScaleHead.fit(((e.batch, e.log_r) for e in entries),
                                   alpha=self.obs_alpha, min_obs=min_obs)

    def coverage(self, net: str) -> int:
        """Distinct layer configs the buffer covers — every buffered dispatch
        timed the whole plan, so one clean dispatch covers every assigned
        config; zero only when nothing (attributable) was served."""
        with self._lock:
            s = self._stats.get(net)
            if s is None or s.layers is None or not s.buffer:
                return 0
            return len({tuple(map(float, row)) for row in s.layers.feats})

    def attributed(self, net: str, *, min_obs: int = 1
                   ) -> Optional[Tuple[np.ndarray,
                                       Tuple[str, ...],
                                       List[Tuple[int, np.ndarray]],
                                       Dict]]:
        """Attribute the buffered whole-plan timings to per-layer configs.

        Returns ``(feats, columns, [(bucket, times), ...], info)`` — for each
        batch bucket seen, the (L,) attributed per-image runtimes
        ``predicted * exp(δ_bucket)`` where δ is the exponentially-weighted
        mean of the bucket's buffered log-ratios minus the calibration
        reference (newest observations dominate, so a buffer holding
        pre-drift history still yields a post-drift sample). Buckets with
        fewer than ``min_obs`` buffered dispatches are dropped from the
        sample rows (a lone noisy dispatch should not mint calibration
        rows) but still counted in ``info``. None when the buffer is empty,
        the network has no attribution profile, or no bucket clears
        ``min_obs``.
        """
        with self._lock:
            s = self._stats.get(net)
            if s is None or s.layers is None or not s.buffer:
                return None
            entries = list(s.buffer)
            layers, ref = s.layers, s.ref_log
        by_bucket, counts = self._ew_by_bucket(entries)
        kept = sorted(b for b in by_bucket
                      if counts[b] >= max(int(min_obs), 1))
        if not kept:
            return None
        rows = [(b, layers.predicted * math.exp(by_bucket[b] - ref))
                for b in kept]
        info = {"dispatches": len(entries),
                "buckets": {int(b): int(counts[b]) for b in sorted(counts)},
                "images": int(sum(e.batch for e in entries)),
                "drift": {int(b): math.exp(by_bucket[b] - ref)
                          for b in sorted(by_bucket)}}
        return layers.feats, layers.columns, rows, info

    # -- probe-dispatch telemetry (DESIGN.md §14.4) ------------------------
    def layer_profile(self, net: str) -> Optional[LayerProfile]:
        """The current generation's attribution profile — the server's probe
        scheduler draws (config, column) targets from it."""
        with self._lock:
            s = self._stats.get(net)
            return s.layers if s is not None else None

    def record_probe(self, net: str, generation: int, config, column: str,
                     observed_s: float, predicted_s: float) -> bool:
        """Feed one single-layer probe dispatch's (observed, predicted)
        per-image runtimes for ``(config, column)``.

        Probes live in their own per-key EW store, deliberately outside the
        dispatch buffer: they must never feed excursion detection, the
        served-latency accounting, or ``BucketScaleHead`` fitting — their
        sole consumer is ``probe_attributed``, which turns them into
        calibration rows that correct *relative* primitive costs. Clamped
        against the calibration reference like any observation. Returns
        False for stale generations or non-finite timings."""
        if (not math.isfinite(observed_s) or observed_s <= 0.0
                or not math.isfinite(predicted_s) or predicted_s <= 0.0):
            return False
        with self._lock:
            s = self._stats.get(net)
            if s is None or s.generation != generation:
                return False
            log_r = math.log(observed_s / predicted_s)
            log_r = min(max(log_r, s.ref_log - self.clamp),
                        s.ref_log + self.clamp)
            key = (tuple(float(v) for v in np.asarray(config).reshape(-1)),
                   column)
            prev = s.probes.get(key)
            if prev is None:
                s.probes[key] = (log_r, 1, float(predicted_s))
            else:
                ew, n, _ = prev
                s.probes[key] = (ew + self.obs_alpha * (log_r - ew), n + 1,
                                 float(predicted_s))
            return True

    def probe_attributed(self, net: str
                         ) -> Optional[Tuple[List[Tuple[np.ndarray, str,
                                                        float]], Dict]]:
        """Per-(config, column) probe measurements in the model's prediction
        scale: ``predicted * exp(ew - ref)`` — direct single-column rows for
        ``observations_to_dataset(probes=...)``. Deterministically ordered
        by (config, column). None when no probes were recorded."""
        with self._lock:
            s = self._stats.get(net)
            if s is None or not s.probes:
                return None
            ref = s.ref_log
            snap = dict(s.probes)
        rows = [(np.asarray(cfg, np.float64), col,
                 pred * math.exp(ew - ref))
                for (cfg, col), (ew, n, pred) in sorted(snap.items())]
        info = {"probes": int(sum(n for _, n, _ in snap.values())),
                "probe_keys": len(snap)}
        return rows, info

    # -- deadline telemetry: queueing p99 vs budget ------------------------
    def observe_wait(self, net: str, generation: int, wait_s: float,
                     budget_s: Optional[float]) -> Optional[float]:
        """Feed one dispatch's oldest-ticket queueing wait. Returns a new
        ``window_scale`` when the cap should change (p99 wait above the
        latency budget halves it; p99 under budget/2 doubles it back towards
        1.0), else None. Without a finite budget, waits are only recorded.
        Generation-checked like ``observe``: a claim racing a hot_swap's
        stats reset must not graft a stale scale onto the fresh queue (the
        monitor's fresh stats would sit at 1.0 and never emit the restore)."""
        if not math.isfinite(wait_s) or wait_s < 0.0:
            return None
        with self._lock:
            s = self._stats.get(net)
            if s is None or s.generation != generation:
                return None
            s.waits.append(wait_s)
            if (budget_s is None or not math.isfinite(budget_s)
                    or budget_s <= 0.0):
                return None
            s.waits_since_adjust += 1
            if (len(s.waits) < WAIT_MIN_OBS
                    or s.waits_since_adjust < WAIT_EVERY):
                return None
            p99 = float(np.percentile(np.asarray(s.waits, np.float64), 99))
            new = s.window_scale
            if p99 > budget_s:
                new = max(s.window_scale / 2.0, MIN_WINDOW_SCALE)
            elif p99 < budget_s / 2.0 and s.window_scale < 1.0:
                new = min(s.window_scale * 2.0, 1.0)
            if new == s.window_scale:
                s.waits_since_adjust = 0
                return None
            s.window_scale = new
            s.waits_since_adjust = 0
            s.waits.clear()            # judge the new cap on fresh samples
            return new

    # -- failure ledger (DESIGN.md §11.1) ----------------------------------
    def record_failure(self, net: str, generation: int, kind: str) -> None:
        """Count one serving failure for ``(net, generation)``. ``kind`` is
        the taxonomy bucket: "error" (plan raised), "kernel" (a kernel did
        not build, load or launch), "fault"
        (injected),
        "corrupt" (output validation), "deadline" (supervisor abandoned a
        hung dispatch), "died" (worker thread died mid-dispatch), "canary"
        (candidate rejected by the swap gate), "rollback" (auto-rollback
        fired), "probe" (a single-layer probe dispatch failed)."""
        with self._lock:
            gens = self._failures.setdefault(net, {})
            kinds = gens.setdefault(int(generation), {})
            kinds[kind] = kinds.get(kind, 0) + 1

    def failures(self, net: str,
                 generation: Optional[int] = None) -> Dict[str, int]:
        """Ledger kind→count for ``net`` — one generation, or all merged."""
        with self._lock:
            gens = self._failures.get(net, {})
            if generation is not None:
                return dict(gens.get(int(generation), {}))
            out: Dict[str, int] = {}
            for kinds in gens.values():
                for k, n in kinds.items():
                    out[k] = out.get(k, 0) + n
            return out

    def failure_ledger(self, net: str) -> Dict[int, Dict[str, int]]:
        """Full per-generation ledger snapshot for ``net``."""
        with self._lock:
            return {g: dict(k) for g, k in
                    self._failures.get(net, {}).items()}

    def window_scale(self, net: str) -> float:
        s = self.stats(net)
        return s.window_scale if s is not None else 1.0

    def ratio(self, net: str) -> float:
        s = self.stats(net)
        return s.ratio() if s is not None else 1.0
