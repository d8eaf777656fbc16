"""Profiler dataset construction (paper §3.2).

Primitive dataset rows:  (k, c, im, s, f) -> (R_1 ... R_N)   N = |registry|
DLT dataset rows:        (c, im)          -> (R_1 ... R_9)

Undefined entries (inapplicable primitive) are NaN. Datasets are built either
from a platform simulator (full scale) or from the real-CPU profiler
(reduced scale); both return the same ``PerfDataset`` structure, and both are
split 80/10/10 after shuffling (paper §4.2).

The port's own copy of ``repro.profiler.dataset`` (numpy only): the same
rows, the same split and subsample draws, the same ``fingerprint`` bytes and
the same npz payload, so a dataset keys one artifact address in both
packages. Measured datasets come from the GPU profiler
(``profiler/device.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.primitives import conv
from repro_torch.primitives import layouts as L
from repro_torch.primitives.conv import PRIMITIVE_NAMES
from repro_torch.profiler import pools
from repro_torch.profiler.simulators import (PLATFORMS, dlt_time_batch,
                                             primitive_time_batch)


@dataclasses.dataclass
class PerfDataset:
    feats: np.ndarray        # (N, F) raw feature rows
    times: np.ndarray        # (N, P) runtimes, NaN = undefined
    columns: List[str]
    feature_names: List[str]
    platform: str

    def split(self, seed: int = 0, fractions=(0.8, 0.1, 0.1)) -> Tuple["PerfDataset", "PerfDataset", "PerfDataset"]:
        n = self.feats.shape[0]
        rng = np.random.default_rng(seed)
        idx = rng.permutation(n)
        n_train = int(fractions[0] * n)
        n_val = int(fractions[1] * n)
        parts = (idx[:n_train], idx[n_train:n_train + n_val], idx[n_train + n_val:])
        return tuple(
            PerfDataset(self.feats[p], self.times[p], self.columns,
                        self.feature_names, self.platform)
            for p in parts)

    def subsample(self, fraction: float, seed: int = 0) -> "PerfDataset":
        """Random subset — the paper's transfer-learning data fractions."""
        n = self.feats.shape[0]
        m = max(1, int(round(fraction * n)))
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, size=m, replace=False)
        return PerfDataset(self.feats[idx], self.times[idx], self.columns,
                           self.feature_names, self.platform)

    def family_subset(self, family: str) -> "PerfDataset":
        """Keep only columns of one primitive family (Table 5 experiments).
        Rows with no defined entry for the family are dropped."""
        cols = [i for i, n in enumerate(self.columns)
                if conv.family_of(n) == family]
        times = self.times[:, cols]
        keep = np.isfinite(times).any(axis=1)
        return PerfDataset(self.feats[keep], times[keep],
                           [self.columns[i] for i in cols],
                           self.feature_names, self.platform)

    @property
    def n(self) -> int:
        return self.feats.shape[0]

    def fingerprint(self) -> str:
        """Content hash over features, runtimes and column names — the
        dataset identity used for artifact keying (service.artifacts).
        Simulator datasets hash identically across runs (deterministic
        noise); measured datasets hash per measurement."""
        import hashlib
        h = hashlib.sha256()
        h.update(("|".join(self.columns) + "@" + self.platform).encode())
        h.update(np.ascontiguousarray(self.feats, np.float64).tobytes())
        h.update(np.ascontiguousarray(self.times, np.float64).tobytes())
        return h.hexdigest()[:16]

    # -- persistence (ArtifactStore dataset warm-start) ---------------------
    def save(self, path: str) -> None:
        """Single-file .npz round-trip (the artifact store's dataset payload,
        and the fleet drift pool's)."""
        np.savez(path,
                 feats=np.asarray(self.feats, np.float64),
                 times=np.asarray(self.times, np.float64),
                 columns=np.array(self.columns, dtype=np.str_),
                 feature_names=np.array(self.feature_names, dtype=np.str_),
                 platform=np.array(self.platform, dtype=np.str_))

    @classmethod
    def load(cls, path: str) -> "PerfDataset":
        with np.load(path) as z:
            return cls(feats=z["feats"], times=z["times"],
                       columns=[str(c) for c in z["columns"]],
                       feature_names=[str(f) for f in z["feature_names"]],
                       platform=str(z["platform"]))


def merge_served(datasets: Sequence[PerfDataset]) -> Optional[PerfDataset]:
    """Union several served-traffic datasets (local + fleet-pooled) into one
    sample for ``compose_sample`` (DESIGN.md §14.3).

    Columns are unioned and sorted; each source's rows embed into the union
    with NaN for columns it never measured, exactly like a partially
    applicable profiled row. Row order is source order then within-source
    order, so merging is deterministic for deterministic inputs and the
    merged fingerprint is stable across hosts that pooled the same
    evidence. ``served_info`` summarises the pool (sources, per-source row
    counts, summed dispatches)."""
    datasets = [d for d in datasets if d is not None and d.n]
    if not datasets:
        return None
    if len({d.platform for d in datasets}) != 1:
        raise ValueError("merge_served: mixed platforms "
                         f"{sorted({d.platform for d in datasets})}")
    feature_names = list(datasets[0].feature_names)
    columns = sorted(set().union(*(d.columns for d in datasets)))
    col_idx = {c: j for j, c in enumerate(columns)}
    feats, times = [], []
    for d in datasets:
        if list(d.feature_names) != feature_names:
            raise ValueError("merge_served: mismatched feature names")
        block = np.full((d.n, len(columns)), np.nan)
        for j, c in enumerate(d.columns):
            block[:, col_idx[c]] = d.times[:, j]
        feats.append(np.asarray(d.feats, np.float64))
        times.append(block)
    out = PerfDataset(np.concatenate(feats), np.concatenate(times),
                      columns, feature_names, datasets[0].platform)
    infos = [getattr(d, "served_info", None) or {} for d in datasets]
    out.served_info = {
        "sources": len(datasets),
        "rows": [int(d.n) for d in datasets],
        "dispatches": int(sum(i.get("dispatches", 0) for i in infos)),
    }
    return out


def observations_to_dataset(feats: np.ndarray,
                            assigned: Sequence[str],
                            bucket_times: Sequence[Tuple[int, np.ndarray]],
                            *,
                            columns: Sequence[str],
                            platform: str,
                            feature_names: Sequence[str] = ("k", "c", "im",
                                                            "s", "f"),
                            info: Optional[Dict] = None,
                            probes: Optional[Sequence[Tuple[np.ndarray, str,
                                                            float]]] = None
                            ) -> PerfDataset:
    """Fold served-dispatch attributions into a ``PerfDataset`` the
    calibration path can consume (DESIGN.md §8.5).

    ``feats`` is the served network's (L, 5) assigned layer configs,
    ``assigned`` the primitive column per layer, and ``bucket_times`` one
    ``(batch_bucket, (L,) attributed per-image seconds)`` entry per pow2
    batch bucket observed (``DriftMonitor.attributed``). Per bucket, layers
    sharing a config collapse into one dataset row — two layers with the
    same config and column attribute identically, and the same config under
    two different columns fills both entries of one row; every other column
    stays NaN (unmeasured), exactly like a partially-applicable profiled row.

    The output is deterministic for deterministic input: rows are ordered by
    (bucket, config), so the same buffer snapshot always fingerprints — and
    ``save``/``load`` round-trips — byte-identically.

    ``info`` (the attribution summary: dispatches, per-bucket counts and
    drift) is attached as ``served_info`` so downstream consumers —
    ``platforms.compose_sample`` and the recalibration report — can surface
    the batch-shape mix the served sample was drawn from. It is metadata
    only: ``save``/``load`` does not persist it.

    ``probes`` are single-layer probe-dispatch measurements (DESIGN.md
    §14.4): ``(config_row, column, seconds)`` triples appended as their own
    rows after the bucket rows, sorted by (config, column) — each probe
    measured one column directly, so its row carries exactly one finite
    entry. Probe columns must already be in ``columns``.
    """
    feats = np.asarray(feats, np.float64)
    assigned = list(assigned)
    columns = list(columns)
    if feats.ndim != 2 or len(assigned) != feats.shape[0]:
        raise ValueError(f"feats {feats.shape} vs {len(assigned)} assigned "
                         f"columns")
    missing = sorted(set(assigned) - set(columns))
    if missing:
        raise ValueError(f"assigned columns {missing} not in dataset "
                         f"columns")
    col_idx = {c: j for j, c in enumerate(columns)}
    out_feats: List[np.ndarray] = []
    out_times: List[np.ndarray] = []
    for bucket, times in sorted(bucket_times, key=lambda bt: bt[0]):
        times = np.asarray(times, np.float64)
        if times.shape != (feats.shape[0],):
            raise ValueError(f"bucket {bucket}: times {times.shape} vs "
                             f"{feats.shape[0]} layers")
        rows: Dict[Tuple[float, ...], np.ndarray] = {}
        for i in range(feats.shape[0]):
            key = tuple(feats[i])
            row = rows.get(key)
            if row is None:
                row = rows[key] = np.full(len(columns), np.nan)
            row[col_idx[assigned[i]]] = times[i]
        for key in sorted(rows):
            out_feats.append(np.asarray(key, np.float64))
            out_times.append(rows[key])
    probe_rows = []
    for cfg, col, seconds in (probes or ()):
        cfg = np.asarray(cfg, np.float64).reshape(-1)
        if cfg.shape != (feats.shape[1] if feats.size else len(cfg),):
            raise ValueError(f"probe config shape {cfg.shape}")
        if col not in col_idx:
            raise ValueError(f"probe column {col!r} not in dataset columns")
        probe_rows.append((tuple(cfg), col, float(seconds)))
    for cfg, col, seconds in sorted(probe_rows, key=lambda p: (p[0], p[1])):
        row = np.full(len(columns), np.nan)
        row[col_idx[col]] = seconds
        out_feats.append(np.asarray(cfg, np.float64))
        out_times.append(row)
    if not out_feats:
        raise ValueError("no observations to convert")
    ds = PerfDataset(np.stack(out_feats), np.stack(out_times),
                     columns, list(feature_names), platform)
    if info is not None or probe_rows:
        ds.served_info = dict(info or {})
        if probe_rows:
            ds.served_info["probes"] = len(probe_rows)
    return ds


def simulate_primitive_dataset(platform: str,
                               max_triplets: Optional[int] = None,
                               noisy: bool = True) -> PerfDataset:
    plat = PLATFORMS[platform]
    cfgs = pools.config_pool(max_triplets=max_triplets)
    feats = np.array(cfgs, np.float64)
    # one vectorised pass over all configs × all registry columns
    times = primitive_time_batch(plat, np.array(cfgs, np.int64), noisy=noisy)
    return PerfDataset(feats, times, list(PRIMITIVE_NAMES),
                       ["k", "c", "im", "s", "f"], platform)


def simulate_dlt_dataset(platform: str,
                         max_pairs: Optional[int] = None,
                         noisy: bool = True) -> PerfDataset:
    plat = PLATFORMS[platform]
    pairs = pools.dlt_pool(max_pairs=max_pairs)
    names = [L.dlt_name(s, d) for (s, d) in L.dlt_pairs() if s != d]
    feats = np.array(pairs, np.float64)
    times = dlt_time_batch(plat, np.array(pairs, np.int64), noisy=noisy)
    return PerfDataset(feats, times, names, ["c", "im"], platform)
