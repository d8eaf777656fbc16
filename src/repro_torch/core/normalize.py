"""Log-standardization of performance data (paper §3.3, "Data Point
Normalization") — the port's own copy of ``repro.core.normalize`` (numpy
only, kept identical so saved normalizers read the same in both packages).

The paper trains on ``z = log(x)`` then standardizes ``(z - mean(z)) / std(z)``
per column, handling undefined entries (primitive inapplicable to a layer
shape) as NaN that must not contribute to statistics, loss, or gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class LogStandardizer:
    """Fit on (N, D) data with NaN for undefined entries; column-wise stats.

    ``log=True`` applies the paper's log transform before standardizing —
    used for runtimes (outputs) and for the layer-shape features (inputs),
    whose ranges span orders of magnitude (k, c in [1, 2048]).
    """

    log: bool = True
    mean_: Optional[np.ndarray] = None
    std_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "LogStandardizer":
        z = self._pre(np.asarray(x, np.float64))
        self.mean_ = np.nanmean(z, axis=0)
        std = np.nanstd(z, axis=0)
        # Constant columns (e.g. a primitive defined for a single stride)
        # standardize to zero instead of exploding.
        self.std_ = np.where(std < 1e-12, 1.0, std)
        return self

    def _pre(self, x: np.ndarray) -> np.ndarray:
        if self.log:
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.log(x)
        return x

    def transform(self, x: np.ndarray) -> np.ndarray:
        if self.mean_ is None:
            raise RuntimeError("fit() before transform()")
        z = self._pre(np.asarray(x, np.float64))
        return ((z - self.mean_) / self.std_).astype(np.float32)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def inverse(self, xt: np.ndarray) -> np.ndarray:
        if self.mean_ is None:
            raise RuntimeError("fit() before inverse()")
        z = np.asarray(xt, np.float64) * self.std_ + self.mean_
        return (np.exp(z) if self.log else z).astype(np.float64)

    # -- (de)serialization for checkpointing ------------------------------
    def to_dict(self) -> dict:
        return {"log": self.log,
                "mean": None if self.mean_ is None else self.mean_.tolist(),
                "std": None if self.std_ is None else self.std_.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "LogStandardizer":
        obj = cls(log=d["log"])
        obj.mean_ = None if d["mean"] is None else np.asarray(d["mean"], np.float64)
        obj.std_ = None if d["std"] is None else np.asarray(d["std"], np.float64)
        return obj


def mdrae(pred: np.ndarray, actual: np.ndarray) -> float:
    """Median relative absolute error |yhat - y| / y (paper §3.3), computed
    over defined entries only."""
    pred = np.asarray(pred, np.float64)
    actual = np.asarray(actual, np.float64)
    mask = np.isfinite(actual) & np.isfinite(pred) & (actual > 0)
    if not mask.any():
        return float("nan")
    rae = np.abs(pred[mask] - actual[mask]) / actual[mask]
    return float(np.median(rae))


def mdrae_per_column(pred: np.ndarray, actual: np.ndarray) -> np.ndarray:
    """Per-primitive MdRAE (paper Figs 4-6 are per-primitive bars)."""
    pred = np.asarray(pred, np.float64)
    actual = np.asarray(actual, np.float64)
    out = np.full(actual.shape[1], np.nan)
    for j in range(actual.shape[1]):
        out[j] = mdrae(pred[:, j], actual[:, j])
    return out
