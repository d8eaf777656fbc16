"""Performance models (paper §3.3, Fig 3): NN1 (per-primitive MLP), NN2
(shared MLP over all primitives), and a linear-regression baseline — the
port of ``repro.core.perfmodel`` for inference.

The parameters are float32 tensors on an explicit device, kept in the
reference's layout: one ``{"w": (fan_in, fan_out), "b": (fan_out,)}`` dict
per layer, applied as ``x @ w + b``. So ``to_state``, ``save`` and
``fingerprint`` produce the reference's bytes, and a model saved by either
package loads in the other.

The public interface is numpy-in / numpy-out, as the reference's: the
optimisation pipeline (Fig 2) batches all layer configurations of a CNN in
one forward pass on the device.

Training is not ported yet: ``fit_perf_model``, ``train_mlp`` and
``init_mlp`` raise ``NotImplementedError``. This module serves models that
exist (committed artifacts, or a reference model carried over with
``convert.perfmodel_from_state``) and corrects them by ``factor_correct``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.normalize import LogStandardizer, mdrae, mdrae_per_column


def _untrained(name: str) -> None:
    """Training comes with the training slice; nothing here substitutes for
    it."""
    raise NotImplementedError(
        f"{name} trains a performance model; torch training is not ported "
        f"yet (the training slice: fit_perf_model, train/optim.py). Serve a "
        f"committed model (ArtifactStore) or correct one (factor_correct).")


# ---------------------------------------------------------------------------
# MLP core
# ---------------------------------------------------------------------------

def init_mlp(*args, **kwargs) -> list:
    _untrained("init_mlp")


def train_mlp(*args, **kwargs):
    _untrained("train_mlp")


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


@contextlib.contextmanager
def plain_fp32():
    """Plain fp32 matrix products for the duration: with TF32 the
    predictions move by ~1e-3 relative, enough to flip a selection, so
    prediction never inherits the caller's global precision setting."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# High-level performance models
# ---------------------------------------------------------------------------

# Paper Table 3 architectures. Input dim is 5 = (k, c, im, s, f) for
# primitives and 2 = (c, im) for data-layout transformations.
NN1_HIDDEN = (16, 64, 64, 16)
NN2_HIDDEN = (128, 512, 512, 128)


def _params_to(params: list, kind: str, device) -> list:
    move = lambda layers: [{k: v.to(device) for k, v in layer.items()}
                           for layer in layers]
    return [move(p) for p in params] if kind == "nn1" else move(params)


@dataclasses.dataclass
class PerfModel:
    """A trained performance estimator: features -> runtimes (seconds).

    ``kind`` in {"nn1", "nn2", "lin"}. NN1 is an ensemble (one MLP per output
    column); NN2 and Lin are single models over all columns. ``params`` are
    float32 tensors on one device (``device``); ``to(device)`` moves them.
    """

    kind: str
    in_norm: LogStandardizer
    out_norm: LogStandardizer
    params: list              # nn2/lin: one params list; nn1: list per column
    n_outputs: int
    columns: Sequence[str]
    train_seconds: float = 0.0

    @property
    def device(self) -> torch.device:
        first = self.params[0][0] if self.kind.endswith("nn1") else self.params[0]
        return first["w"].device

    def to(self, device="cuda") -> "PerfModel":
        """The same model with its parameters on ``device``."""
        if isinstance(self, FactorCorrectedModel):
            return FactorCorrectedModel(self.base.to(device), self.log_factor)
        return dataclasses.replace(self, params=_params_to(self.params, self.kind, device))

    # -- prediction --------------------------------------------------------
    def predict(self, feats: np.ndarray) -> np.ndarray:
        """(N, F) raw features -> (N, n_outputs) runtimes in seconds. The
        forward runs in fp32 on the model's device; normalisation runs on
        the host in the reference's dtypes (float64 in, float32 to the MLP,
        float64 out)."""
        feats = np.atleast_2d(np.asarray(feats, np.float64))
        xt = torch.from_numpy(self.in_norm.transform(feats)).to(self.device)
        with torch.no_grad(), plain_fp32():
            if self.kind == "nn1":
                yt = torch.cat([mlp_apply(p, xt) for p in self.params], dim=1)
            else:
                yt = mlp_apply(self.params, xt)
            y = yt.cpu().numpy()
        return self.out_norm.inverse(y)

    def predict_per_image(self, feats: np.ndarray,
                          column: Optional[str] = None, *,
                          bucket: Optional[int] = None,
                          head: Optional["BucketScaleHead"] = None) -> np.ndarray:
        """Per-image predicted seconds for (config, primitive) pairs, scaled
        by a :class:`BucketScaleHead` at the dispatch's pow2 ``bucket`` when
        both are given. ``column`` selects one primitive; otherwise all
        ``n_outputs`` columns are returned."""
        pred = self.predict(feats)
        if column is not None:
            pred = pred[:, list(self.columns).index(column)]
        if head is not None and bucket is not None:
            pred = pred * head.scale(bucket)
        return pred

    def mdrae(self, feats: np.ndarray, runtimes: np.ndarray) -> float:
        return mdrae(self.predict(feats), runtimes)

    def mdrae_per_column(self, feats: np.ndarray, runtimes: np.ndarray) -> np.ndarray:
        return mdrae_per_column(self.predict(feats), runtimes)

    def fingerprint(self) -> str:
        """Content hash of the serialised model (header + parameter bytes) —
        the identity used for artifact keying (``service.artifacts``), the
        reference's byte for byte. Wall-clock provenance (train_seconds) is
        excluded: two models with identical parameters hash identically."""
        state = self.to_state()
        header = {k: v for k, v in state["header"].items()
                  if k != "train_seconds"}
        h = hashlib.sha256(json.dumps(header, sort_keys=True).encode())
        for name in sorted(state["arrays"]):
            h.update(name.encode())
            h.update(np.ascontiguousarray(state["arrays"][name]).tobytes())
        return h.hexdigest()[:16]

    def subset_columns(self, columns: Sequence[str], *,
                       base_of: Optional[Callable[[str], str]] = None) -> "PerfModel":
        """A real PerfModel predicting only ``columns`` (same kind, sliced
        output layer / ensemble / normalizer) — used to transfer a wide base
        model onto a platform that profiles fewer primitives.

        ``base_of`` maps a requested column the model does not have onto one
        it does — the tile-column transfer path: a base model over plain
        primitives expands onto (primitive, tile-config) columns by
        duplicating each base head per tile. Output column names are the
        *requested* names; duplicate head indices are allowed."""
        model_cols = list(self.columns)
        pos = {c: j for j, c in enumerate(model_cols)}

        def lookup(c: str) -> int:
            if c in pos:
                return pos[c]
            if base_of is not None:
                b = base_of(c)
                if b in pos:
                    return pos[b]
            return -1

        idx_list = [lookup(c) for c in columns]
        missing = [c for c, j in zip(columns, idx_list) if j < 0]
        if missing:
            raise ValueError(f"model has no columns {missing}")
        idx = np.asarray(idx_list)
        if list(columns) == model_cols:
            return self

        out_d = self.out_norm.to_dict()
        for k in ("mean", "std"):
            if out_d.get(k) is not None:
                out_d[k] = np.asarray(out_d[k])[idx].tolist()
        out_norm = type(self.out_norm).from_dict(out_d)

        if isinstance(self, FactorCorrectedModel):
            return FactorCorrectedModel(
                base=self.base.subset_columns(columns, base_of=base_of),
                log_factor=np.asarray(self.log_factor)[idx])
        if self.kind == "nn1":
            params = [self.params[j] for j in idx]
        else:
            head = self.params[-1]
            sel = torch.from_numpy(idx).to(head["w"].device)
            params = list(self.params[:-1]) + [
                {"w": head["w"][:, sel], "b": head["b"][sel]}]
        return PerfModel(kind=self.kind, in_norm=self.in_norm,
                         out_norm=out_norm, params=params,
                         n_outputs=len(idx), columns=list(columns),
                         train_seconds=self.train_seconds)

    # -- (de)serialization -------------------------------------------------
    #
    # On-disk format (the reference's): a single ``.npz`` whose
    # ``__header__`` entry is a JSON document (kind, columns, normalizers,
    # format version) and whose other entries are the parameter arrays:
    #   nn2/lin:    ``l{i}.w`` / ``l{i}.b``          (layer i)
    #   nn1:        ``c{j}.l{i}.w`` / ``c{j}.l{i}.b`` (column j, layer i)
    #   factor-*:   base arrays plus ``log_factor``
    # No pickle anywhere.

    _FORMAT = "perfmodel-npz-v1"

    def _named_arrays(self) -> Dict[str, np.ndarray]:
        host = lambda t: np.ascontiguousarray(t.detach().cpu().numpy())
        out: Dict[str, np.ndarray] = {}
        kind = self.kind
        if kind.startswith("factor-"):
            kind = kind[len("factor-"):]
        if kind == "nn1":
            for j, col_params in enumerate(self.params):
                for i, layer in enumerate(col_params):
                    out[f"c{j}.l{i}.w"] = host(layer["w"])
                    out[f"c{j}.l{i}.b"] = host(layer["b"])
        else:
            for i, layer in enumerate(self.params):
                out[f"l{i}.w"] = host(layer["w"])
                out[f"l{i}.b"] = host(layer["b"])
        return out

    def to_state(self) -> dict:
        """JSON header + named numpy arrays (the save() payload, exposed for
        fingerprinting and tests) — the reference's ``to_state``."""
        header = {
            "format": self._FORMAT,
            "kind": self.kind,
            "n_outputs": int(self.n_outputs),
            "columns": list(self.columns),
            "in_norm": self.in_norm.to_dict(),
            "out_norm": self.out_norm.to_dict(),
            "train_seconds": float(self.train_seconds),
        }
        arrays = self._named_arrays()
        if isinstance(self, FactorCorrectedModel):
            arrays["log_factor"] = np.asarray(self.log_factor, np.float64)
        return {"header": header, "arrays": arrays}

    def save(self, path: str) -> None:
        state = self.to_state()
        payload = dict(state["arrays"])
        payload["__header__"] = np.frombuffer(
            json.dumps(state["header"], sort_keys=True).encode(), np.uint8)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    @staticmethod
    def _params_from_arrays(kind: str, data: Dict[str, np.ndarray],
                            device) -> list:
        def t(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.array(a, order="C")).to(device)

        def layer_count(prefix: str) -> int:
            i = 0
            while f"{prefix}l{i}.w" in data:
                i += 1
            return i

        if kind == "nn1":
            params, j = [], 0
            while f"c{j}.l0.w" in data:
                params.append([{"w": t(data[f"c{j}.l{i}.w"]),
                                "b": t(data[f"c{j}.l{i}.b"])}
                               for i in range(layer_count(f"c{j}."))])
                j += 1
            return params
        return [{"w": t(data[f"l{i}.w"]), "b": t(data[f"l{i}.b"])}
                for i in range(layer_count(""))]

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "PerfModel":
        """Rebuild a model from ``to_state()`` output (either package's),
        parameters on ``device``."""
        header, data = state["header"], state["arrays"]
        if header.get("format") != cls._FORMAT:
            raise ValueError(f"unsupported perf-model format "
                             f"{header.get('format')!r}")
        kind = header["kind"]
        base_kind = kind[len("factor-"):] if kind.startswith("factor-") else kind
        model = PerfModel(
            kind=base_kind,
            in_norm=LogStandardizer.from_dict(header["in_norm"]),
            out_norm=LogStandardizer.from_dict(header["out_norm"]),
            params=cls._params_from_arrays(base_kind, data, device),
            n_outputs=header["n_outputs"],
            columns=header["columns"],
            train_seconds=header.get("train_seconds", 0.0))
        if kind.startswith("factor-"):
            model = FactorCorrectedModel(base=model,
                                         log_factor=data["log_factor"])
        return model

    @classmethod
    def load(cls, path: str, device="cuda") -> "PerfModel":
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        header = json.loads(bytes(data.pop("__header__")).decode())
        return cls.from_state({"header": header, "arrays": data}, device)


def fit_perf_model(*args, **kwargs) -> PerfModel:
    _untrained("fit_perf_model")


# ---------------------------------------------------------------------------
# Factor correction (paper §4.4 "Factor Intel")
# ---------------------------------------------------------------------------

def factor_correct(base: PerfModel,
                   feats_sample: np.ndarray,
                   runtimes_sample: np.ndarray,
                   fill_missing: bool = False) -> PerfModel:
    """Per-primitive multiplicative output correction estimated from a small
    sample of target-platform measurements (paper uses 1% ≈ 25 points).
    Returns a model whose predictions are ``base_prediction * factor[j]``.
    The factor is the geometric-mean runtime ratio per column, the MMSE
    estimator in log space.

    ``fill_missing``: columns with no finite sample entry get the mean log
    factor of the columns that have one, instead of staying uncorrected
    (served-traffic samples measure only the assigned primitives)."""
    pred = base.predict(feats_sample)
    actual = np.asarray(runtimes_sample, np.float64)
    n_out = actual.shape[1]
    log_factor = np.zeros(n_out)
    observed = np.zeros(n_out, bool)
    for j in range(n_out):
        m = np.isfinite(actual[:, j]) & np.isfinite(pred[:, j]) & (pred[:, j] > 0)
        if m.any():
            log_factor[j] = np.mean(np.log(actual[m, j]) - np.log(pred[m, j]))
            observed[j] = True
    if fill_missing and observed.any() and not observed.all():
        log_factor[~observed] = np.mean(log_factor[observed])
    if isinstance(base, FactorCorrectedModel):
        # re-correction composes factors on the underlying trained model
        # instead of nesting wrapper on wrapper
        return FactorCorrectedModel(base=base.base,
                                    log_factor=base.log_factor + log_factor)
    return FactorCorrectedModel(base=base, log_factor=log_factor)


@dataclasses.dataclass
class FactorCorrectedModel(PerfModel):
    """PerfModel wrapper applying per-column multiplicative correction
    (``log_factor`` float64, applied on the host)."""
    base: PerfModel = None
    log_factor: np.ndarray = None

    def __init__(self, base: PerfModel, log_factor: np.ndarray):
        super().__init__(kind=f"factor-{base.kind}", in_norm=base.in_norm,
                         out_norm=base.out_norm, params=base.params,
                         n_outputs=base.n_outputs, columns=base.columns)
        self.base = base
        self.log_factor = log_factor

    def predict(self, feats: np.ndarray) -> np.ndarray:
        return self.base.predict(feats) * np.exp(self.log_factor)[None, :]


@dataclasses.dataclass(frozen=True)
class BucketScaleHead:
    """Per-pow2-bucket scale head: the batch-shape correction on top of a
    per-image perf model (a copy of the reference's, numpy only).

    A log-space multiplier per observed bucket, fitted from the
    served-traffic buffer, normalised so the count-weighted mean log scale
    is zero. Unseen buckets interpolate linearly in log2(bucket) space and
    clamp at the observed ends."""

    log2_buckets: np.ndarray       # (B,) sorted log2 of observed pow2 buckets
    log_scale: np.ndarray          # (B,) log multiplier per bucket

    def __post_init__(self):
        lb = np.asarray(self.log2_buckets, np.float64)
        ls = np.asarray(self.log_scale, np.float64)
        if lb.shape != ls.shape or lb.ndim != 1 or lb.size == 0:
            raise ValueError(f"bucket/scale shape mismatch: {lb.shape} vs "
                             f"{ls.shape}")
        if not (np.isfinite(lb).all() and np.isfinite(ls).all()):
            raise ValueError("non-finite bucket scale head")
        if np.any(np.diff(lb) <= 0):
            raise ValueError("buckets must be strictly increasing")
        object.__setattr__(self, "log2_buckets", lb)
        object.__setattr__(self, "log_scale", ls)

    def scale(self, bucket: int) -> float:
        """Relative per-image cost multiplier at pow2 ``bucket``."""
        x = np.log2(max(int(bucket), 1))
        return float(np.exp(np.interp(x, self.log2_buckets, self.log_scale)))

    def buckets(self) -> list:
        return [int(b) for b in np.round(2.0 ** self.log2_buckets)]

    @classmethod
    def fit(cls, observations, *, alpha: float = 0.5,
            normalize: bool = True,
            min_obs: int = 1) -> Optional["BucketScaleHead"]:
        """Fit from ``(bucket, log_ratio)`` pairs, oldest → newest: per
        bucket an exponentially-weighted mean; buckets with fewer than
        ``min_obs`` entries are dropped. None when nothing (finite) was
        observed."""
        ew: Dict[int, float] = {}
        counts: Dict[int, int] = {}
        for bucket, log_r in observations:
            b = int(bucket)
            r = float(log_r)
            if b < 1 or not np.isfinite(r):
                continue
            ew[b] = r if b not in ew else ew[b] + alpha * (r - ew[b])
            counts[b] = counts.get(b, 0) + 1
        kept = sorted(b for b in ew if counts[b] >= max(int(min_obs), 1))
        if not kept:
            return None
        vals = np.asarray([ew[b] for b in kept], np.float64)
        if normalize:
            w = np.asarray([counts[b] for b in kept], np.float64)
            vals = vals - float(np.average(vals, weights=w))
        return cls(log2_buckets=np.log2(np.asarray(kept, np.float64)),
                   log_scale=vals)
