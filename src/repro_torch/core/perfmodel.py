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

Training runs on the same explicit device (``fit_perf_model(...,
device=)``), in plain fp32 as prediction does: Adam with early stopping
(``train_mlp``, paper Table 3) on a masked MSE whose undefined entries have
zero value and gradient. Initial parameters are drawn on a CPU
``torch.Generator`` and then moved, so the card and the CPU start from the
same parameters; minibatches come from the reference's
``np.random.default_rng(0)`` stream. A torch fit cannot equal a JAX fit bit
for bit (``jax.random`` draws the reference's initial parameters), but from
the same initial parameters it follows the reference's trajectory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.normalize import LogStandardizer, mdrae, mdrae_per_column
from repro_torch.train import optim as optim_lib
from repro_torch.train.optim import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# MLP core
# ---------------------------------------------------------------------------

def generator_for(seed: int, column: Optional[int] = None) -> torch.Generator:
    """The CPU generator initial parameters are drawn from: ``seed`` itself
    for a single network (nn2), and for column ``j`` of an nn1 ensemble the
    first 64-bit word of ``np.random.SeedSequence([seed, j])``, so every
    column has its own stream (the reference splits ``PRNGKey(seed)`` into
    one key per column)."""
    if column is None:
        return torch.Generator().manual_seed(int(seed))
    word = np.random.SeedSequence([int(seed), int(column)]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(word))


def init_mlp(sizes: Sequence[int], *, generator: torch.Generator,
             device="cuda") -> list:
    """He-initialised fully connected network ``sizes[0] -> ... -> sizes[-1]``
    in the reference's ``(fan_in, fan_out)`` layout, zero biases. Drawn on
    the CPU ``generator``, then moved to ``device``."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(fan_in, fan_out, generator=generator) * np.sqrt(2.0 / fan_in)
        params.append({"w": w.to(device), "b": torch.zeros(fan_out, device=device)})
    return params


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def masked_mse(params: list, x: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """MSE over defined entries only. ``y`` must already have NaNs replaced by
    zeros (any finite value works; the mask kills their contribution AND their
    gradient, exactly as the paper's masking does)."""
    se = torch.square(mlp_apply(params, x) - y) * mask
    return torch.sum(se) / torch.clamp(torch.sum(mask), min=1.0)


@contextlib.contextmanager
def plain_fp32():
    """Plain fp32 matrix products for the duration: with TF32 the
    predictions move by ~1e-3 relative, enough to flip a selection, so
    neither training nor prediction inherits the caller's global precision
    setting."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# Training loop with early stopping (paper Table 3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainResult:
    params: list
    train_losses: list
    val_losses: list
    best_val: float
    iterations: int
    seconds: float


_INDEX_CHUNK = 256          # minibatch index rows uploaded at a time


def _clone(params: list) -> list:
    return tree_map(lambda t: t.detach().clone(), params)


def train_mlp(sizes: Sequence[int],
              x_train: np.ndarray, y_train: np.ndarray,
              x_val: np.ndarray, y_val: np.ndarray,
              lr: float = 1e-3,
              weight_decay: float = 1e-5,
              batch_size: int = 1024,
              patience: int = 250,
              max_iters: int = 20000,
              init_params: Optional[list] = None,
              eval_every: int = 20,
              generator: Optional[torch.Generator] = None,
              device="cuda") -> TrainResult:
    """Adam + early stopping ("halt when validation has not improved for 250
    iterations", paper Table 3) on ``device``, in plain fp32.
    ``init_params`` given => fine-tuning (callers pass the lowered lr); they
    are copied, never trained in place. Otherwise the network starts from
    ``init_mlp(sizes, generator=generator)`` (``generator_for(0)`` if none).

    The data go to the device once; each step indexes them there with the
    reference's minibatch indices (``np.random.default_rng(0)``, drawn in
    the reference's order and uploaded ``_INDEX_CHUNK`` steps at a time).
    The host reads a loss only every ``eval_every`` steps."""
    t0 = time.perf_counter()

    def upload(a: np.ndarray, dtype=np.float32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    mask_train, mask_val = (upload(np.isfinite(y)) for y in (y_train, y_val))
    y_tr, y_va = (upload(np.nan_to_num(y, nan=0.0)) for y in (y_train, y_val))
    x_tr, x_va = upload(x_train), upload(x_val)

    if init_params is not None:
        params = tree_map(lambda t: t.detach().to(device).clone(), init_params)
    else:
        params = init_mlp(sizes, generator=generator or generator_for(0),
                          device=device)
    opt = optim_lib.adamw(lr, weight_decay=weight_decay)
    opt_state = opt.init(params)

    n = x_train.shape[0]
    bs = min(batch_size, n)
    rng = np.random.default_rng(0)
    best_val, best_params, best_iter = np.inf, _clone(params), 0
    train_losses, val_losses = [], []
    it, chunk, chunk_at = 0, None, 0
    with plain_fp32():
        while it < max_iters:
            if chunk is None or it - chunk_at == len(chunk):
                rows = min(_INDEX_CHUNK, max_iters - it)
                chunk = upload(np.stack([rng.integers(0, n, size=bs)
                                         for _ in range(rows)]), np.int64)
                chunk_at = it
            idx = chunk[it - chunk_at]
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss = masked_mse(params, x_tr[idx], y_tr[idx], mask_train[idx])
            grads = iter(torch.autograd.grad(loss, leaves))
            params, opt_state = opt.update(
                params, tree_map(lambda _: next(grads), params), opt_state)
            it += 1
            if it % eval_every == 0 or it == 1:
                with torch.no_grad():
                    vl = float(masked_mse(params, x_va, y_va, mask_val))
                train_losses.append(float(loss.detach()))
                val_losses.append(vl)
                if vl < best_val - 1e-7:
                    # updates make new tensors, but a clone keeps the best
                    # parameters safe from any later in-place change
                    best_val, best_params, best_iter = vl, _clone(params), it
                elif it - best_iter > patience:
                    break
    return TrainResult(best_params, train_losses, val_losses, float(best_val),
                       it, time.perf_counter() - t0)


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
    # Adam steps the fit ran (nn1: summed over columns; None for lin and
    # for a loaded model). Provenance only: not part of the saved state.
    train_iterations: Optional[int] = None

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


def _prep(feats, runtimes, in_norm=None, out_norm=None):
    feats = np.asarray(feats, np.float64)
    runtimes = np.asarray(runtimes, np.float64)
    if in_norm is None:
        in_norm = LogStandardizer(log=True).fit(feats)
    if out_norm is None:
        out_norm = LogStandardizer(log=True).fit(runtimes)
    return in_norm, out_norm, in_norm.transform(feats), out_norm.transform(runtimes)


def fit_perf_model(kind: str,
                   feats_train: np.ndarray, runtimes_train: np.ndarray,
                   feats_val: np.ndarray, runtimes_val: np.ndarray,
                   columns: Optional[Sequence[str]] = None,
                   seed: int = 0,
                   base: Optional[PerfModel] = None,
                   lr: Optional[float] = None,
                   max_iters: int = 20000,
                   patience: int = 250,
                   device="cuda") -> PerfModel:
    """Train a performance model of ``kind`` in {"lin", "nn1", "nn2"} with
    its parameters on ``device``.

    ``base`` given => transfer learning: reuse base normalizers and start
    from base params with LR lowered 10x (paper §4.4) unless ``lr`` is set.
    "lin" is the reference's closed-form ridge in numpy, cast to float32, so
    its fingerprint is the reference's. nn2 draws its initial parameters
    from ``generator_for(seed)``, nn1 column ``j`` from
    ``generator_for(seed, j)``. As in the reference, an nn1 column with
    fewer than 8 defined rows keeps its initial (untrained) network.
    """
    t0 = time.perf_counter()
    n_out = np.asarray(runtimes_train).shape[1]
    columns = list(columns) if columns is not None else [f"p{i}" for i in range(n_out)]
    in_norm = base.in_norm if base is not None else None
    out_norm = base.out_norm if base is not None else None
    in_norm, out_norm, xt, yt = _prep(feats_train, runtimes_train, in_norm, out_norm)
    xv = in_norm.transform(feats_val)
    yv = out_norm.transform(runtimes_val)

    if kind == "lin":
        # Closed-form ridge per column on defined rows (baseline model).
        lam = 1e-6
        X = np.concatenate([xt, np.ones((xt.shape[0], 1), np.float32)], axis=1)
        W = np.zeros((X.shape[1], n_out), np.float64)
        for j in range(n_out):
            m = np.isfinite(yt[:, j])
            if m.sum() < X.shape[1]:
                continue
            A = X[m].astype(np.float64)
            b = yt[m, j].astype(np.float64)
            W[:, j] = np.linalg.solve(A.T @ A + lam * np.eye(A.shape[1]), A.T @ b)
        f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        params = [{"w": f32(W[:-1]), "b": f32(W[-1])}]
        return PerfModel("lin", in_norm, out_norm, params, n_out, columns,
                         train_seconds=time.perf_counter() - t0)

    if kind == "nn2":
        sizes = (xt.shape[1],) + NN2_HIDDEN + (n_out,)
        lr_eff = lr if lr is not None else (1e-4 if base is not None else 1e-3)
        res = train_mlp(sizes, xt, yt, xv, yv, lr=lr_eff, weight_decay=1e-5,
                        init_params=None if base is None else base.params,
                        max_iters=max_iters, patience=patience,
                        generator=generator_for(seed), device=device)
        return PerfModel("nn2", in_norm, out_norm, res.params, n_out, columns,
                         train_seconds=time.perf_counter() - t0,
                         train_iterations=res.iterations)

    if kind == "nn1":
        # One small MLP per output column; single hyper-parameter set across
        # all models (paper §4.2). Base model => per-column fine-tune.
        sizes = (xt.shape[1],) + NN1_HIDDEN + (1,)
        lr_eff = lr if lr is not None else (3e-4 if base is not None else 3e-3)
        params, steps = [], 0
        for j in range(n_out):
            yj = yt[:, j:j + 1]
            yvj = yv[:, j:j + 1]
            m = np.isfinite(yj[:, 0])
            if m.sum() < 8:  # too few points: the reference keeps the init
                params.append(init_mlp(sizes, generator=generator_for(seed, j),
                                       device=device))
                continue
            init_p = base.params[j] if base is not None else None
            mv = np.isfinite(yvj[:, 0])
            res = train_mlp(sizes, xt[m], yj[m], xv[mv], yvj[mv], lr=lr_eff,
                            weight_decay=0.0, init_params=init_p,
                            max_iters=max_iters, patience=patience,
                            generator=generator_for(seed, j), device=device)
            params.append(res.params)
            steps += res.iterations
        return PerfModel("nn1", in_norm, out_norm, params, n_out, columns,
                         train_seconds=time.perf_counter() - t0,
                         train_iterations=steps)

    raise ValueError(f"unknown perf model kind {kind!r}")


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
