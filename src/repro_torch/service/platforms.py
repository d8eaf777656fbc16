"""Platform abstraction — service layer L1 (DESIGN.md §7.1).

The paper's promise is that porting a CNN to a *new* computing system costs
seconds: profile a small sample, transfer the performance model (§4.4),
re-solve the PBQP. Before this layer, every example and benchmark hand-wired
``simulate_*_dataset`` → ``fit_perf_model`` → provider → ``select``; this
module makes "a platform" a first-class object with exactly three verbs:

  * ``profile(configs)`` / ``profile_dlt(pairs)`` — the expensive truth
    source (analytic simulator or a measured device, same matrix contract);
  * ``cost_provider()`` — ground-truth costs for selection/scoring;
  * ``calibrate(base_model, budget)`` — the §4.4 transfer path: profile a
    ``budget``-sized sample, factor-correct or fine-tune ``base_model``,
    return models ready for a ``ModelProvider``.

``pretrain()`` covers the native path (train from this platform's full
dataset). Both consult an ``ArtifactStore`` when given one, so repeat runs
warm-start in milliseconds instead of retraining (Table 4, operational).

The port of ``repro.service.platforms``. The simulated platforms (intel,
amd, arm) are ported in full, with the reference's model and selection
addresses, so a store the reference filled warm-starts the port and the
other way round. So is the simulated tile platform (``PallasPlatform``,
``tpu`` / ``pallas``), whose selections serve on the hand-written kernels,
and the measured host-CPU platform (``HostPlatform``). Models train on the
store's device, or without a store on an explicit ``device`` (``cuda`` by
default). The port adds a measured platform of its own, ``GpuPlatform``:
the card, with tile columns timed through the hand-written kernels.
"""
from __future__ import annotations

import abc
import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.autotune import (PALLAS_CONV_BASES, PallasTileProvider,
                                       conv_tile_time_batch,
                                       pallas_dlt_time_batch, pallas_columns)
from repro_torch.core.perfmodel import (FactorCorrectedModel, PerfModel,
                                        factor_correct, fit_perf_model)
from repro_torch.core.selection import (CostProvider, MeasuredProvider,
                                        ModelProvider, SimulatedProvider)
from repro_torch.kernels.matmul.ops import VARIANTS as MM_VARIANTS
from repro_torch.primitives.conv import (PRIMITIVE_NAMES, RUNNABLE,
                                         is_runnable, split_tile)
from repro_torch.profiler import device as device_profiler
from repro_torch.profiler import host, pools
from repro_torch.profiler.dataset import (PerfDataset, merge_served,
                                          simulate_dlt_dataset,
                                          simulate_primitive_dataset)
from repro_torch.profiler.simulators import (PLATFORMS, dlt_time_batch,
                                             primitive_time_batch)


# ---------------------------------------------------------------------------
# Model bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlatformModels:
    """A (primitive, DLT) performance-model pair bound to a platform —
    everything selection needs, plus provenance for artifact keying."""

    prim: PerfModel
    dlt: PerfModel
    platform: str                 # fingerprint of the platform they model
    mode: str                     # "native" | "factor" | "finetune"
    budget: Optional[float] = None   # calibration sample budget (None = full)
    warm: bool = False            # True = loaded from the artifact store
    seconds: float = 0.0          # wall time of pretrain()/calibrate()
    # how the calibration sample was composed when served observations were
    # reused (DESIGN.md §8.5): served vs freshly-profiled row counts etc.
    sample_info: Optional[Dict] = None

    def provider(self, columns: Optional[Sequence[str]] = None) -> ModelProvider:
        return ModelProvider(self.prim, self.dlt, columns=columns)

    def fingerprint(self) -> str:
        return f"{self.prim.fingerprint()}-{self.dlt.fingerprint()}"


# ---------------------------------------------------------------------------
# Platform interface
# ---------------------------------------------------------------------------

class Platform(abc.ABC):
    """One optimisation target: profile it (dearly), provide ground-truth
    costs, and calibrate a transferred performance model onto it."""

    name: str

    # -- profiling ---------------------------------------------------------
    @property
    @abc.abstractmethod
    def columns(self) -> List[str]:
        """Primitive columns this platform can profile."""

    @abc.abstractmethod
    def profile(self, configs: np.ndarray) -> np.ndarray:
        """(L, 5) configs -> (L, P) runtimes (NaN = inapplicable)."""

    @abc.abstractmethod
    def profile_dlt(self, pairs: np.ndarray) -> np.ndarray:
        """(M, 2) (c, im) pairs -> (M, 6) non-identity DLT runtimes."""

    @abc.abstractmethod
    def primitive_dataset(self) -> PerfDataset:
        """Full profiled primitive dataset (cached per instance)."""

    @abc.abstractmethod
    def dlt_dataset(self) -> PerfDataset:
        """Full profiled DLT dataset (cached per instance)."""

    # -- selection ---------------------------------------------------------
    @abc.abstractmethod
    def cost_provider(self) -> CostProvider:
        """Ground-truth cost provider (plays 'profiled on the device')."""

    @abc.abstractmethod
    def fingerprint(self) -> str:
        """Stable identity for artifact keys (config, not measurements)."""

    def pool_fingerprint(self) -> str:
        """Drift-invariant hardware identity for fleet calibration pooling
        (DESIGN.md §14.3). ``fingerprint()`` may deliberately move when the
        platform drifts (so post-drift calibration artifacts do not collide
        with pre-drift addresses); the pool key must NOT move, or a drifted
        host would publish evidence its healthy peers never find. Platforms
        whose fingerprint encodes drift state override this to return the
        stable part."""
        return self.fingerprint()

    def base_column(self, column: str) -> str:
        """Map one of this platform's columns onto the base-registry
        primitive a foreign base model would know it as: the tile suffix
        stripped (identity on a plain primitive), so a wide base model
        expands onto (primitive, tile) columns
        (``PerfModel.subset_columns(base_of=...)``)."""
        return split_tile(column)[0]

    # -- model path (shared) ----------------------------------------------
    def _model_fields(self, role: str, kind: str, **extra) -> dict:
        # ``backend`` (the platform's short name) is part of every model
        # address: two backends optimising the same network must never
        # collide on an artifact even if their fingerprints ever coincide
        ds = self.primitive_dataset() if role == "prim" else self.dlt_dataset()
        return {"platform": self.fingerprint(), "backend": self.name,
                "columns": list(ds.columns),
                "dataset": ds.fingerprint(), "model_kind": kind,
                "role": role, **extra}

    def pretrain_prim(self, kind: str = "nn2", *, store=None, seed: int = 0,
                      max_iters: int = 4000, patience: int = 250,
                      device="cuda") -> "Tuple[PerfModel, bool]":
        """Native primitive model: (model, warm). This is THE artifact
        address for a natively trained primitive model on this platform —
        benchmarks and ``pretrain`` route through it, so the same logical
        model is stored exactly once (ROADMAP "one keying scheme")."""
        device = _train_device(store, device)

        def train() -> PerfModel:
            tr, va, _ = self.primitive_dataset().split()
            return fit_perf_model(kind, tr.feats, tr.times, va.feats, va.times,
                                  columns=self.primitive_dataset().columns,
                                  seed=seed, max_iters=max_iters,
                                  patience=patience, device=device)

        return _get_or_train(
            store, self._model_fields("prim", kind, seed=seed,
                                      max_iters=max_iters, patience=patience,
                                      mode="native"),
            train)

    def pretrain_dlt(self, kind: str = "lin", *, store=None, seed: int = 0,
                     max_iters: int = 1500, device="cuda") -> "Tuple[PerfModel, bool]":
        """Native DLT model: (model, warm) — same single-address contract as
        ``pretrain_prim``."""
        return self._native_dlt(kind, seed, max_iters, store, device)

    def pretrain(self, kind: str = "nn2", *, store=None, seed: int = 0,
                 max_iters: int = 4000, patience: int = 250,
                 dlt_kind: str = "lin", dlt_max_iters: int = 1500,
                 device="cuda") -> PlatformModels:
        """Native path: train (or warm-load) performance models from this
        platform's full profiled dataset, on the store's device (without a
        store on ``device``)."""
        t0 = time.perf_counter()
        prim, prim_warm = self.pretrain_prim(kind, store=store, seed=seed,
                                             max_iters=max_iters,
                                             patience=patience, device=device)
        dlt, dlt_warm = self.pretrain_dlt(dlt_kind, store=store, seed=seed,
                                          max_iters=dlt_max_iters, device=device)
        return PlatformModels(prim, dlt, self.fingerprint(), "native",
                              warm=prim_warm and dlt_warm,
                              seconds=time.perf_counter() - t0)

    def calibrate(self, base: Union[PerfModel, PlatformModels],
                  budget: float = 0.01, *, mode: str = "auto", store=None,
                  sample=None, served=None, pooled=None, sample_n: int = 16,
                  seed: int = 0, max_iters: int = 2000,
                  patience: int = 150, dlt_kind: str = "lin",
                  dlt_max_iters: int = 1500, device="cuda") -> PlatformModels:
        """Transfer path (§4.4): profile a ``budget`` sample of this platform
        (fraction if < 1, row count if >= 1), then correct ``base`` onto it.

        ``mode``: "factor" multiplies per-primitive geometric-mean ratios
        (cheapest), "finetune" continues training at 10x-lowered LR, "auto"
        picks finetune when the sample is big enough to not overfit, and
        "scratch" ignores ``base`` and trains on the sample alone (the
        paper's transfer-study control).

        ``sample``: a caller-supplied ``PerfDataset`` of fresh measurements
        — the serving drift loop calibrates from what it just observed (see
        ``measure_sample``) instead of re-profiling the platform's cached
        pool, so a drifted platform is corrected from *post-drift* truth.
        ``budget`` is ignored when a sample is given.

        ``served``: attributed served-traffic observations
        (``observations_to_dataset``) — composed into the calibration sample
        via ``compose_sample`` (fresh profiling only for the ≤ ``sample_n``
        configs the serving buffer misses; ZERO profiling at full coverage).
        Served rows only measure assigned primitives, so "auto" resolves to
        factor correction with the pooled factor extended to unmeasured
        columns (``factor_correct(fill_missing=True)``).

        ``pooled``: fleet evidence — other hosts' published served-traffic
        datasets for this platform fingerprint
        (``ArtifactStore.pooled_drift``, DESIGN.md §14.3). Merged with
        ``served`` via ``merge_served`` before composition, so a host that
        observed nothing itself still calibrates from what the fleet saw.
        Deterministic: the merged sample's fingerprint keys the artifact,
        so two hosts pooling identical evidence warm-load byte-identical
        corrected models.

        Fine-tuned and scratch models train on the store's device, or on
        ``device`` without a store.
        """
        t0 = time.perf_counter()
        device = _train_device(store, device)
        sample_info = None
        pooled = [d for d in (pooled or []) if d is not None and d.n]
        if pooled:
            if sample is not None:
                raise ValueError("pass either sample= or pooled=, not both")
            merged = merge_served([served, *pooled] if served is not None
                                  else pooled)
            pool_info = {"pooled_sources": len(pooled),
                         "pooled_rows": int(sum(d.n for d in pooled))}
            served = merged
        else:
            pool_info = None
        if served is not None:
            if sample is not None:
                raise ValueError("pass either sample= or served=, not both")
            sample, sample_info = self.compose_sample(served, n=sample_n,
                                                      seed=seed)
            if pool_info:
                sample_info.update(pool_info)
            if mode == "auto":
                # finetune on rows that are NaN outside the assigned columns
                # would re-initialise every unmeasured head; the factor path
                # with fill_missing is the estimator that matches the data
                mode = "factor"
        base_prim = base.prim if isinstance(base, PlatformModels) else base
        # a wide base (e.g. the 49-column simulator model) transfers onto a
        # platform that profiles fewer primitives by slicing its output head
        # to this platform's columns — positions must match the sample matrix
        target_cols = (list(sample.columns) if sample is not None
                       else list(self.primitive_dataset().columns))
        if list(base_prim.columns) != target_cols:
            # base_of lets a plain-primitive base model expand onto this
            # platform's tile columns (each tile head starts as its base
            # primitive's head; calibration then differentiates the tiles)
            base_prim = base_prim.subset_columns(target_cols,
                                                 base_of=self.base_column)
        if sample is None:
            tr, va, _ = self.primitive_dataset().split()
            frac = budget if budget < 1 else min(1.0, budget / max(tr.n, 1))
            sample = tr.subsample(frac, seed=seed)
            va_feats, va_times = va.feats, va.times
        else:
            # fresh-measurement path: the sample doubles as the early-stop
            # set (re-profiling a validation pool would defeat its cheapness)
            budget = None
            va_feats, va_times = sample.feats, sample.times
        if mode == "auto":
            mode = "finetune" if sample.n >= 24 else "factor"
        if mode not in ("factor", "finetune", "scratch"):
            raise ValueError(f"unknown calibration mode {mode!r}")

        fill = sample_info is not None

        def train_prim() -> PerfModel:
            if mode == "factor":
                return factor_correct(base_prim, sample.feats, sample.times,
                                      fill_missing=fill)
            # fine-tuning continues gradient training, so a factor-corrected
            # base unwraps to the underlying trained network
            ft_base = (base_prim.base if isinstance(base_prim, FactorCorrectedModel)
                       else base_prim)
            return fit_perf_model(ft_base.kind, sample.feats, sample.times,
                                  va_feats, va_times,
                                  columns=target_cols,
                                  seed=seed,
                                  base=None if mode == "scratch" else ft_base,
                                  max_iters=max_iters, patience=patience,
                                  device=device)

        extra = dict(seed=seed, mode=mode, budget=budget,
                     sample=sample.fingerprint(), fill=fill,
                     base=None if mode == "scratch" else base_prim.fingerprint(),
                     max_iters=max_iters, patience=patience)
        if budget is None:
            # caller-supplied sample: key off the sample itself — touching
            # primitive_dataset() here would re-profile the platform pool
            fields = {"platform": self.fingerprint(), "backend": self.name,
                      "columns": target_cols,
                      "dataset": sample.fingerprint(),
                      "model_kind": base_prim.kind, "role": "prim", **extra}
        else:
            fields = self._model_fields("prim", base_prim.kind, **extra)
        prim, prim_warm = _get_or_train(store, fields, train_prim)
        # the DLT model is 2-feature/6-column — native training is cheap, so
        # it is not worth transferring; it is also independent of the
        # calibration sample, hence trained at a fixed seed and memoised
        dlt, dlt_warm = self._native_dlt(dlt_kind, 0, dlt_max_iters, store,
                                         device)
        return PlatformModels(prim, dlt, self.fingerprint(), mode,
                              budget=budget, warm=prim_warm and dlt_warm,
                              seconds=time.perf_counter() - t0,
                              sample_info=sample_info)

    def _sample_pool(self) -> Sequence:
        """Configs ``measure_sample`` may draw from — the platform's own
        profiling pool, so drift samples stay in-distribution for the model
        being corrected."""
        return pools.config_pool()

    def measure_sample(self, n: int = 16, seed: int = 0,
                       exclude: Optional[Sequence[Tuple]] = None) -> PerfDataset:
        """Freshly profile ``n`` layer configs drawn from this platform's
        pool — bypasses every dataset cache, so the measurements reflect the
        platform *as it is now*. This is the drift-recalibration input:
        cheap (n ≈ 16 ≈ the paper's 1% budget) and honest about drift.

        ``exclude``: config tuples to skip — the served-observation top-up
        path profiles only configs the serving buffer does NOT already
        cover. When fewer than ``n`` configs remain, all of them are taken.
        """
        cfgs = np.array(self._sample_pool(), np.int64)
        if exclude:
            skip = {tuple(map(int, c)) for c in exclude}
            keep = [i for i in range(len(cfgs))
                    if tuple(map(int, cfgs[i])) not in skip]
            cfgs = cfgs[keep]
            if not len(cfgs):
                raise ValueError("measure_sample: every pool config excluded")
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(cfgs), size=min(n, len(cfgs)), replace=False)
        sel = cfgs[np.sort(idx)]
        times = self.profile(sel)
        return PerfDataset(np.asarray(sel, np.float64), times,
                           list(self.columns), ["k", "c", "im", "s", "f"],
                           self.name)

    def compose_sample(self, served: PerfDataset, *, n: int = 16,
                       seed: int = 0) -> Tuple[PerfDataset, Dict]:
        """Build a calibration sample from served-traffic observations,
        topping up with fresh ``measure_sample`` profiling only for configs
        the serving buffer does not cover (DESIGN.md §8.5).

        ``served`` is the ``observations_to_dataset`` output: rows over the
        served network's layer configs, finite only at the assigned columns.
        Its columns are embedded into this platform's full column set;
        ``n - covered`` additional configs (if any) are freshly profiled from
        the pool, excluding the covered ones. When the buffer already covers
        ``n`` distinct configs the sample costs ZERO profiling.

        Returns ``(sample, info)`` where info records the served/fresh row
        mix — surfaced through ``PlatformModels.sample_info`` and the serving
        stats so the recalibration economics are observable.
        """
        cols = list(self.columns)
        unknown = sorted(set(served.columns) - set(cols))
        if unknown:
            raise ValueError(f"served columns {unknown} unknown to platform "
                             f"{self.fingerprint()!r}")
        embed = np.full((served.n, len(cols)), np.nan)
        for j, c in enumerate(served.columns):
            embed[:, cols.index(c)] = served.times[:, j]
        covered = {tuple(map(int, row)) for row in
                   np.asarray(served.feats, np.int64)}
        missing = max(int(n) - len(covered), 0)
        fresh_rows = 0
        feats, times = np.asarray(served.feats, np.float64), embed
        if missing > 0:
            fresh = self.measure_sample(missing, seed=seed,
                                        exclude=sorted(covered))
            fresh_rows = fresh.n
            feats = np.concatenate([feats, fresh.feats])
            times = np.concatenate([times, fresh.times])
        sample = PerfDataset(feats, times, cols,
                             ["k", "c", "im", "s", "f"], self.name)
        total = served.n + fresh_rows
        info = {"served_rows": int(served.n), "fresh_rows": int(fresh_rows),
                "served_fraction": served.n / total,
                "covered_configs": len(covered), "requested_n": int(n)}
        # surface the batch-shape mix the served rows came from (attached by
        # observations_to_dataset): recalibration reports can then show which
        # pow2 buckets — and how much per-bucket drift — fed the sample
        served_info = getattr(served, "served_info", None)
        if served_info:
            info["served"] = dict(served_info)
        return sample, info

    def invalidate_datasets(self) -> None:
        """Drop cached profiled datasets AND the DLT-model memo so the next
        profiling/calibration pass re-measures — e.g. after the platform is
        known to have drifted. (The memoised DLT models were trained on the
        pre-drift dataset; keeping them would skew the primitive-vs-DLT cost
        balance of every re-solved PBQP.)"""
        self._prim_ds = None
        self._dlt_ds = None
        self._dlt_models = {}

    def _native_dlt(self, kind: str, seed: int, max_iters: int, store,
                    device="cuda"):
        """Native DLT model, memoised per platform instance (one training
        per (kind, seed, iters) no matter how many calibrations ask, on
        whichever device it first trained or loaded)."""
        device = _train_device(store, device)
        memo = getattr(self, "_dlt_models", None)
        if memo is None:
            memo = self._dlt_models = {}
        key = (kind, seed, max_iters)
        if key in memo:
            return memo[key], True

        def train() -> PerfModel:
            ds = self.dlt_dataset()
            tr, va, _ = ds.split()
            return fit_perf_model(kind, tr.feats, tr.times, va.feats,
                                  va.times, columns=ds.columns, seed=seed,
                                  max_iters=max_iters, device=device)

        model, warm = _get_or_train(
            store, self._model_fields("dlt", kind, seed=seed,
                                      max_iters=max_iters, mode="native"),
            train)
        memo[key] = model
        return model, warm


def _train_device(store, device):
    """Where a model trains: the store's device, where it would warm-load
    (``device`` is for training without a store)."""
    return device if store is None else store.device


def _get_or_train(store, fields: dict, train_fn):
    """(model, warm) — through the artifact store when one is given."""
    if store is None:
        return train_fn(), False
    return store.get_or_train(fields, train_fn)


# ---------------------------------------------------------------------------
# Concrete platforms
# ---------------------------------------------------------------------------

class SimulatedPlatform(Platform):
    """Analytic platform simulator (intel/amd/arm) behind the Platform
    interface — full-scale datasets, deterministic noise, instant profiling.
    ``faults``: a ``serving.faults.FaultInjector`` whose ``profile`` hook
    (key ``"profile:<name>"``) can fail or corrupt profiling calls."""

    def __init__(self, name: str, *, noisy: bool = True,
                 max_triplets: Optional[int] = None,
                 time_scale: float = 1.0,
                 faults=None):
        if name not in PLATFORMS:
            raise KeyError(f"unknown simulated platform {name!r}; "
                           f"have {sorted(PLATFORMS)}")
        self.name = name
        self.noisy = noisy
        self.max_triplets = max_triplets
        # uniform slowdown applied to every simulated measurement — the
        # drift-experiment knob ("the machine got slower"). Mutable: bump it
        # mid-run, invalidate_datasets(), and re-profiling observes the
        # drifted platform. Relative primitive costs (and hence the optimal
        # assignment) are unchanged; absolute predictions scale.
        self.time_scale = time_scale
        self.faults = faults
        self._plat = PLATFORMS[name]
        self._prim_ds: Optional[PerfDataset] = None
        self._dlt_ds: Optional[PerfDataset] = None

    @property
    def columns(self) -> List[str]:
        return list(PRIMITIVE_NAMES)

    def profile(self, configs: np.ndarray) -> np.ndarray:
        times = self.time_scale * primitive_time_batch(
            self._plat, np.asarray(configs, np.int64), noisy=self.noisy)
        if self.faults is not None:
            times = self.faults.profile(self.name, times)
        return times

    def profile_dlt(self, pairs: np.ndarray) -> np.ndarray:
        times = self.time_scale * dlt_time_batch(
            self._plat, np.asarray(pairs, np.int64), noisy=self.noisy)
        if self.faults is not None:
            times = self.faults.profile(self.name, times)
        return times

    def primitive_dataset(self) -> PerfDataset:
        if self._prim_ds is None:
            ds = simulate_primitive_dataset(
                self.name, max_triplets=self.max_triplets, noisy=self.noisy)
            if self.time_scale != 1.0:
                ds = dataclasses.replace(ds, times=ds.times * self.time_scale)
            self._prim_ds = ds
        return self._prim_ds

    def dlt_dataset(self) -> PerfDataset:
        if self._dlt_ds is None:
            ds = simulate_dlt_dataset(self.name, noisy=self.noisy)
            if self.time_scale != 1.0:
                ds = dataclasses.replace(ds, times=ds.times * self.time_scale)
            self._dlt_ds = ds
        return self._dlt_ds

    def _sample_pool(self):
        return pools.config_pool(max_triplets=self.max_triplets)

    def cost_provider(self) -> SimulatedProvider:
        # note: unscaled — a uniform time_scale does not move the argmin, so
        # ground-truth *selection* is scale-invariant
        return SimulatedProvider(self.name, noisy=self.noisy)

    def fingerprint(self) -> str:
        fp = self.pool_fingerprint()
        if self.time_scale != 1.0:        # keep pre-drift addresses stable
            fp += f"/ts={self.time_scale:g}"
        return fp

    def pool_fingerprint(self) -> str:
        # drift (time_scale) moves the artifact fingerprint, not the machine
        # identity — fleet pooling keys off the stable part (§14.3)
        return f"sim/{self.name}/noisy={int(self.noisy)}/mt={self.max_triplets}"


class PallasPlatform(Platform):
    """The simulated tile platform behind the Platform interface: every
    column is a (runnable base primitive, tile variant) pair priced by the
    analytic tile-cost surface of ``core.autotune`` (pure numpy, like the
    simulated intel / amd / arm platforms), so the NN2 model and the PBQP
    select tile columns exactly like primitives. A plan compiled from its
    selection runs every tile column on the hand-written kernels.

    The reference's defaults: ``PALLAS_CONV_BASES`` x the matmul
    ``VARIANTS`` (40 columns), with its fingerprint, datasets and model
    addresses, so a store the reference filled warm-starts the port.
    ``variants`` may also name ``conv-bk*`` and ``wino-*`` variants, which
    the surface prices by their blocks."""

    def __init__(self, *, bases: Optional[Sequence[str]] = None,
                 variants: Optional[Sequence[str]] = None,
                 noisy: bool = True,
                 max_triplets: Optional[int] = None,
                 time_scale: float = 1.0,
                 name: str = "tpu"):
        self.name = name
        self.noisy = noisy
        self.max_triplets = max_triplets
        self.time_scale = time_scale   # drift knob, as on SimulatedPlatform
        self._bases = list(bases) if bases is not None else list(PALLAS_CONV_BASES)
        self._columns = pallas_columns(
            self._bases, list(variants) if variants is not None else list(MM_VARIANTS))
        self._prim_ds: Optional[PerfDataset] = None
        self._dlt_ds: Optional[PerfDataset] = None

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def profile(self, configs: np.ndarray) -> np.ndarray:
        return conv_tile_time_batch(np.asarray(configs, np.int64),
                                    self._columns, noisy=self.noisy,
                                    time_scale=self.time_scale)

    def profile_dlt(self, pairs: np.ndarray) -> np.ndarray:
        return pallas_dlt_time_batch(np.asarray(pairs, np.int64),
                                     noisy=self.noisy,
                                     time_scale=self.time_scale)

    def _sample_pool(self):
        return pools.config_pool(max_triplets=self.max_triplets)

    def primitive_dataset(self) -> PerfDataset:
        if self._prim_ds is None:
            cfgs = np.asarray(self._sample_pool(), np.int64)
            self._prim_ds = PerfDataset(
                cfgs.astype(np.float64), self.profile(cfgs),
                list(self._columns), ["k", "c", "im", "s", "f"], self.name)
        return self._prim_ds

    def dlt_dataset(self) -> PerfDataset:
        if self._dlt_ds is None:
            pairs = np.asarray(pools.dlt_pool(), np.int64)
            self._dlt_ds = PerfDataset(
                pairs.astype(np.float64), self.profile_dlt(pairs),
                device_profiler.dlt_columns(), ["c", "im"], self.name)
        return self._dlt_ds

    def cost_provider(self) -> PallasTileProvider:
        # unscaled, as on SimulatedPlatform: uniform drift moves no argmin
        return PallasTileProvider(self._columns, noisy=self.noisy)

    def fingerprint(self) -> str:
        fp = (f"pallas/{self.name}/cols={_columns_hash(self._columns)}"
              f"/noisy={int(self.noisy)}/mt={self.max_triplets}")
        if self.time_scale != 1.0:
            fp += f"/ts={self.time_scale:g}"
        return fp


def _columns_hash(columns: Sequence[str]) -> str:
    return hashlib.sha256("|".join(columns).encode()).hexdigest()[:8]


class _MeasuredPlatform(Platform):
    """A platform whose profiles are measurements on ``device``, reduced
    scale and genuinely expensive (the cost the paper eliminates).

    Datasets persist through ``store`` under a measurement-independent
    address (pool, repeats, columns, quantity, machine id), so runs
    warm-start across process restarts instead of re-measuring;
    ``invalidate_datasets`` drops the persisted ones too. A subclass names
    its quantities (``_QUANTITIES``, the first the dataset the models train
    on), measures them (``_measure``), and names its machine and label."""

    _QUANTITIES: Tuple[str, ...] = ("wall",)

    def __init__(self, *, configs, dlt_pairs, primitives, repeats, store, device):
        self.device = torch.device(device)
        self.repeats = repeats
        self.store = store
        self._primitives = list(primitives)
        self._configs = [tuple(map(int, c)) for c in configs] if configs is not None else None
        self._dlt_pairs = [tuple(map(int, p)) for p in dlt_pairs] if dlt_pairs is not None else None
        self._prim_ds: Optional[PerfDataset] = None
        self._dlt_ds: Optional[PerfDataset] = None
        self._by_quantity: Dict[str, Dict[str, PerfDataset]] = {}

    @property
    def columns(self) -> List[str]:
        return list(self._primitives)

    def profile(self, configs: np.ndarray) -> np.ndarray:
        return device_profiler.profile_primitive_batch(
            np.asarray(configs, int), self._primitives, repeats=self.repeats,
            device=self.device).wall

    def profile_dlt(self, pairs: np.ndarray) -> np.ndarray:
        return device_profiler.profile_dlt_batch(
            np.asarray(pairs, int), repeats=self.repeats,
            device=self.device).wall

    def _pool(self, role: str):
        """The configs (``prim``) or DLT pairs (``dlt``) to profile: the
        given ones, else the reference host platform's default pools."""
        if role == "prim":
            return (self._configs if self._configs is not None
                    else pools.config_pool(max_triplets=12))
        return (self._dlt_pairs if self._dlt_pairs is not None
                else pools.dlt_pool(max_pairs=12))

    def _sample_pool(self):
        return self._pool("prim")

    @abc.abstractmethod
    def _machine_id(self) -> str:
        """Identity of the measuring hardware, part of the dataset address."""

    @abc.abstractmethod
    def _label(self) -> str:
        """The fingerprint's first field."""

    @abc.abstractmethod
    def _measure(self, role: str) -> Dict[str, PerfDataset]:
        """Profile the ``role`` pool now: {quantity: dataset}."""

    def _dataset_fields(self, role: str, quantity: str) -> dict:
        """Measurement-independent dataset address: the pool that would be
        profiled, the repeat count, the columns, the quantity and the
        machine identity — NOT the measured times (those are what the
        address retrieves)."""
        return {"artifact": "perf_dataset", "role": role, "quantity": quantity,
                "machine": self._machine_id(), "repeats": self.repeats,
                "pool": [list(map(int, p)) for p in self._pool(role)],
                "primitives": self._primitives if role == "prim" else None}

    def _load(self, role: str) -> PerfDataset:
        """The training dataset of ``role`` (the other quantities kept
        beside it): from the store when it holds every quantity, else
        profiled now and stored."""
        fields = {q: self._dataset_fields(role, q) for q in self._QUANTITIES}
        got = None
        if self.store is not None:
            got = {q: self.store.get_dataset(f) for q, f in fields.items()}
            if any(d is None for d in got.values()):
                got = None
        if got is None:
            got = self._measure(role)
            if self.store is not None:
                for q, f in fields.items():
                    self.store.put_dataset(f, got[q])
        self._by_quantity[role] = got
        return got[self._QUANTITIES[0]]

    def primitive_dataset(self) -> PerfDataset:
        if self._prim_ds is None:
            self._prim_ds = self._load("prim")
        return self._prim_ds

    def dlt_dataset(self) -> PerfDataset:
        if self._dlt_ds is None:
            self._dlt_ds = self._load("dlt")
        return self._dlt_ds

    def invalidate_datasets(self) -> None:
        """Also drop the PERSISTED datasets: their address is
        measurement-independent, so without this the next profiling pass
        would warm-load the stale measurements from the store."""
        super().invalidate_datasets()
        self._by_quantity = {}
        if self.store is not None:
            for role in ("prim", "dlt"):
                for q in self._QUANTITIES:
                    self.store.delete("datasets", self._dataset_fields(role, q))

    def cost_provider(self) -> MeasuredProvider:
        return MeasuredProvider(repeats=self.repeats, columns=self._primitives,
                                device=self.device)

    def fingerprint(self) -> str:
        return f"{self._label()}/r={self.repeats}/cols={_columns_hash(self._primitives)}"


class GpuPlatform(_MeasuredPlatform):
    """The CUDA card behind the Platform interface — measured, reduced
    scale, genuinely expensive profiling (the cost the paper eliminates).

    The measured form of the reference's ``PallasPlatform``: ``primitives``
    may name base primitives and tile columns ``<base>@<variant>`` alike,
    the latter timed through the hand-written kernels a compiled plan
    launches (``profiler/device.py``). The default columns are the 21
    runnable primitives and the 55 tile columns of
    ``autotune.pallas_columns()``. ``base_column`` strips the tile suffix,
    so ``calibrate`` expands a base model over plain primitives onto the
    tile columns.

    Datasets persist through ``store`` (machine id ``device_machine_id``):
    the wall dataset the models train on and, beside it, the CUDA-event
    device times of the same calls (``device_dataset``). ``device``
    defaults to ``cuda``, and without a card the platform refuses to start;
    ``device="cpu"`` is for the tests.
    """

    name = "gpu"
    _QUANTITIES = ("wall", "device")

    def __init__(self, *, configs: Optional[Sequence] = None,
                 dlt_pairs: Optional[Sequence] = None,
                 primitives: Optional[Sequence[str]] = None,
                 repeats: int = 9, store=None, device="cuda"):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GpuPlatform profiles a CUDA device and none is "
                               "available (device='cpu' is for the tests)")
        primitives = (list(primitives) if primitives is not None
                      else list(RUNNABLE) + pallas_columns())
        unrunnable = [c for c in primitives if not is_runnable(c)]
        if unrunnable:
            raise ValueError(f"cannot profile columns {unrunnable}: not runnable")
        super().__init__(configs=configs, dlt_pairs=dlt_pairs,
                         primitives=primitives, repeats=repeats, store=store,
                         device=device)

    def _machine_id(self) -> str:
        return device_machine_id(self.device)

    def _label(self) -> str:
        return device_profiler.platform_label(self.device)

    def _measure(self, role: str) -> Dict[str, PerfDataset]:
        if role == "prim":
            t = device_profiler.profile_primitive_dataset(
                self._pool(role), primitives=self._primitives,
                repeats=self.repeats, device=self.device)
        else:
            t = device_profiler.profile_dlt_dataset(
                self._pool(role), repeats=self.repeats, device=self.device)
        return t._asdict()

    def device_dataset(self, role: str = "prim") -> PerfDataset:
        """CUDA-event device seconds of the calls behind the ``role``
        dataset (``prim`` or ``dlt``), profiled with it."""
        (self.primitive_dataset if role == "prim" else self.dlt_dataset)()
        return self._by_quantity[role]["device"]


class HostPlatform(_MeasuredPlatform):
    """This machine's CPU behind the Platform interface (the paper's own
    setting), measured through ``profiler/host.py`` — the reference's
    arguments, fingerprint (``host-cpu/r=…/cols=…``) and machine id
    (``host_machine_id``).

    Columns are the 21 runnable base primitives by default; a tile column
    raises ``ValueError`` (on the CPU it would run its base's plain
    version, one op timed under many names). The dataset address carries
    ``quantity`` (``wall``), which the reference's lacks, so a store shared
    with the reference never hands the port JAX timings, nor the reference
    torch ones. The platform measures the CPU because the caller named it:
    a plan selected from its costs serves on the server's device."""

    name = "host"

    def __init__(self, *, configs: Optional[Sequence] = None,
                 dlt_pairs: Optional[Sequence] = None,
                 primitives: Optional[Sequence[str]] = None,
                 repeats: int = 9, store=None):
        super().__init__(configs=configs, dlt_pairs=dlt_pairs,
                         primitives=host.base_columns(primitives),
                         repeats=repeats, store=store, device=host.CPU)

    def _machine_id(self) -> str:
        return host_machine_id()

    def _label(self) -> str:
        return host.LABEL

    def profile(self, configs: np.ndarray) -> np.ndarray:
        return host.profile_primitive_batch(np.asarray(configs, int),
                                            self._primitives,
                                            repeats=self.repeats)

    def profile_dlt(self, pairs: np.ndarray) -> np.ndarray:
        return host.profile_dlt_batch(np.asarray(pairs, int),
                                      repeats=self.repeats)

    def _measure(self, role: str) -> Dict[str, PerfDataset]:
        if role == "prim":
            return {"wall": host.profile_primitive_dataset(
                self._pool(role), primitives=self._primitives,
                repeats=self.repeats)}
        return {"wall": host.profile_dlt_dataset(self._pool(role),
                                                 repeats=self.repeats)}


def host_machine_id() -> str:
    """Stable identity of THIS machine for host-dataset addressing, as the
    reference forms it: hostname, machine architecture and core count."""
    import os
    import platform as _stdlib_platform
    u = _stdlib_platform.uname()
    return f"{u.node}/{u.machine}/cpus={os.cpu_count()}"


def device_machine_id(device="cuda") -> str:
    """Stable identity of the measuring device for dataset addressing: a
    profiled dataset is only valid on hardware that looks like the one that
    measured it — on a card its name, SM count and memory and the CUDA
    runtime; on the CPU the host (name, architecture, cores)."""
    device = torch.device(device)
    if device.type == "cuda":
        p = torch.cuda.get_device_properties(device)
        return (f"{p.name}/sms={p.multi_processor_count}"
                f"/mem={p.total_memory >> 20}MiB/cuda={torch.version.cuda}")
    import os
    import platform as _stdlib_platform
    u = _stdlib_platform.uname()
    return f"cpu/{u.node}/{u.machine}/cpus={os.cpu_count()}"


def get_platform(spec: Union[str, Platform], **kwargs) -> Platform:
    """'intel' / 'amd' / 'arm' -> SimulatedPlatform, 'tpu' / 'pallas' ->
    PallasPlatform, 'host' -> HostPlatform, 'gpu' -> GpuPlatform; a
    Platform instance passes through (kwargs then disallowed)."""
    if isinstance(spec, Platform):
        if kwargs:
            raise TypeError("cannot re-configure an existing Platform")
        return spec
    if spec == "gpu":
        return GpuPlatform(**kwargs)
    if spec == "host":
        return HostPlatform(**kwargs)
    if spec in ("tpu", "pallas"):
        return PallasPlatform(**kwargs)
    return SimulatedPlatform(spec, **kwargs)
