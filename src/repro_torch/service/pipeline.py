"""The profile → model → select pipeline as one call (DESIGN.md §7) — the
port of ``repro.service.pipeline``.

``optimise(net, platform)`` is the deployment loop the paper argues for:
arrive on a platform, obtain performance models (warm-loaded from an
``ArtifactStore``, or calibrated from another platform's base model), solve
the PBQP, and hand back an assignment ready for the plan compiler and the
server. The models train and predict on the store's device
(``ArtifactStore(..., device=)``), or without a store on ``device``. Model
and selection addresses are the reference's, so what either package stored
warm-starts the other. ``OptimisedNetwork.from_assignment`` wraps an
assignment made elsewhere (a heuristic baseline, a hand-written plan) for
serving.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Dict, List, Optional, Union

from repro_torch.core.perfmodel import PerfModel
from repro_torch.core.selection import SelectionResult, select
from repro_torch.models import cnn_zoo
from repro_torch.models.cnn_zoo import CNNSpec, ConvLayer
from repro_torch.primitives.conv import is_runnable
from repro_torch.service.artifacts import ArtifactStore
from repro_torch.service.platforms import Platform, PlatformModels, get_platform


@dataclasses.dataclass
class OptimisedNetwork:
    """Everything downstream layers need about one optimised network."""

    net: str
    spec: CNNSpec
    platform: Optional[Platform]      # None for an assignment made elsewhere
    models: Optional[PlatformModels]
    assignment: Dict[int, str]        # node idx -> primitive / layout
    columns: List[str]                # columns selection chose from
    predicted_cost_s: float           # model-predicted per-image runtime
    selection: Optional[SelectionResult]   # None when warm-loaded
    warm_models: bool
    warm_selection: bool
    seconds: float                    # total optimise() wall time

    @property
    def warm(self) -> bool:
        return self.warm_models and self.warm_selection

    def predict_per_image(self, bucket: Optional[int] = None,
                          head=None) -> float:
        """Model-predicted per-image runtime, optionally scaled for the pow2
        batch ``bucket`` by a fitted bucket-scale ``head`` (anything with
        ``scale(bucket)``). Without one this is ``predicted_cost_s``."""
        cost = self.predicted_cost_s
        if head is not None and bucket is not None and math.isfinite(cost):
            cost *= head.scale(bucket)
        return cost

    @classmethod
    def from_assignment(cls, spec: CNNSpec, assignment: Dict[int, str], *,
                        net: Optional[str] = None,
                        platform: Optional[Platform] = None,
                        models: Optional[PlatformModels] = None,
                        predicted_cost_s: float = float("nan"),
                        columns: Optional[List[str]] = None) -> "OptimisedNetwork":
        """Wrap an externally-produced assignment (a selection made
        elsewhere, heuristic baselines, hand-written plans) for serving."""
        return cls(net=net or spec.name, spec=spec, platform=platform,
                   models=models, assignment=dict(assignment),
                   columns=list(columns) if columns else [],
                   predicted_cost_s=predicted_cost_s, selection=None,
                   warm_models=False, warm_selection=False, seconds=0.0)


def safe_assignment(spec: CNNSpec) -> Dict[int, str]:
    """A reference-only assignment: direct summation for every conv (the
    pointwise GEMM for 1x1 layers), ``chw`` joins, no layout tricks and no
    tile columns — so no hand-written kernel runs under it."""
    return {i: (("conv-1x1-gemm-ab-ki" if node.f == 1 else "direct-sum2d")
                if isinstance(node, ConvLayer) else "chw")
            for i, node in enumerate(spec.nodes)}


def _spec_fingerprint(spec: CNNSpec) -> str:
    """Content hash of the network topology — selection artifacts must go
    stale when a zoo net's definition changes, not just when models do."""
    blob = repr((spec.name, [dataclasses.astuple(n) for n in spec.nodes],
                 sorted(spec.edges)))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _executable_columns(model: PerfModel) -> List[str]:
    # is_runnable (not RUNNABLE membership): tile columns like
    # "winograd-2x2-3x3@mm-128x128x128" lower onto the hand-written kernels,
    # so they are servable too
    cols = [c for c in model.columns if is_runnable(c)]
    if not cols:
        raise ValueError("model has no runnable columns; cannot build an "
                         "executable assignment")
    return cols


def optimise(net: Union[str, CNNSpec],
             platform: Union[str, Platform],
             *,
             store: Optional[ArtifactStore] = None,
             models: Optional[PlatformModels] = None,
             base: Optional[Union[PerfModel, PlatformModels]] = None,
             budget: float = 0.01,
             mode: str = "auto",
             kind: str = "nn2",
             executable: bool = False,
             seed: int = 0,
             max_iters: Optional[int] = None,
             device="cuda",
             **platform_kwargs) -> OptimisedNetwork:
    """Optimise ``net`` for ``platform`` end to end.

    * ``models`` given => reuse already-obtained performance models.
    * ``base`` given => transfer path: ``platform.calibrate(base, budget,
      mode)`` (paper §4.4) instead of native pretraining.
    * ``store`` given => models AND the selection warm-start from disk when
      the same (platform, columns, dataset, model) was optimised before.
    * ``executable=True`` restricts selection to runnable primitives so the
      assignment can be compiled and served.

    Models come from the store on its device; a store miss trains them
    there. Without a store they train on ``device``.
    """
    t0 = time.perf_counter()
    platform = get_platform(platform, **platform_kwargs)
    spec = cnn_zoo.get(net) if isinstance(net, str) else net
    net_name = spec.name

    # max_iters=None defers to each verb's own default (pretrain 4000,
    # calibrate 2000); an explicit value is honoured verbatim
    iters = {} if max_iters is None else {"max_iters": max_iters}
    if models is None:
        if base is not None:
            models = platform.calibrate(base, budget, mode=mode, store=store,
                                        seed=seed, device=device, **iters)
        else:
            models = platform.pretrain(kind, store=store, seed=seed,
                                       device=device, **iters)

    columns = _executable_columns(models.prim) if executable else list(models.prim.columns)
    provider = models.provider(columns=columns if executable else None)

    sel_fields = {"artifact": "selection", "net": net_name,
                  "spec": _spec_fingerprint(spec),
                  "platform": platform.fingerprint(),
                  "backend": platform.name,
                  "models": models.fingerprint(), "columns": columns}
    stored = store.get_json("selections", sel_fields) if store else None
    if stored is not None:
        assignment = {int(k): v for k, v in stored["assignment"].items()}
        return OptimisedNetwork(
            net=net_name, spec=spec, platform=platform, models=models,
            assignment=assignment, columns=columns,
            predicted_cost_s=stored["predicted_cost_s"], selection=None,
            warm_models=models.warm, warm_selection=True,
            seconds=time.perf_counter() - t0)

    sel = select(spec, provider)
    if store is not None:
        store.put_json("selections", sel_fields, {
            "assignment": {str(k): v for k, v in sel.assignment.items()},
            "predicted_cost_s": sel.solver_cost,
            "optimal": sel.optimal,
            "estimate_seconds": sel.estimate_seconds,
            "solver_seconds": sel.solver_seconds,
        })
    return OptimisedNetwork(
        net=net_name, spec=spec, platform=platform, models=models,
        assignment=sel.assignment, columns=columns,
        predicted_cost_s=sel.solver_cost, selection=sel,
        warm_models=models.warm, warm_selection=False,
        seconds=time.perf_counter() - t0)


def reoptimise(opt: OptimisedNetwork,
               *,
               sample=None,
               served=None,
               pooled=None,
               sample_n: int = 16,
               budget: float = 0.05,
               mode: str = "auto",
               store: Optional[ArtifactStore] = None,
               seed: int = 0,
               max_iters: Optional[int] = None,
               executable: Optional[bool] = None,
               device="cuda") -> OptimisedNetwork:
    """Re-optimise an already-optimised network from fresh measurements —
    the serving drift loop's entry point (DESIGN.md §8.3, §8.5).

    ``sample``: a ``PerfDataset`` of *fresh* target measurements (e.g.
    ``platform.measure_sample()`` taken after drift was detected); when
    given, ``platform.calibrate`` corrects the current models onto it
    without touching any cached profiling pool. Without a sample this is a
    plain re-calibration at ``budget`` against the platform's dataset.

    ``served``: attributed served-traffic observations
    (``profiler.dataset.observations_to_dataset``) — the zero-cost path:
    ``platform.calibrate`` composes the calibration sample from them,
    freshly profiling only the ≤ ``sample_n`` configs the serving buffer
    does not cover. The composition mix lands in
    ``result.models.sample_info``.

    ``pooled``: other hosts' published served-traffic datasets for the
    same platform fingerprint (``ArtifactStore.pooled_drift``) — merged
    with ``served`` so a host recalibrates from fleet evidence without
    profiling anything itself (DESIGN.md §14.3).

    ``executable``: None infers it from ``opt`` (a selection restricted to
    fewer columns than its models was an ``executable=True`` optimise).

    ``device``: where fine-tuned or scratch models train without a store.
    """
    if opt.platform is None or opt.models is None:
        raise ValueError("reoptimise needs an OptimisedNetwork produced by "
                         "optimise() — platform and models must be attached")
    iters = {} if max_iters is None else {"max_iters": max_iters}
    models = opt.platform.calibrate(opt.models, budget, mode=mode,
                                    sample=sample, served=served,
                                    pooled=pooled, sample_n=sample_n,
                                    store=store, seed=seed, device=device,
                                    **iters)
    if executable is None:
        executable = list(opt.columns) != list(opt.models.prim.columns)
    return optimise(opt.spec, opt.platform, models=models, store=store,
                    executable=executable)
