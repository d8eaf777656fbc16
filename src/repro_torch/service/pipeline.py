"""What the serving layer needs about one optimised network — the port of
the ``OptimisedNetwork`` side of ``repro.service.pipeline``.

This slice serves an assignment given from outside
(``OptimisedNetwork.from_assignment``: a selection made elsewhere, a
heuristic baseline, a hand-written plan). ``optimise``/``reoptimise`` —
the profile -> model -> select loop — come with the selection slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.models.cnn_zoo import CNNSpec, ConvLayer


@dataclasses.dataclass
class OptimisedNetwork:
    """Everything downstream layers need about one optimised network."""

    net: str
    spec: CNNSpec
    platform: Optional[object]        # None until the selection slice
    models: Optional[object]
    assignment: Dict[int, str]        # node idx -> primitive / layout
    columns: List[str]                # columns selection chose from
    predicted_cost_s: float           # model-predicted per-image runtime
    selection: Optional[object]
    warm_models: bool
    warm_selection: bool
    seconds: float                    # total optimise() wall time

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
                        platform: Optional[object] = None,
                        models: Optional[object] = None,
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
