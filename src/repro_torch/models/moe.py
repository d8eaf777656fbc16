"""Mixture-of-Experts configuration: the port of ``repro.models.moe``'s
``MoEConfig``, which ``repro_torch.configs.base`` needs. The layer itself
(routing, dispatch, experts) is a later slice; ``repro_torch.models.
transformer`` refuses MoE configs."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    dispatch: str = "sort"    # "sort" (optimized) | "scatter" (baseline)
