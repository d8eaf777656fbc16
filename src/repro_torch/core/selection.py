"""Primitive selection pipeline (paper Fig 2).

  (i)   extract layer configurations from the network spec,
  (ii)  estimate primitive + DLT runtimes (performance model, batched — all
        layers in one forward pass) or look up measured/simulated times,
  (iii) solve the PBQP for the optimal per-layer assignment,
  (iv)  emit the assignment for the executor.

Join nodes (concat/residual-add) become 3-choice layout nodes with zero node
cost (DESIGN.md §3), keeping inception-style graphs exactly reducible.

The port of ``repro.core.selection``: the same graph, built in the same
order from the same cost matrices, so ``select`` returns the reference's
assignment. A ``ModelProvider`` predicts on its models' device; the
``MeasuredProvider`` times on the GPU (``profiler/device.py``), where the
reference's timed the host CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.core import pbqp
from repro_torch.core.perfmodel import PerfModel
from repro_torch.models.cnn_zoo import CNNSpec, ConvLayer
from repro_torch.primitives import layouts as L
from repro_torch.primitives.conv import (PRIMITIVE_NAMES, RUNNABLE,
                                        compile_traits, resolve)
from repro_torch.profiler import device as device_profiler
from repro_torch.profiler.simulators import (PLATFORMS, dlt_time_batch,
                                             primitive_time_batch)


# ---------------------------------------------------------------------------
# Cost providers
# ---------------------------------------------------------------------------

class CostProvider(Protocol):
    columns: Sequence[str]

    def primitive_cost_matrix(self, configs: np.ndarray) -> np.ndarray:
        """(L, 5) configs -> (L, P) runtimes (NaN = inapplicable)."""

    def dlt_cost_matrix(self, pairs: np.ndarray) -> np.ndarray:
        """(M, 2) (c, im) pairs -> (M, 6) non-identity DLT runtimes in
        ``layouts.dlt_pairs()`` order (identity excluded)."""


_DLT_COLS = device_profiler.dlt_columns()


class SimulatedProvider:
    """Ground-truth provider backed by a platform simulator — plays the role
    of 'profiled on the device' in the paper's comparisons."""

    def __init__(self, platform: str, noisy: bool = True,
                 columns: Optional[Sequence[str]] = None):
        self._plat = PLATFORMS[platform]
        self.noisy = noisy
        self.columns = list(columns) if columns is not None else list(PRIMITIVE_NAMES)

    def primitive_cost_matrix(self, configs: np.ndarray) -> np.ndarray:
        if len(configs) == 0:
            return np.zeros((0, len(self.columns)))
        return primitive_time_batch(self._plat, np.asarray(configs, np.int64),
                                    noisy=self.noisy, columns=tuple(self.columns))

    def dlt_cost_matrix(self, pairs: np.ndarray) -> np.ndarray:
        if len(pairs) == 0:
            return np.zeros((0, len(_DLT_COLS)))
        return dlt_time_batch(self._plat, np.asarray(pairs, np.int64),
                              noisy=self.noisy)


class ModelProvider:
    """Performance-model provider (the paper's contribution): one batched
    forward pass per network for primitives and one for DLTs, on the
    models' device.

    ``columns`` restricts selection to a subset of the model's output columns
    (e.g. the runnable primitives when the assignment must execute on this
    host) without retraining — predictions are sliced per call."""

    def __init__(self, prim_model: PerfModel, dlt_model: PerfModel,
                 columns: Optional[Sequence[str]] = None):
        self.prim_model = prim_model
        self.dlt_model = dlt_model
        if columns is None:
            self.columns = list(prim_model.columns)
            self._col_idx = None
        else:
            model_cols = list(prim_model.columns)
            missing = [c for c in columns if c not in model_cols]
            if missing:
                raise ValueError(f"model has no columns {missing}")
            self.columns = list(columns)
            self._col_idx = np.array([model_cols.index(c) for c in columns])

    def primitive_cost_matrix(self, configs: np.ndarray) -> np.ndarray:
        pred = self.prim_model.predict(np.asarray(configs, np.float64))
        if self._col_idx is not None:
            pred = pred[:, self._col_idx]
        # applicability is structural knowledge, not predicted
        cfg = np.asarray(configs, np.int64)
        mask = compile_traits(tuple(self.columns)).applicable_mask(
            cfg[:, 0], cfg[:, 1], cfg[:, 2], cfg[:, 3], cfg[:, 4])
        pred[~mask] = np.nan
        return pred

    def dlt_cost_matrix(self, pairs: np.ndarray) -> np.ndarray:
        return self.dlt_model.predict(np.asarray(pairs, np.float64))


class MeasuredProvider:
    """Measured provider: profiles on demand on ``device`` (expensive — the
    paper's point). Costs are the profiler's wall medians; ``columns`` may
    name base primitives and tile columns alike."""

    def __init__(self, repeats: int = 9, columns: Optional[Sequence[str]] = None,
                 device="cuda"):
        self.repeats = repeats
        self.device = device
        self.columns = list(columns) if columns is not None else list(RUNNABLE)

    def primitive_cost_matrix(self, configs: np.ndarray) -> np.ndarray:
        return device_profiler.profile_primitive_batch(
            np.asarray(configs, int), self.columns, repeats=self.repeats,
            device=self.device).wall

    def dlt_cost_matrix(self, pairs: np.ndarray) -> np.ndarray:
        return device_profiler.profile_dlt_batch(
            np.asarray(pairs, int), repeats=self.repeats,
            device=self.device).wall


# ---------------------------------------------------------------------------
# PBQP construction
# ---------------------------------------------------------------------------

def _edge_tensor(node) -> Tuple[int, int]:
    """(c, im) of the tensor a node produces."""
    if isinstance(node, ConvLayer):
        return node.k, node.out_im
    return node.c, node.im


def _out_layout(node, choice: str) -> str:
    if isinstance(node, ConvLayer):
        # resolve, not REGISTRY[...]: tile columns ("base@mm-MxKxN")
        # inherit their base primitive's layouts
        return resolve(choice).out_layout
    return choice           # join nodes choose a layout directly


def _in_layout(node, choice: str) -> str:
    if isinstance(node, ConvLayer):
        return resolve(choice).in_layout
    return choice


def _node_choices(node, columns: Sequence[str]) -> List[str]:
    if isinstance(node, ConvLayer):
        return list(columns)
    return list(L.LAYOUTS)


@dataclasses.dataclass
class SelectionResult:
    assignment: Dict[int, str]       # node idx -> primitive name / layout
    solver_cost: float
    optimal: bool
    estimate_seconds: float          # step (ii) wall time
    solver_seconds: float            # step (iii) wall time

    @property
    def total_seconds(self) -> float:
        return self.estimate_seconds + self.solver_seconds


# (src, dst) layout indices of the 6 non-identity DLT columns, for scattering
# a provider DLT row into a dense (layouts × layouts) table
_DLT_SRC_IDX = np.array([L.LAYOUTS.index(s) for (s, d) in L.dlt_pairs() if s != d])
_DLT_DST_IDX = np.array([L.LAYOUTS.index(d) for (s, d) in L.dlt_pairs() if s != d])


def build_pbqp(spec: CNNSpec, provider: CostProvider) -> pbqp.PBQPGraph:
    columns = list(provider.columns)
    convs = [(i, n) for i, n in enumerate(spec.nodes) if isinstance(n, ConvLayer)]
    configs = np.array([n.config for _, n in convs], np.float64)
    cost_mat = provider.primitive_cost_matrix(configs) if len(convs) else np.zeros((0, len(columns)))

    # batched DLT prediction for every distinct produced tensor, scattered
    # into dense (layouts × layouts) tables: tables[p, src, dst]
    pair_list = sorted({_edge_tensor(spec.nodes[u]) for (u, v) in spec.edges})
    pair_idx = {p: i for i, p in enumerate(pair_list)}
    dlt_mat = (provider.dlt_cost_matrix(np.array(pair_list, np.float64))
               if pair_list else np.zeros((0, len(_DLT_COLS))))
    tables = np.zeros((len(pair_list), len(L.LAYOUTS), len(L.LAYOUTS)))
    tables[:, _DLT_SRC_IDX, _DLT_DST_IDX] = np.maximum(dlt_mat, 0.0)

    # per-choice layout index vectors: conv nodes from the compiled registry
    # traits of the provider's columns, join nodes choose a layout directly
    traits = compile_traits(tuple(columns))
    join_idx = np.arange(len(L.LAYOUTS))
    out_idx = {i: (traits.out_layout if isinstance(n, ConvLayer) else join_idx)
               for i, n in enumerate(spec.nodes)}
    in_idx = {i: (traits.in_layout if isinstance(n, ConvLayer) else join_idx)
              for i, n in enumerate(spec.nodes)}

    g = pbqp.PBQPGraph()
    conv_cost = {i: cost_mat[r] for r, (i, _) in enumerate(convs)}
    for i, node in enumerate(spec.nodes):
        choices = _node_choices(node, columns)
        if isinstance(node, ConvLayer):
            vec = np.where(np.isfinite(conv_cost[i]), conv_cost[i], np.inf)
            vec = np.maximum(vec, 0.0)
        else:
            vec = np.zeros(len(choices))
        g.add_node(i, vec, labels=choices)

    for (u, v) in spec.edges:
        tab = tables[pair_idx[_edge_tensor(spec.nodes[u])]]
        # every edge matrix is one gather: (producer out-layout, consumer
        # in-layout) per choice pair — no Python loop over primitive pairs
        m = tab[out_idx[u][:, None], in_idx[v][None, :]]
        g.add_edge(u, v, m)
    return g


def select(spec: CNNSpec, provider: CostProvider) -> SelectionResult:
    t0 = time.perf_counter()
    g = build_pbqp(spec, provider)
    t1 = time.perf_counter()
    sol = pbqp.solve(g)
    t2 = time.perf_counter()
    labelled = sol.labelled(g)
    return SelectionResult(labelled, sol.cost, sol.optimal, t1 - t0, t2 - t1)


def network_cost(spec: CNNSpec, assignment: Dict[int, str],
                 provider: Optional[CostProvider] = None, *,
                 graph: Optional[pbqp.PBQPGraph] = None) -> float:
    """Total network runtime under ``assignment`` with ``provider``'s costs —
    used to score a model-derived assignment against ground truth (Fig 7).

    Fig-7-style loops evaluate many assignments against one ground-truth
    provider; pass ``graph=build_pbqp(spec, provider)`` to amortise the
    O(build) cost across evaluations instead of rebuilding per call."""
    if graph is None:
        if provider is None:
            raise TypeError("network_cost needs a provider or a prebuilt graph")
        graph = build_pbqp(spec, provider)
    idx_assignment = {n: graph.labels[n].index(assignment[n])
                      for n in graph.labels}
    return pbqp.evaluate(graph, idx_assignment)
