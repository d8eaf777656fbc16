"""Executor: run a CNN under a primitive assignment on one device — the port
of ``repro.primitives.executor``.

Two paths share ``execute``:

* **compiled** (default for ``measure=False``): the whole assigned DAG goes
  through ``plan.compile_plan`` as one batched callable;
* **interpreted**: one cached callable per primitive column plus explicit
  DLTs, node by node — the per-component *measurement* path
  (``measure=True``: CUDA events on the card, ``perf_counter`` on the CPU)
  and the oracle the compiled plan is tested against.

``make_weights`` and ``source_inputs`` draw from the same numpy seeds as the
reference, so both packages see byte-identical float32 arrays.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models.cnn_zoo import CNNSpec, ConvLayer, EltwiseLayer
from repro_torch.primitives import layouts as L
from repro_torch.primitives import plan as P
from repro_torch.primitives.conv import REGISTRY, resolve, split_tile
from repro_torch.primitives.variants import conv_variant_call

Device = Union[str, torch.device]

# Primitive/DLT callables cached across ``execute`` calls, keyed by
# (column, input shape, stride): repeated traffic over one network reuses
# them. LRU-bounded so multi-network serving cannot grow it without limit.
_JIT_CACHE: "OrderedDict[Tuple, Callable]" = OrderedDict()
_JIT_CACHE_CAP = 256


def evict_prim_entries(columns) -> int:
    """Drop cached primitive callables for the given (full, possibly
    tile-suffixed) column names — all shapes/strides. Returns the count."""
    cols = set(columns)
    dead = [k for k in _JIT_CACHE if k[0] == "prim" and k[1] in cols]
    for k in dead:
        del _JIT_CACHE[k]
    return len(dead)


def _cached(key: Tuple, make: Callable[[], Callable]) -> Callable:
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = make()
        _JIT_CACHE[key] = fn
    else:
        _JIT_CACHE.move_to_end(key)
    while len(_JIT_CACHE) > _JIT_CACHE_CAP:
        _JIT_CACHE.popitem(last=False)
    return fn


def _cached_primitive(column: str, x: torch.Tensor, w: torch.Tensor,
                      stride: int) -> Callable:
    """Callable for a (possibly tile-suffixed) column. The FULL column name
    keys the cache: two tile variants of one base are distinct kernels."""
    base, variant = split_tile(column)
    prim = REGISTRY[base]
    key = ("prim", column, tuple(x.shape), str(x.dtype), tuple(w.shape), stride)
    if variant is None:
        impl = prim.impl
        return _cached(key, lambda: lambda a, b: impl(a, b, stride))
    return _cached(key, lambda: lambda a, b: conv_variant_call(prim, variant, a, b, stride))


def _cached_dlt(src: str, dst: str, x: torch.Tensor) -> Callable:
    """The DLT materialised, as the reference's jitted transpose is."""
    key = ("dlt", src, dst, tuple(x.shape), str(x.dtype))
    return _cached(key, lambda: lambda a: L.transform(a, src, dst).contiguous())


@dataclasses.dataclass
class ExecutionReport:
    outputs: Dict[int, torch.Tensor]
    primitive_seconds: Dict[int, float]
    dlt_seconds: Dict[Tuple[int, int], float]

    @property
    def total_seconds(self) -> float:
        return sum(self.primitive_seconds.values()) + sum(self.dlt_seconds.values())


def make_weights(spec: CNNSpec, seed: int = 0,
                 device: Device = "cuda") -> Dict[int, torch.Tensor]:
    """Conv weights (k, c, f, f) and bias vectors, float32 on ``device`` —
    the reference's numpy draws, byte for byte."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, node in enumerate(spec.nodes):
        if isinstance(node, ConvLayer):
            w = rng.standard_normal((node.k, node.c, node.f, node.f)) / (node.f * np.sqrt(node.c))
            out[i] = torch.from_numpy(w.astype(np.float32)).to(device)
        elif isinstance(node, EltwiseLayer) and node.kind == "bias":
            b = rng.standard_normal((node.c,))
            out[i] = torch.from_numpy(b.astype(np.float32)).to(device)
    return out


def source_inputs(spec: CNNSpec, x=None,
                  device: Device = "cuda") -> Dict[int, torch.Tensor]:
    """chw input per source conv node: ``x`` if given, else N(0,1) draws
    (paper §4.1.1) in topo order — the reference's draws, byte for byte."""
    rng = np.random.default_rng(1)
    out: Dict[int, torch.Tensor] = {}
    for i in P.source_nodes(spec):
        node = spec.nodes[i]
        if x is not None:
            out[i] = torch.as_tensor(x, dtype=torch.float32).to(device)
        else:
            a = rng.standard_normal((node.c, node.im, node.im))
            out[i] = torch.from_numpy(a.astype(np.float32)).to(device)
    return out


def execute(spec: CNNSpec, assignment: Dict[int, str],
            weights: Optional[Dict[int, torch.Tensor]] = None,
            x=None, measure: bool = False, repeats: int = 5,
            compiled: Optional[bool] = None,
            device: Device = "cuda") -> ExecutionReport:
    """Run the network under ``assignment`` on ``device`` (the weights'
    device). Inputs of source conv nodes are N(0,1) draws unless ``x``
    (chw) is given.

    ``measure=True`` times every primitive call and DLT on the interpreted
    path (warmed, median of ``repeats``); otherwise the call wraps the
    compiled whole-graph plan (``compiled=False`` forces the interpreted
    path without timing).
    """
    device = torch.device(device)
    weights = weights if weights is not None else make_weights(spec, device=device)
    if compiled is None:
        compiled = not measure
    if measure or not compiled:
        return _execute_interpreted(spec, assignment, weights, x, measure,
                                    repeats, device)
    xs = source_inputs(spec, x, device)
    plan = P.compile_plan(spec, assignment,
                          tuple((1,) + tuple(v.shape) for v in xs.values()),
                          outputs="all")
    outs = plan({i: v[None] for i, v in xs.items()}, weights)
    outputs = {i: o[0] for i, o in outs.items()}
    prim_secs = {i: 0.0 for i, n in enumerate(spec.nodes) if isinstance(n, ConvLayer)}
    return ExecutionReport(outputs, prim_secs, {})


def _timer(device: torch.device) -> Callable[[Callable], float]:
    """Seconds one call takes: CUDA events around it on the card (the host
    returns before the device finishes), ``perf_counter`` on the CPU."""
    if device.type == "cuda":
        def cuda_time(call: Callable) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        return cuda_time

    def cpu_time(call: Callable) -> float:
        t0 = time.perf_counter()
        call()
        return time.perf_counter() - t0
    return cpu_time


def _execute_interpreted(spec: CNNSpec, assignment: Dict[int, str],
                         weights: Dict[int, torch.Tensor], x,
                         measure: bool, repeats: int,
                         device: torch.device) -> ExecutionReport:
    order = P.topo_order(spec)
    prods = P.producers(spec)
    xs = source_inputs(spec, x, device)
    tensors: Dict[int, torch.Tensor] = {}      # node -> output in its layout
    layouts: Dict[int, str] = {}
    prim_secs: Dict[int, float] = {}
    dlt_secs: Dict[Tuple[int, int], float] = {}
    clock = _timer(device)

    def timed(fn, *args) -> Tuple[torch.Tensor, float]:
        y = fn(*args)
        if not measure:
            return y, 0.0
        return y, float(np.median([clock(lambda: fn(*args)) for _ in range(repeats)]))

    def fetch_input(node_idx: int, want_layout: str):
        """Gather and layout-convert the producer tensors for ``node_idx``."""
        vals = []
        for p in prods[node_idx]:
            v, src = tensors[p], layouts[p]
            if src != want_layout:
                v, dt = timed(_cached_dlt(src, want_layout, v), v)
                dlt_secs[(p, node_idx)] = dlt_secs.get((p, node_idx), 0.0) + dt
            vals.append(v)
        return vals

    for i in order:
        node = spec.nodes[i]
        if isinstance(node, ConvLayer):
            prim = resolve(assignment[i])
            if prim.impl is None:
                raise ValueError(f"assignment uses simulated-only primitive {prim.name}")
            if prods[i]:
                (xin,) = fetch_input(i, prim.in_layout)
            else:
                xin = L.from_chw(xs[i], prim.in_layout)
            y, dt = timed(_cached_primitive(assignment[i], xin, weights[i], node.s),
                          xin, weights[i])
            tensors[i], layouts[i] = y, prim.out_layout
            prim_secs[i] = dt
        elif isinstance(node, EltwiseLayer):
            lay = assignment[i]
            (v,) = fetch_input(i, lay)
            if node.kind == "relu":
                y = torch.relu(v)
            elif node.kind == "bias":
                shape = [1, 1, 1]
                shape[L.C_AXIS[lay]] = node.c
                y = v + weights[i].reshape(shape)
            else:
                raise ValueError(node.kind)
            tensors[i], layouts[i] = y, lay
        else:
            lay = assignment[i]
            vals = P.crop_to_common(fetch_input(i, lay), lay)
            if node.kind == "concat":
                y = torch.cat(vals, dim=L.C_AXIS[lay])
            elif node.kind == "add":
                y = vals[0]
                for v in vals[1:]:
                    y = y + v
            else:
                raise ValueError(node.kind)
            tensors[i], layouts[i] = y, lay
    return ExecutionReport(tensors, prim_secs, dlt_secs)
