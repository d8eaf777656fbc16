"""Plan compiler: lower an assigned CNN DAG into one batched callable — the
port of ``repro.primitives.plan``.

``lower`` is the reference's lowering, rule for rule: the topo-ordered DAG
(convs, DLTs, concat/add joins, elementwise nodes, centre-crops) becomes a
step list in which every edge carries at most one composed axis permutation
(identities dropped, the rest inlined into the consumer), and with
``epilogues=True`` eligible bias / ReLU / residual-add consumers fold into
the producing conv step's ``EpilogueSpec``.

One deliberate divergence: a residual add folds onto a conv only when the
conv's *actual* output size (``spatial_sizes``) is the join's, where the
reference compares the spec's *declared* sizes. The two agree wherever the
declared sizes are the actual ones (edge_cnn, the test nets), so the
``epilogue_signature`` is the reference's there. On the zoo's resnets they
differ, the reference folds a residual that is smaller than the conv's
output, and its plan fails with incompatible shapes; the port's runs.

``compile_plan`` replays the steps over a leading batch axis. Where the
reference wraps the replay in ``jax.jit``, the port returns the plain
callable (PyTorch runs eagerly; CUDA-graph capture per batch shape is later
work), cached LRU by ``(spec, assignment, batch_shape, outputs, epilogues)``.
Tile columns run through ``primitives.variants`` and so through the
hand-written kernels; base columns run their plain torch impl.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.cnn_zoo import CNNSpec, ConvLayer, EltwiseLayer
from repro_torch.primitives import layouts as L
from repro_torch.primitives.conv import (REGISTRY, Primitive, batch_impl,
                                         split_tile, variant_compatible)
from repro_torch.primitives.variants import conv_variant_call


# ---------------------------------------------------------------------------
# Graph utilities (shared with the interpreted executor)
# ---------------------------------------------------------------------------

def consumers(spec: CNNSpec) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {i: [] for i in range(len(spec.nodes))}
    for u, v in spec.edges:
        out[u].append(v)
    return out


def producers(spec: CNNSpec) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {i: [] for i in range(len(spec.nodes))}
    for u, v in spec.edges:
        out[v].append(u)
    return out


def topo_order(spec: CNNSpec) -> List[int]:
    prods = producers(spec)
    indeg = {i: len(p) for i, p in prods.items()}
    ready = [i for i, d in indeg.items() if d == 0]
    order = []
    cons = consumers(spec)
    while ready:
        n = ready.pop()
        order.append(n)
        for v in cons[n]:
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if len(order) != len(spec.nodes):
        raise ValueError("cycle in CNN spec")
    return order


def source_nodes(spec: CNNSpec) -> List[int]:
    """Producer-less conv nodes, in topo order (the network inputs)."""
    prods = producers(spec)
    return [i for i in topo_order(spec)
            if not prods[i] and isinstance(spec.nodes[i], ConvLayer)]


def sink_nodes(spec: CNNSpec) -> List[int]:
    cons = consumers(spec)
    return [i for i in range(len(spec.nodes)) if not cons[i]]


def crop_to_common(vals: Sequence[torch.Tensor], layout: str) -> List[torch.Tensor]:
    """Centre-crop a list of same-layout tensors to the smallest spatial size
    (rank-polymorphic: layout describes the trailing three axes)."""
    ah, aw = L.SPATIAL_AXES[layout]
    h = min(v.shape[v.dim() - 3 + ah] for v in vals)
    w = min(v.shape[v.dim() - 3 + aw] for v in vals)
    out = []
    for v in vals:
        lead = v.dim() - 3
        sl = [slice(None)] * v.dim()
        oh = (v.shape[lead + ah] - h) // 2
        ow = (v.shape[lead + aw] - w) // 2
        sl[lead + ah] = slice(oh, oh + h)
        sl[lead + aw] = slice(ow, ow + w)
        out.append(v[tuple(sl)])
    return out


# ---------------------------------------------------------------------------
# Lowered steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Elementwise work folded into a ConvStep's epilogue (bias -> residual
    -> ReLU on the output tile before the store). ``alias`` is the last
    fused node: the conv step now *produces* that node's output."""
    alias: int
    bias: Optional[int] = None                          # EltwiseLayer node (weights key)
    residual: Optional[Tuple[int, Tuple[int, int, int]]] = None  # (producer, perm)
    relu: bool = False

    @property
    def ops(self) -> Tuple[str, ...]:
        out = []
        if self.bias is not None:
            out.append("bias")
        if self.residual is not None:
            out.append("residual")
        if self.relu:
            out.append("relu")
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ConvStep:
    node: int
    prim: Primitive
    stride: int
    src: Optional[int]                    # None => network input
    perm: Tuple[int, int, int]            # fused DLT into prim.in_layout
    variant: Optional[str] = None         # kernel tile variant ("mm-*", ...)
    epilogue: Optional[EpilogueSpec] = None

    @property
    def out_node(self) -> int:
        """Node id this step's output stands for (the epilogue alias when
        elementwise consumers were folded in)."""
        return self.epilogue.alias if self.epilogue is not None else self.node


@dataclasses.dataclass(frozen=True)
class JoinStep:
    node: int
    kind: str                             # "concat" | "add"
    layout: str
    ins: Tuple[Tuple[int, Tuple[int, int, int]], ...]   # (producer, fused perm)


@dataclasses.dataclass(frozen=True)
class EltwiseStep:
    """Un-fused elementwise node (epilogue fusion off, or layout/ordering
    made folding impossible)."""
    node: int
    kind: str                             # "relu" | "bias"
    src: int
    perm: Tuple[int, int, int]
    layout: str


PlanStep = Union[ConvStep, JoinStep, EltwiseStep]


def spatial_sizes(spec: CNNSpec) -> Dict[int, int]:
    """Each node's actual output size for inputs of the sources' declared
    size: valid convolutions shrink, joins centre-crop to their smallest
    input, elementwise nodes keep their producer's size. On nets built
    with valid sizes (edge_cnn) this equals the declared sizes; on the
    zoo's resnets the declared stage sizes are not the actual ones."""
    prods = producers(spec)
    size: Dict[int, int] = {}
    for i in topo_order(spec):
        node = spec.nodes[i]
        if isinstance(node, ConvLayer):
            im = size[prods[i][0]] if prods[i] else node.im
            size[i] = (im - node.f) // node.s + 1
        else:
            size[i] = min(size[p] for p in prods[i])
    return size


def lower(spec: CNNSpec, assignment: Dict[int, str], *,
          epilogues: bool = False) -> Tuple[List[PlanStep], Dict[int, str]]:
    """Lower the assigned DAG to a step list with DLT fusion applied.

    Returns the steps in topo order plus each node's produced layout. Tile
    columns ("base@variant") must be ``variant_compatible``. With
    ``epilogues=True`` eligible elementwise consumers (bias add, ReLU,
    2-input residual add) of an epilogue-capable conv fold into the
    producing ConvStep's ``EpilogueSpec``: the conv step moves to the
    consumer's topo position and produces the consumer's output.
    """
    prods = producers(spec)
    cons = consumers(spec)
    size = spatial_sizes(spec)
    steps: List[Optional[PlanStep]] = []
    prod_step: Dict[int, int] = {}        # node -> index of producing step
    layout_of: Dict[int, str] = {}

    def fusable(p: int, lay: str) -> Optional[ConvStep]:
        """The ConvStep producing node ``p`` if an epilogue can fold onto it:
        epilogue-capable base, chw output matching ``lay``, ``p`` consumed
        exactly once (by the node being lowered)."""
        st = steps[prod_step[p]] if p in prod_step else None
        if (isinstance(st, ConvStep) and st.prim.traits.get("epilogue")
                and st.prim.out_layout == "chw" and lay == "chw"
                and len(cons[p]) == 1):
            return st
        return None

    def refuse(p: int, st: ConvStep, ep: EpilogueSpec) -> None:
        """Move ``st`` (producer of ``p``) to the current topo position with
        the grown epilogue — its output now stands for ``ep.alias``."""
        steps[prod_step[p]] = None
        steps.append(dataclasses.replace(st, epilogue=ep))
        prod_step[ep.alias] = len(steps) - 1
        layout_of[ep.alias] = "chw"

    for i in topo_order(spec):
        node = spec.nodes[i]
        if isinstance(node, ConvLayer):
            base, variant = split_tile(assignment[i])
            prim = REGISTRY.get(base)
            if prim is None or prim.impl is None:
                raise ValueError(f"assignment uses simulated-only primitive {base}")
            if variant is not None and not variant_compatible(base, variant):
                raise ValueError(f"tile variant {variant!r} cannot lower "
                                 f"through {base!r} (node {i})")
            ps = prods[i]
            if len(ps) > 1:
                raise ValueError(f"conv node {i} has {len(ps)} producers")
            if ps:
                pm = L.perm(layout_of[ps[0]], prim.in_layout)
                steps.append(ConvStep(i, prim, node.s, ps[0], pm, variant))
            else:
                pm = L.perm("chw", prim.in_layout)     # inputs arrive chw
                steps.append(ConvStep(i, prim, node.s, None, pm, variant))
            prod_step[i] = len(steps) - 1
            layout_of[i] = prim.out_layout
        elif isinstance(node, EltwiseLayer):
            lay = assignment[i]
            if lay not in L.LAYOUTS:
                raise ValueError(f"eltwise node {i} assigned non-layout {lay!r}")
            (p,) = prods[i]
            st = fusable(p, lay) if epilogues else None
            ep = st.epilogue if st is not None else None
            if st is not None and node.kind == "bias" and (
                    ep is None or (ep.bias is None and ep.residual is None
                                   and not ep.relu)):
                refuse(p, st, EpilogueSpec(alias=i, bias=i,
                                           residual=ep.residual if ep else None,
                                           relu=False))
            elif st is not None and node.kind == "relu" and (
                    ep is None or not ep.relu):
                refuse(p, st, dataclasses.replace(
                    ep or EpilogueSpec(alias=i), alias=i, relu=True))
            else:
                pm = L.perm(layout_of[p], lay)
                steps.append(EltwiseStep(i, node.kind, p, pm, lay))
                prod_step[i] = len(steps) - 1
                layout_of[i] = lay
        else:
            lay = assignment[i]
            if lay not in L.LAYOUTS:
                raise ValueError(f"join node {i} assigned non-layout {lay!r}")
            ins = tuple((p, L.perm(layout_of[p], lay)) for p in prods[i])
            fused = False
            if epilogues and node.kind == "add" and len(ins) == 2:
                for (p, _), (q, qpm) in ((ins[0], ins[1]), (ins[1], ins[0])):
                    st = fusable(p, lay)
                    ep = st.epilogue if st is not None else None
                    # conv output must be the join's (smallest) spatial size —
                    # the other operand centre-crops onto it; one residual
                    # per step, and never after a folded ReLU. Actual sizes,
                    # not declared ones (see the module docstring).
                    if (st is not None
                            and (ep is None or (ep.residual is None
                                                and not ep.relu))
                            and size[p] == size[i]):
                        refuse(p, st, EpilogueSpec(
                            alias=i, bias=ep.bias if ep else None,
                            residual=(q, qpm), relu=False))
                        fused = True
                        break
            if not fused:
                steps.append(JoinStep(i, node.kind, lay, ins))
                prod_step[i] = len(steps) - 1
                layout_of[i] = lay
    return [st for st in steps if st is not None], layout_of


def heuristic_assignment(spec: CNNSpec) -> Dict[int, str]:
    """Deterministic runnable assignment (no profiling): GEMM-lowered convs,
    pointwise GEMM for 1x1, chw joins."""
    return {i: (("conv-1x1-gemm-ab-ki" if node.f == 1 else "im2col-copy-ab-ki")
                if isinstance(node, ConvLayer) else "chw")
            for i, node in enumerate(spec.nodes)}


def fused_dlt_count(steps: Sequence[PlanStep]) -> Tuple[int, int]:
    """(eliminated identity DLTs, inlined transposes) across the plan edges."""
    fused = inlined = 0
    for st in steps:
        if isinstance(st, JoinStep):
            perms = [pm for _, pm in st.ins]
        else:
            perms = [st.perm]
            if isinstance(st, ConvStep) and st.epilogue is not None \
                    and st.epilogue.residual is not None:
                perms.append(st.epilogue.residual[1])
        for pm in perms:
            if L.is_identity(pm):
                fused += 1
            else:
                inlined += 1
    return fused, inlined


def epilogue_signature(steps: Sequence[PlanStep]) -> Tuple[Tuple[int, int, Tuple[str, ...]], ...]:
    """(conv node, alias node, fused ops) per epilogue-fused step — the
    plan's fusion fingerprint."""
    return tuple((st.node, st.epilogue.alias, st.epilogue.ops)
                 for st in steps
                 if isinstance(st, ConvStep) and st.epilogue is not None)


# ---------------------------------------------------------------------------
# Plan compilation + cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledPlan:
    """One callable for the whole assigned network.

    ``__call__(x, weights)`` takes a batched chw input (n, c, im, im) — or a
    ``{source node: tensor}`` dict for multi-input specs — on the weights'
    device, and returns ``{node: batched output in its native layout}`` for
    the requested output set.
    """
    spec: CNNSpec
    assignment: Dict[int, str]
    steps: List[PlanStep]
    layouts: Dict[int, str]               # node -> produced layout
    sources: List[int]
    sinks: List[int]
    outputs: str                          # "sinks" | "all"
    fn: Callable                          # (xs dict, weights) -> outputs
    epilogues: bool = False               # epilogue fusion pass applied
    epilogue_signature: Tuple = ()        # (conv, alias, ops) per fused step

    def __call__(self, x, weights: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        return self.fn(self._as_inputs(x), weights)

    def _as_inputs(self, x) -> Dict[int, torch.Tensor]:
        if isinstance(x, dict):
            return {int(k): torch.as_tensor(v) for k, v in x.items()}
        if len(self.sources) != 1:
            raise ValueError(f"spec has {len(self.sources)} inputs; pass a dict")
        return {self.sources[0]: torch.as_tensor(x)}


def _crop_center(r: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Centre-crop trailing spatial axes to (oh, ow) — the chw analogue of
    ``crop_to_common`` for a single residual operand."""
    h, w = r.shape[-2:]
    dh, dw = (h - oh) // 2, (w - ow) // 2
    return r[..., dh:dh + oh, dw:dw + ow]


def _emit(steps: List[PlanStep], want: List[int]) -> Callable:
    """Build the function replaying ``steps`` over a leading batch."""
    def fn(xs: Dict[int, torch.Tensor], weights: Dict[int, torch.Tensor]):
        tensors: Dict[int, torch.Tensor] = {}
        for st in steps:
            if isinstance(st, ConvStep):
                v = xs[st.node] if st.src is None else tensors[st.src]
                v = L.apply_perm(v, st.perm)          # fused DLT (no-op if id)
                w = weights[st.node]
                ep = st.epilogue
                bias = res = None
                relu = False
                if ep is not None:
                    bias = weights[ep.bias] if ep.bias is not None else None
                    relu = ep.relu
                    if ep.residual is not None:
                        q, pm = ep.residual
                        f = w.shape[-1]
                        oh = (v.shape[-2] - f) // st.stride + 1
                        ow = (v.shape[-1] - f) // st.stride + 1
                        res = _crop_center(L.apply_perm(tensors[q], pm), oh, ow)
                if st.variant is not None:
                    y = conv_variant_call(st.prim, st.variant, v, w,
                                          st.stride, bias=bias, residual=res,
                                          relu=relu)
                else:
                    y = batch_impl(st.prim)(v, w, st.stride)
                    if bias is not None:              # chw-out (fusion criterion)
                        y = y + bias[:, None, None]
                    if res is not None:
                        y = y + res
                    if relu:
                        y = torch.relu(y)
                tensors[st.out_node] = y
            elif isinstance(st, EltwiseStep):
                v = L.apply_perm(tensors[st.src], st.perm)
                if st.kind == "relu":
                    y = torch.relu(v)
                elif st.kind == "bias":
                    b = weights[st.node]
                    shape = [1, 1, 1]
                    shape[L.C_AXIS[st.layout]] = b.shape[0]
                    y = v + b.reshape(shape)
                else:
                    raise ValueError(st.kind)
                tensors[st.node] = y
            else:
                vals = [L.apply_perm(tensors[p], pm) for p, pm in st.ins]
                vals = crop_to_common(vals, st.layout)
                if st.kind == "concat":
                    y = torch.cat(vals, dim=-3 + L.C_AXIS[st.layout])
                elif st.kind == "add":
                    y = vals[0]
                    for v in vals[1:]:
                        y = y + v
                else:
                    raise ValueError(st.kind)
                tensors[st.node] = y
        return {i: tensors[i] for i in want}
    return fn


def _spec_key(spec: CNNSpec) -> Tuple:
    return (spec.name, tuple(spec.nodes), tuple(spec.edges))


_PLAN_CACHE: "OrderedDict[Tuple, CompiledPlan]" = OrderedDict()
_PLAN_CACHE_CAP = 64


def evict_plans(spec: CNNSpec, assignment: Dict[int, str]) -> int:
    """Drop every cached plan for (``spec``, ``assignment``) — all batch
    shapes, output modes and epilogue settings. Returns the count."""
    skey = _spec_key(spec)
    akey = tuple(sorted(assignment.items()))
    dead = [k for k in _PLAN_CACHE if k[0] == skey and k[1] == akey]
    for k in dead:
        del _PLAN_CACHE[k]
    return len(dead)


def compile_plan(spec: CNNSpec, assignment: Dict[int, str],
                 batch_shape: Optional[Tuple[int, ...]] = None, *,
                 outputs: str = "sinks",
                 epilogues: Optional[bool] = None) -> CompiledPlan:
    """Lower (and cache) the whole-graph batched plan for ``assignment``.

    ``outputs`` picks the returned node set: "sinks" (serving) or "all" (the
    interpreted executor's report surface). ``epilogues`` defaults on for
    "sinks" plans and is forced off for "all" (fused interior nodes would
    not be reportable); it is part of the cache key, as is ``batch_shape``.
    """
    if outputs not in ("sinks", "all"):
        raise ValueError(outputs)
    eff_ep = (outputs == "sinks") if epilogues is None \
        else (epilogues and outputs == "sinks")
    key = (_spec_key(spec), tuple(sorted(assignment.items())),
           batch_shape, outputs, eff_ep)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
        return plan
    steps, layout_of = lower(spec, assignment, epilogues=eff_ep)
    sinks = sink_nodes(spec)
    want = sinks if outputs == "sinks" else list(range(len(spec.nodes)))
    plan = CompiledPlan(spec, dict(assignment), steps, layout_of,
                        source_nodes(spec), sinks, outputs,
                        _emit(steps, want),
                        epilogues=eff_ep,
                        epilogue_signature=epilogue_signature(steps))
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
        _PLAN_CACHE.popitem(last=False)
    return plan
