"""Optimizers for the performance models (paper Table 3: Adam) — the port of
the part of ``repro.train.optim`` that perf-model training runs: ``adamw``,
``adam``, ``constant_schedule``, ``global_norm`` and ``clip_by_global_norm``.

The interface is the reference's functional one:

    opt = adamw(lr=1e-3, weight_decay=1e-5)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

``params`` and ``grads`` are trees of tensors (dicts, lists and tuples of
tensors, as ``perfmodel.init_mlp`` builds them). ``update`` returns new
tensors and never writes into ``params``. The update is written out to the
reference's formula in float32 (``m``, ``v`` in fp32, bias correction
``1 - b**step`` with ``step`` as float32, decoupled decay added to the
step, ``p - lr_t * delta``), not ``torch.optim.AdamW``, which decays as
``p * (1 - lr * wd)`` before the step and so rounds differently. The step
counter is a host integer in the state, and the scalars derived from it are
computed in float32 on the host, so an update never waits for the device.

The optimizers only the LM stack uses (``sgd``, ``adafactor``,
``warmup_cosine_schedule``, ``step_decay_schedule``, ``make_optimizer``)
come with the LM slice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

Params = Any
Schedule = Callable[[int], float]
LR = Union[float, Schedule]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Params, Any], tuple]


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts / lists / tuples, in the order
    ``tree_map`` visits them (dict keys sorted, as JAX flattens dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same positions of ``rest``,
    rebuilt in ``tree``'s structure; leaves are visited in ``tree_leaves``
    order, so ``fn`` may consume an iterator over a flat list of them."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _f32(x) -> float:
    """A host scalar rounded to float32, as the reference's 0-d arrays are."""
    return float(np.float32(x))


def _resolve_lr(lr: LR, step: int) -> float:
    return _f32(lr(step) if callable(lr) else lr)


def constant_schedule(value: float) -> Schedule:
    return lambda step: _f32(value)


def global_norm(tree: Params) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: Params, max_norm: float) -> Params:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree)


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = None) -> Optimizer:
    """AdamW with decoupled weight decay. With ``weight_decay=0`` this is the
    paper's Adam."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(params, grads, state):
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr_t = _resolve_lr(lr, step)
        b1t = _f32(1.0 - np.float32(b1) ** np.float32(step))
        b2t = _f32(1.0 - np.float32(b2) ** np.float32(step))

        def upd(p, g, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            delta = (m / b1t) / (torch.sqrt(v / b2t) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype), m, v

        with torch.no_grad():
            out = tree_map(upd, params, grads, state["m"], state["v"])
        pick = lambda i: tree_map(lambda _, o: o[i], params, out)
        return pick(0), {"step": step, "m": pick(1), "v": pick(2)}

    return Optimizer(init, update)


def adam(lr: LR, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)
