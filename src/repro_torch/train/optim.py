"""Optimizers and LR schedules in torch: the port of ``repro.train.optim``
(``sgd``, ``adam``, ``adamw``, ``adafactor``, the constant, warmup-cosine
and step-decay schedules, ``global_norm``, ``clip_by_global_norm`` and
``make_optimizer``). The performance models train with ``adamw`` (paper
Table 3: Adam); the LM training path (``launch.steps``) with ``adamw`` or
``adafactor``.

The interface is the reference's functional one:

    opt = adamw(lr=1e-3, weight_decay=1e-5)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

``params`` and ``grads`` are trees of tensors (dicts, lists and tuples of
tensors, as ``perfmodel.init_mlp`` and ``transformer.init_params`` build
them). ``update`` returns new tensors and never writes into ``params``.
Each update is written out to the reference's formula in float32, not
``torch.optim``: AdamW keeps ``m``, ``v`` in fp32, corrects bias with
``1 - b**step`` and adds the decoupled decay to the step before ``p - lr_t *
delta`` (``torch.optim.AdamW`` decays as ``p * (1 - lr * wd)`` first and so
rounds differently); Adafactor takes its factored means and its RMS clip
over the whole leaf, a stacked ``(n_layers, ...)`` one included. The step
counter is a host integer in the state, and the scalars derived from it
(learning rate, bias corrections, Adafactor's ``beta2``) are computed in
float32 on the host, so an update never waits for the device.
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


def tree_named_leaves(tree, path: str = "") -> list:
    """(name, leaf) pairs of a tree of dicts / lists / tuples in the order
    ``tree_map`` visits them: dict keys sorted and list or tuple indices,
    joined by ``/``, as JAX's ``tree_flatten_with_path`` names them; a
    ``None`` subtree carries no leaf, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(path, tree)]
    return [kv for k, t in items
            for kv in tree_named_leaves(t, f"{path}/{k}" if path else str(k))]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_named_leaves`` order."""
    return [leaf for _, leaf in tree_named_leaves(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same positions of ``rest``,
    rebuilt in ``tree``'s structure; ``None`` subtrees pass through. Leaves
    are visited in ``tree_leaves`` order, so ``fn`` may consume an iterator
    over a flat list of them."""
    if tree is None:
        return None
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


# ---------------------------------------------------------------------------
# Schedules (host step in, float32 learning rate out)
# ---------------------------------------------------------------------------

def constant_schedule(value: float) -> Schedule:
    return lambda step: _f32(value)


def warmup_cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                           floor: float = 0.0) -> Schedule:
    """Linear warmup to ``peak`` over ``warmup_steps``, then a cosine decay
    to ``floor`` at ``total_steps``, in float32 as the reference computes
    it."""
    f = np.float32

    def sched(step):
        s = f(step)
        if s < f(warmup_steps):
            return _f32(f(peak) * s / f(max(1.0, warmup_steps)))
        frac = np.clip((s - f(warmup_steps)) / f(max(1.0, total_steps - warmup_steps)),
                       f(0.0), f(1.0))
        # the reference multiplies (peak - floor) * 0.5 as Python floats
        return _f32(f(floor) + f((peak - floor) * 0.5)
                    * (f(1.0) + np.cos(f(np.pi) * frac)))
    return sched


def step_decay_schedule(base: float, decay: float, every: int) -> Schedule:
    """Multiply lr by ``decay`` every ``every`` steps (paper's fine-tune: x0.1)."""
    f = np.float32

    def sched(step):
        return _f32(f(base) * f(decay) ** np.floor(f(step) / f(every)))
    return sched


# ---------------------------------------------------------------------------
# Gradient transforms
# ---------------------------------------------------------------------------


def global_norm(tree: Params) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: Params, max_norm: float) -> Params:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree)


def _descend(p: torch.Tensor, lr_t: float, u: torch.Tensor) -> torch.Tensor:
    """``p - lr_t * u`` with the reference's dtype: its ``lr_t`` is a float32
    array, so a bf16 ``p`` comes out float32."""
    dt = torch.promote_types(torch.promote_types(p.dtype, u.dtype), torch.float32)
    return p.to(dt) - lr_t * u.to(dt)


def sgd(lr: LR, momentum: float = 0.0) -> Optimizer:
    """Plain SGD, or heavy-ball momentum ``m = momentum * m + g`` kept in the
    parameters' dtype."""

    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": 0, "mom": mom}

    def update(params, grads, state):
        step = state["step"] + 1
        lr_t = _resolve_lr(lr, step)
        with torch.no_grad():
            if momentum:
                mom = tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
                new = tree_map(lambda p, m: _descend(p, lr_t, m), params, mom)
                return new, {"step": step, "mom": mom}
            new = tree_map(lambda p, g: _descend(p, lr_t, g), params, grads)
        return new, {"step": step, "mom": None}

    return Optimizer(init, update)


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


def adafactor(lr: LR, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, min_dim_size_to_factor: int = 128,
              momentum: Optional[float] = None,
              momentum_dtype: torch.dtype = torch.bfloat16) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018). The second moment of any leaf whose
    trailing two dims are both at least ``min_dim_size_to_factor`` is kept
    as row and column statistics (``vr``, ``vc``), else whole (``v``).
    ``momentum=None`` keeps no first moment; otherwise it is kept in
    ``momentum_dtype`` and the update uses its fp32 value before the cast."""

    def _factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def per(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
                        "v": None}
            return {"vr": None, "vc": None, "v": torch.zeros(p.shape, **f32)}
        state = {"step": 0, "v": tree_map(per, params)}
        if momentum is not None:
            state["m"] = tree_map(lambda p: torch.zeros_like(p, dtype=momentum_dtype),
                                  params)
        return state

    def update(params, grads, state):
        step = state["step"] + 1
        lr_t = _resolve_lr(lr, step)
        beta2 = _f32(1.0 - np.float32(step) ** np.float32(-decay))

        def upd(p, g, vs, m):
            g = g.float()
            g2 = g * g + eps
            if vs["v"] is None:
                vr = beta2 * vs["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * vs["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                row_mean = torch.mean(vr, dim=-1, keepdim=True)[..., None]
                denom = torch.sqrt(vr[..., :, None] * vc[..., None, :]
                                   / torch.clamp(row_mean, min=eps))
                new_vs = {"vr": vr, "vc": vc, "v": None}
            else:
                v = beta2 * vs["v"] + (1 - beta2) * g2
                denom = torch.sqrt(v)
                new_vs = {"vr": None, "vc": None, "v": v}
            u = g / torch.clamp(denom, min=eps)
            # update clipping by RMS, over the whole leaf
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            new_m = None
            if m is not None:
                u = momentum * m.float() + (1 - momentum) * u
                new_m = u.to(momentum_dtype)
            return (p.float() - lr_t * u).to(p.dtype), new_vs, new_m

        ms = state["m"] if momentum is not None else tree_map(lambda _: None, params)
        with torch.no_grad():
            out = tree_map(upd, params, grads, state["v"], ms)
        pick = lambda i: tree_map(lambda _, o: o[i], params, out)
        new_state = {"step": step, "v": pick(1)}
        if momentum is not None:
            new_state["m"] = pick(2)
        return pick(0), new_state

    return Optimizer(init, update)


OPTIMIZERS = {
    "sgd": sgd,
    "adam": adam,
    "adamw": adamw,
    "adafactor": adafactor,
}


def make_optimizer(name: str, lr: LR, **kw) -> Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](lr, **kw)
