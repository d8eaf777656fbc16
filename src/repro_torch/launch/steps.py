"""Step factories: the single-device part of ``repro.launch.steps``.

``make_train_step`` is the full update: loss -> grads -> optimizer. The
gradients are ``torch.autograd.grad`` of ``transformer.loss_fn`` with
respect to every parameter leaf (the reference's ``jax.value_and_grad``),
returned as the parameters' tree. llama3-405b trains with Adafactor (its
factored second moments keep the optimizer state small); every other
architecture with AdamW. The mesh-bound parts of the reference
(``make_aspec``, ``make_opt_shardings``, ``bind_cell``) are not ported.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.train import optim as optim_lib
from repro_torch.train.optim import tree_leaves, tree_map

OPTIMIZER_FOR_ARCH = {"llama3_405b": "adafactor"}
DEFAULT_LR = 3e-4


def optimizer_for(cfg: ArchConfig) -> Tuple[str, optim_lib.Optimizer]:
    name = OPTIMIZER_FOR_ARCH.get(cfg.name, "adamw")
    if name == "adafactor":
        return name, optim_lib.adafactor(DEFAULT_LR)
    return name, optim_lib.adamw(DEFAULT_LR, weight_decay=0.1)


def value_and_grad(params: T.Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, T.Params]:
    """(loss, grads): ``loss_fn``'s value, detached, and its gradient with
    respect to every leaf of ``params`` (zeros for a leaf it does not
    reach), in the leaves' dtypes."""
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = T.loss_fn(ps, cfg, batch)
        grads = torch.autograd.grad(loss, tree_leaves(ps), allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _microbatch(batch: Dict[str, torch.Tensor], i: int, n: int) -> Dict:
    """The ``i``-th of ``n`` equal slices of every batched tensor's rows."""
    def part(x):
        if isinstance(x, torch.Tensor) and x.ndim:
            rows = x.shape[0] // n
            return x[i * rows:(i + 1) * rows]
        return x
    return {k: part(v) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, opt: optim_lib.Optimizer,
                    grad_accum: int = 1, grad_dtype: Optional[torch.dtype] = None
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.
    With ``grad_accum > 1`` the batch is split into microbatches run in
    turn, their losses and gradients summed in fp32 and divided by
    ``grad_accum``. ``grad_dtype`` casts the gradients before the update
    (the reference's gradient compression)."""

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(params, cfg, batch)
        else:
            loss = None
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(grad_accum):
                l, g = value_and_grad(params, cfg, _microbatch(batch, i, grad_accum))
                loss = l.float() if loss is None else loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        if grad_dtype is not None:
            grads = tree_map(lambda g: g.to(grad_dtype), grads)
        params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """``prefill_step(params, batch) -> (last logits, cache)``, no grad."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return T.prefill(params, cfg, batch["tokens"],
                             prefix_embeds=batch.get("prefix_embeds"),
                             enc_embeds=batch.get("enc_embeds"))
    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """``serve_step(params, cache, tokens, pos) -> (logits, cache)``, no grad."""
    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return T.decode_step(params, cfg, cache, tokens, pos)
    return serve_step
