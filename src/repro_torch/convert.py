"""Parameters and performance models from the reference package into the
port.

The reference keeps a network's parameters as ``{node: array}`` (conv
weights ``(k, c, f, f)``, bias vectors ``(c,)``), an MLP's as a list of
``{"w": (fan_in, fan_out), "b": (fan_out,)}`` layers and a language
model's as nested dicts with each layer's arrays stacked on a leading
``n_layers`` axis; the port keeps the same structures of tensors on a
device, in the same layouts. Arrays cross as numpy (``np.asarray`` of a JAX
array), so this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch


def weights_from_jax(weights: Dict[int, np.ndarray],
                     device: Union[str, torch.device] = "cuda") -> Dict[int, torch.Tensor]:
    """``{node: array}`` -> ``{node: float32 tensor on device}``, same layouts."""
    return {int(k): torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in weights.items()}


def mlp_params_from_jax(params, device: Union[str, torch.device] = "cuda"):
    """The reference's ``init_mlp`` / ``train_mlp`` parameters (a list of
    ``{"w", "b"}`` layers, or for an nn1 ensemble a list of such lists),
    as numpy or JAX arrays -> the same structure of float32 tensors on
    ``device``, ready for ``train_mlp(init_params=...)`` or a ``PerfModel``."""
    if params and isinstance(params[0], (list, tuple)):
        return [mlp_params_from_jax(p, device) for p in params]
    return [{k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
             for k, v in layer.items()} for layer in params]


def perfmodel_from_state(state: dict, device="cuda"):
    """The reference's ``PerfModel.to_state()`` (a JSON-able header and
    numpy arrays) -> the port's ``PerfModel`` with its parameters on
    ``device``. Committed models cross as the same npz file instead
    (``PerfModel.load``)."""
    from repro_torch.core.perfmodel import PerfModel
    return PerfModel.from_state(
        {"header": state["header"],
         "arrays": {k: np.asarray(v) for k, v in state["arrays"].items()}},
        device)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array -> a tensor of its own dtype on ``device``. bfloat16
    (``ml_dtypes``, which plain numpy lacks) crosses bit for bit as uint16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_jax(params, device: Union[str, torch.device] = "cuda"):
    """The reference's ``transformer.init_params`` tree (nested dicts of
    numpy or JAX arrays) -> the port's: the same keys and stacked layouts,
    each array in its own dtype, on ``device``."""
    if isinstance(params, dict):
        return {k: lm_params_from_jax(v, device) for k, v in params.items()}
    return _tensor(params, device)
