"""Parameters and performance models from the reference package into the
port.

The reference keeps a network's parameters as ``{node: array}`` (conv
weights ``(k, c, f, f)``, bias vectors ``(c,)``) and an MLP's as a list of
``{"w": (fan_in, fan_out), "b": (fan_out,)}`` layers; the port keeps the
same structures of float32 tensors on a device, in the same layouts.
Arrays cross as numpy (``np.asarray`` of a JAX array), so this module
imports no JAX.
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
