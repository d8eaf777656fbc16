"""Parameters and performance models from the reference package into the
port.

The reference keeps a network's parameters as ``{node: array}`` (conv
weights ``(k, c, f, f)``, bias vectors ``(c,)``); the port keeps the same
dict of float32 tensors on a device, in the same layouts. Arrays cross as
numpy (``np.asarray`` of a JAX array), so this module imports no JAX.
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
