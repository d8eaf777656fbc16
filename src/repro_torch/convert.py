"""Parameters from the reference package into the port.

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
