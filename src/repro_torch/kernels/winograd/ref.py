"""Oracles and library yardstick for the Winograd kernels (tests and
chip_smoke.py only): one broadcast ``torch.matmul`` over the transform
points, and the plain 3x3 convolution ``F.conv2d``. On the card, turn TF32
off first (``torch.backends.cudnn.allow_tf32 = False``)."""
import torch
import torch.nn.functional as F


def point_gemm_ref(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u (P, K, C), v (N, P, C, T) or (P, C, T) -> (N, P, K, T) or (P, K, T)."""
    return torch.matmul(u, v)


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (C, H, W), w (K, C, 3, 3) -> (K, H-2, W-2), stride 1, valid."""
    return F.conv2d(x[None], w)[0]
