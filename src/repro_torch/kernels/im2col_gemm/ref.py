"""Oracle and library yardstick for the conv kernel (tests and
chip_smoke.py only): ``F.conv2d``. On the card, turn TF32 off first
(``torch.backends.cudnn.allow_tf32 = False``)."""
import torch
import torch.nn.functional as F


def conv_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return F.conv2d(x, w, stride=stride)
