"""Oracle and library yardstick for the matmul kernel (tests and
chip_smoke.py only): ``torch.matmul``, full fp32 unless TF32 is enabled."""
import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, y)
