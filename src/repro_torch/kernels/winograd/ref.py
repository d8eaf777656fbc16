"""Oracle and library yardstick for the point-GEMM kernel (tests and
chip_smoke.py only): one broadcast ``torch.matmul`` over (n, p)."""
import torch


def point_gemm_ref(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u (P, K, C), v (N, P, C, T) -> (N, P, K, T)."""
    return torch.matmul(u, v)
