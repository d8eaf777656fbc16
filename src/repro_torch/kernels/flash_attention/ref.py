"""Library yardstick for the flash attention kernel (chip_smoke.py only):
``F.scaled_dot_product_attention``, a timing reference and nothing else —
the port never calls it. Its ``is_causal`` mask is top-left aligned, as the
kernel's is."""
import torch
import torch.nn.functional as F


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale=None) -> torch.Tensor:
    """(BH, Sq, d) x (BH, Sk, d) -> (BH, Sq, d), as one 4-D SDPA call (the
    fused SDPA backends take 4-D operands only)."""
    return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                          is_causal=causal, scale=scale)[0]
