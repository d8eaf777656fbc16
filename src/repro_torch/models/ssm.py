"""Mamba2 SSD (state-space duality) blocks in torch, arXiv:2405.21060: the
port of ``repro.models.ssm``.

Prefill runs the chunked SSD algorithm: within a chunk, attention-like
batched products; across chunks, a short recurrence over the chunk states.
Decode is the O(1)-a-token state update. d_inner = expand * d_model, heads
= d_inner / headdim; x and z from ``in_proj``, B and C per group, dt per
head, a scalar A per head, and a depthwise causal conv over the (x, B, C)
channels.

The reference's dtype casts are kept (in a bf16 model: the decay matrix cast
to the scores' bf16, the dt-weighted input promoted to fp32 by the fp32 dt,
the decode read-out from the state cast to C's dtype). Its three-operand
einsums are written as two-operand steps whose largest intermediate is the
(b, c, h, l, l) decay matrix itself. A sequence longer than the chunk must
be a multiple of it (``ValueError``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.components import (dense_init, normal, promoted, rmsnorm,
                                           rmsnorm_init)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    n_groups: int = 1
    d_conv: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


def ssm_init(gen: torch.Generator, d_model: int, cfg: SSMConfig,
             dtype=torch.bfloat16) -> Dict:
    din = cfg.d_inner(d_model)
    H = cfg.n_heads(d_model)
    conv_dim = din + 2 * cfg.n_groups * cfg.d_state
    d_in_proj = 2 * din + 2 * cfg.n_groups * cfg.d_state + H
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d_model, d_in_proj, dtype),
        "conv_w": normal(gen, (cfg.d_conv, conv_dim), 0.2, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(din, device=dev),
        "out_proj": dense_init(gen, din, d_model, dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L): out[..., i, j] = x[j+1] + ... + x[i] for
    j <= i, -inf above the diagonal. Each segment is summed directly (a
    cumsum down the columns of x masked to k > j), not as a difference of
    two prefix sums as the reference does: the same values, but backward
    then sums each x[k]'s block of gradients instead of subtracting two
    large sums that share the diagonal's mass, which in fp32 costs the
    gradients of A and dt most of their precision at a 256-token chunk."""
    L = x.shape[-1]
    ones = torch.ones((L, L), dtype=torch.bool, device=x.device)
    below = torch.where(torch.tril(ones, -1), x[..., :, None], 0.0)   # [k, j] = x[k], k > j
    return torch.cumsum(below, dim=-2).masked_fill(~torch.tril(ones), -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. x (b, s, h, p); dt (b, s, h) after softplus; A (h,)
    negative; B, C (b, s, g, n), the g groups shared by the heads (their
    products summed over g, as the reference's einsums do). Returns
    (y (b, s, h, p), final state (b, h, p, n))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of the "
                         f"chunk {chunk}")

    xs = x.reshape(b, nc, chunk, h, p)
    dts = dt.reshape(b, nc, chunk, h)
    Bs = B.reshape(b, nc, chunk, g, n)
    Cs = C.reshape(b, nc, chunk, g, n)
    dA = (dts * A[None, None, None, :]).movedim(-1, 2)             # (b, nc, h, l)
    dA_cum = torch.cumsum(dA, dim=-1)

    # 1. intra-chunk (diagonal blocks)
    # out of place: exp's backward reads its own output; the -inf above
    # the diagonal gives exp 0 there, and the zeroed cells pass back 0
    Lmat = torch.exp(_segsum(dA))                                  # (b, nc, h, l, l)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    Lmat = torch.where(causal, Lmat, 0.0)
    xw = xs * dts[..., None]                                       # promoted by dt
    scores = torch.einsum("bcigs,bcjgs->bcgij", Cs, Bs)            # (b, nc, g, l, l)
    scores = torch.repeat_interleave(scores, rep, dim=2)           # (b, nc, h, l, l)
    scores, Lc, xw_ = promoted(scores, Lmat.to(scores.dtype), xw)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores * Lc, xw_)
    del Lmat, Lc, scores

    # 2. chunk states: sum over l of B (summed over g) x decay x xw
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)            # (b, nc, h, l)
    Bg, dec, xw_ = promoted(Bs, decay_states.to(Bs.dtype), xw)
    xd = xw_ * dec.movedim(2, 3)[..., None]                        # (b, nc, l, h, p)
    states = torch.einsum("bclgs,bclhp->bchps", Bg, xd)            # (b, nc, h, p, n)

    # 3. inter-chunk recurrence, emitting each chunk's state before it
    chunk_decay = torch.exp(dA_cum[..., -1])                       # (b, nc, h)
    carry = init_state if init_state is not None else torch.zeros_like(states[:, 0])
    prior = []
    for c in range(nc):
        prior.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prior = torch.stack(prior, dim=1)                              # (b, nc, h, p, n)

    # 4. state -> output, in C's dtype
    out_decay = torch.exp(dA_cum)                                  # (b, nc, h, l)
    y_off = torch.einsum("bclgs,bchps->bclhp", Cs, prior.to(Cs.dtype))
    y_off = y_off * out_decay.to(Cs.dtype).movedim(2, 3)[..., None]
    y = y_diag + y_off
    return y.reshape(b, s, h, p), carry


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. u (B, S, C); w (K, C); ``state`` the last K-1
    inputs before u (zeros without). Returns (silu(conv + b), new state)."""
    K = w.shape[0]
    if state is None:
        up = F.pad(u, (0, 0, K - 1, 0))
    else:
        up = torch.cat(promoted(state, u), dim=1)
    S = u.shape[1]
    y = up[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + up[:, i:i + S] * w[i]
    return F.silu(y + b), up[:, -(K - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_block(params: Dict, x: torch.Tensor, cfg: SSMConfig, d_model: int,
              return_state: bool = False):
    """The Mamba2 block over a full sequence: x (B, S, D) -> (B, S, D), and
    with ``return_state`` also (ssm state (B, H, P, N) fp32, conv state: the
    last d_conv - 1 pre-conv inputs) for decode."""
    B_, S, D = x.shape
    din = cfg.d_inner(d_model)
    H = cfg.n_heads(d_model)
    g, n = cfg.n_groups, cfg.d_state

    zxbcdt = x @ params["in_proj"]["w"]
    z, xbc_raw, dt = torch.split(zxbcdt, [din, din + 2 * g * n, H], dim=-1)
    xbc, _ = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs, Bc, Cc = torch.split(xbc, [din, g * n, g * n], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    xh = xs.reshape(B_, S, H, cfg.headdim)
    y, final_state = ssd_chunked(xh, dt, A, Bc.reshape(B_, S, g, n),
                                 Cc.reshape(B_, S, g, n), min(cfg.chunk, S))
    y = y + xh * params["D"][None, None, :, None]
    y = rmsnorm(params["norm"], y.reshape(B_, S, din) * F.silu(z))
    out = (y @ params["out_proj"]["w"].to(y.dtype)).to(x.dtype)
    if return_state:
        return out, final_state, xbc_raw[:, -(cfg.d_conv - 1):, :]
    return out


def ssm_decode_step(params: Dict, x: torch.Tensor, cfg: SSMConfig, d_model: int,
                    ssm_state: torch.Tensor, conv_state: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token. x (B, 1, D); ssm_state (B, H, P, N); conv_state (B,
    d_conv - 1, conv_dim). Returns (y (B, 1, D), ssm_state, conv_state)."""
    B_, _, D = x.shape
    din = cfg.d_inner(d_model)
    H = cfg.n_heads(d_model)
    g, n = cfg.n_groups, cfg.d_state

    zxbcdt = x @ params["in_proj"]["w"]
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * g * n, H], dim=-1)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xs, Bc, Cc = torch.split(xbc, [din, g * n, g * n], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"])[:, 0]              # (B, H)
    A = -torch.exp(params["A_log"])

    xh = xs.reshape(B_, H, cfg.headdim)
    Bh = torch.repeat_interleave(Bc.reshape(B_, g, n), H // g, dim=1)  # (B, H, N)
    Ch = torch.repeat_interleave(Cc.reshape(B_, g, n), H // g, dim=1)
    dA = torch.exp(dt * A[None, :])                                   # (B, H)
    upd = (dt[..., None] * xh)[..., None] * Bh[:, :, None, :]         # (B, H, P, N)
    ssm_state = ssm_state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", ssm_state.to(Ch.dtype), Ch)
    y = y + xh * params["D"][None, :, None]
    y = rmsnorm(params["norm"], y.reshape(B_, 1, din) * F.silu(z))
    return (y @ params["out_proj"]["w"].to(y.dtype)).to(x.dtype), ssm_state, conv_state
