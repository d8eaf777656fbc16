"""Matmul with a fused bias -> residual -> ReLU epilogue on the tensor
cores: the port of the Pallas kernels ``repro.kernels.matmul.matmul.matmul``
and ``matmul_batch``, with their dtype contract.

``matmul`` and ``matmul_batch`` launch a kernel for CUDA tensors and
compute ``matmul_plain`` / ``matmul_batch_plain`` — the same functions in
plain torch, no padding — for CPU tensors. Operands are fp32 (run at fp32
accuracy, 3xTF32) or bf16 (bf16 tensor-core products), the two of one call
of one dtype; bias and residual each have the operands' dtype or fp32 (a
bf16 product takes an fp32 bias or residual). The sum is fp32 and the
epilogue runs on it in fp32, widening bias and residual, as the
reference's ``_finish`` does; the output is stored once in ``out_dtype``
(fp32 or bf16, default: the operands' dtype), the reference's signature.

The caller names the kernel, ``route`` (``ROUTES``): ``"mma.sync"``
(``csrc/matmul.cu``, either dtype, any shape) or, for bf16 operands that
``takes_wgmma`` accepts (M >= 64, any alignment), ``"wgmma"``
(``csrc/matmul_wgmma.cu``: Hopper's warpgroup MMA, each operand loaded by
TMA where TMA can address it and gathered by a producer warpgroup where it
cannot; ``loaders`` says which, from the call alone). ``ops.route`` is the
rule the entry points use. A call that names ``"wgmma"`` on operands it
cannot take raises ``ValueError``; it is never run on the other route. The
caller also names the launch plan: a tile ``(bm, bk, bn)`` that the route's
source instantiates (mma.sync: ``TILE_M`` x ``TILE_K`` x ``TILE_N`` for
fp32, ``TILE_K_BF16`` deep for bf16; wgmma: ``bk`` = ``WGMMA_BK`` and
``(bm, bn, stages)`` one of ``WGMMA_TILES`` where both operands come by
TMA, else one of ``WGMMA_GATHER_TILES``) and ``split_k``, the number of
slices the K walk is cut into (``ops.cta_plan`` / ``ops.wgmma_plan`` choose
them per shape). With ``split_k > 1`` each slice writes its fp32 partial
sum to a workspace allocated here, and a second kernel adds the slices in a
fixed order and applies the epilogue once. Either route counts its launch
once, under ``matmul`` or ``matmul_batch``; the launch signature records
the route, its ring's stages and, on wgmma, the loaders.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (as_f32, bind, check_int32,
                                        check_launch, check_plan,
                                        count_launch, dtype_name, ep_name,
                                        epilogue, on_cpu, ptr, stream_of)
from repro_torch.kernels.common import cta_warps  # noqa: F401  (re-exported)

# CTA tile sizes csrc/matmul.cu instantiates (RT_FOR_EACH_MMA_TILE,
# RT_FOR_EACH_BF16_TILE): every BM of TILE_M with every BN of TILE_N and
# every BK of TILE_K (fp32) or TILE_K_BF16 (bf16: a stage of the same bytes)
TILE_M = (16, 32, 64, 128)
TILE_N = (8, 32, 64, 128)
TILE_K = (16, 32)
TILE_K_BF16 = (32, 64)
MMA_STAGES = 3                 # the mma.sync ring (mma_tf32.cuh, mma_bf16.cuh)
# (BM, BN, stages) tiles csrc/matmul_wgmma.cu instantiates
# (RT_FOR_EACH_WGMMA_TILE), each WGMMA_BK deep: the six variant ceilings of
# ops.WGMMA_CEILINGS and the smaller BM / BN that ops.wgmma_plan fits them to
WGMMA_TILE_M = (64, 128)              # one or two consumer warpgroups
WGMMA_TILE_N = (64, 128, 256)
WGMMA_TILES = tuple((bm, bn, s) for s in (3, 4) for bm in WGMMA_TILE_M
                    for bn in WGMMA_TILE_N) + ((64, 64, 8), (64, 128, 8))
WGMMA_BK = 64                  # one 128-byte swizzle row of A
# (BM, BN, stages) tiles of csrc/matmul_wgmma.cu's gathered kernel
# (RT_FOR_EACH_GATHER_TILE, kGatherStages): calls with B gathered and A by
# TMA; a gathered A takes WGMMA_GATHER_A_TILE alone (kGatherABM, kGatherABN)
WGMMA_GATHER_STAGES = 4
WGMMA_GATHER_TILES = tuple((bm, 64, WGMMA_GATHER_STAGES) for bm in WGMMA_TILE_M)
WGMMA_GATHER_A_TILE = (64, 64, WGMMA_GATHER_STAGES)
# B's rows shorter than this, with A broadcast over more than one entry,
# are packed across the entries (csrc/matmul_wgmma.cu's kPackN)
WGMMA_PACK_N = 64
LOADERS = ("tma", "gather")    # how the wgmma route loads an operand
ROUTES = ("mma.sync", "wgmma")
OUT_DTYPES = (torch.float32, torch.bfloat16)
# operand dtype -> (library, suffix of its C entry points)
_LIB = {torch.float32: ("matmul", "f32"), torch.bfloat16: ("matmul_bf16", "bf16")}


def tile_k(dtype: torch.dtype) -> tuple:
    """The K depths instantiated for operands of ``dtype``."""
    return TILE_K_BF16 if dtype == torch.bfloat16 else TILE_K


def takes_wgmma(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the wgmma route can take ``x`` (M, K) @ ``y`` (K, N), or the
    batched (B, M, K) @ (B, K, N): bf16 operands, M >= 64 (one warpgroup's
    rows), K and N positive, whatever their alignment (``loaders`` says how
    each operand is read). Plain comparisons: an entry point asks on every
    call."""
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        return False
    M, K, N = x.shape[-2], x.shape[-1], y.shape[-1]
    return M >= 64 and K >= 1 and N >= 1


def loaders(x: torch.Tensor, y: torch.Tensor) -> str:
    """How the wgmma route loads ``x`` (A) and ``y`` (B), as ``"a/b"``:
    each ``"tma"`` where TMA can address every row (its row length, K for A
    and N for B, a multiple of 8, so rows start on 16-byte boundaries; a
    16-byte aligned base; a batch stride, 0 for a broadcast or a batch of
    one, that is a multiple of 8 elements), else ``"gather"`` (the
    producer warpgroup reads aligned windows and realigns them). From the
    call alone; both ``"tma"`` is the route's first kernel, unchanged."""
    K, N = x.shape[-1], y.shape[-1]
    tma = [n % 8 == 0 and t.data_ptr() % 16 == 0 and _batch_stride_of(t) % 8 == 0
           for t, n in ((x, K), (y, N))]
    return "/".join(LOADERS[0] if ok else LOADERS[1] for ok in tma)


def packs(x: torch.Tensor, y: torch.Tensor, how: str) -> bool:
    """Whether the gathered kernel packs B's short rows across the batch
    under loaders ``how``: B gathered beside a TMA A (``"tma/gather"``), A
    broadcast (batch stride 0) over more than one entry, N <
    ``WGMMA_PACK_N``; its tiles' columns then run over the (entry, n)
    pairs."""
    return (how == "tma/gather" and x.dim() == 3 and x.shape[0] > 1
            and _batch_stride_of(x) == 0 and y.shape[-1] < WGMMA_PACK_N)


def wgmma_tiles(how: str) -> tuple:
    """The (BM, BN, stages) tiles instantiated for loaders ``how``: the TMA
    kernel's where both operands come by TMA, the gathered kernel's where B
    alone is gathered, its one A-gathering tile where A is."""
    if how == "tma/tma":
        return WGMMA_TILES
    return WGMMA_GATHER_TILES if how == "tma/gather" else (WGMMA_GATHER_A_TILE,)


def _batch_stride_of(t: torch.Tensor) -> int:
    """The stride between the matrices of a batched operand: 0 for a 2-D
    operand or a batch of one."""
    return t.stride(0) if t.dim() == 3 and t.shape[0] > 1 else 0


def _route_plan(name: str, x, y, K: int, bm: int, bk, bn: int, split_k: int,
                route: str, stages) -> tuple:
    """Check the launch plan on ``route`` and return its (bk, stages,
    loaders): the tile must be instantiated for the route, dtype and (on
    wgmma) loaders, each split slice own a step, and a wgmma call name
    operands ``takes_wgmma`` accepts. Loaders are None on mma.sync."""
    if route == "mma.sync":
        bk = tile_k(x.dtype)[0] if bk is None else bk
        if stages not in (None, MMA_STAGES):
            raise ValueError(f"{name}: the mma.sync ring has {MMA_STAGES} "
                             f"stages, got {stages}")
        check_plan(name, K, bm, bk, bn, split_k, TILE_M, tile_k(x.dtype),
                   TILE_N)
        return bk, MMA_STAGES, None
    if route != "wgmma":
        raise ValueError(f"{name}: route must be one of {ROUTES}, got {route!r}")
    if not takes_wgmma(x, y):
        raise ValueError(f"{name}: the wgmma route takes bf16 operands with "
                         f"M >= 64; got {x.dtype} {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    how = loaders(x, y)
    tiles = wgmma_tiles(how)
    bk = WGMMA_BK if bk is None else bk
    stages = tiles[0][2] if stages is None else stages
    check_plan(name, K, bm, bk, bn, split_k, WGMMA_TILE_M, (WGMMA_BK,),
               WGMMA_TILE_N)
    if (bm, bn, stages) not in tiles:
        raise ValueError(f"{name}: ({bm}, {bk}, {bn}) x {stages} stages is not "
                         f"an instantiated wgmma tile for loaders {how}")
    return bk, stages, how


def _out_dtype(name: str, x: torch.Tensor, out_dtype) -> torch.dtype:
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    return out_dtype


def _bf16(out_dtype, bias, residual) -> tuple:
    """The entry points' flags (out_bf16, bias_bf16, res_bf16)."""
    ep = [None if t is None else t.dtype for t in (bias, residual)]
    return tuple(int(d == torch.bfloat16) for d in (out_dtype, *ep))


def _plain(x, y, bias, residual, relu, out_dtype, channel_axis):
    """The product in fp32 on the operands' values, the epilogue in fp32,
    one cast to ``out_dtype`` (or the operands' dtype)."""
    out = epilogue(as_f32(x) @ as_f32(y), as_f32(bias), as_f32(residual),
                   relu, channel_axis)
    return out.to(x.dtype if out_dtype is None else out_dtype)


def matmul_plain(x: torch.Tensor, y: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False, out_dtype=None) -> torch.Tensor:
    """x (M, K) @ y (K, N), then bias (M,) -> residual (M, N) -> ReLU, in
    fp32, stored as ``out_dtype`` (default: the operands' dtype)."""
    return _plain(x, y, bias, residual, relu, out_dtype, channel_axis=0)


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 64,
           bk: Optional[int] = None, bn: int = 64, split_k: int = 1,
           bias: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None,
           relu: bool = False, out_dtype=None, route: str = "mma.sync",
           stages: Optional[int] = None) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) in ``out_dtype`` (default: the
    operands' dtype), the epilogue applied once to the fp32 sum. ``bias``
    is (M,), ``residual`` is (M, N). Ragged edges are zero-filled in the
    kernel; shapes need not divide the tile. ``route`` names the kernel
    (``ROUTES``); ``bk`` defaults to the route's shallowest instantiated
    depth at the dtype, ``stages`` to the route's smallest ring."""
    M, K = x.shape
    K2, N = y.shape
    if K != K2:
        raise ValueError(f"matmul: inner dims {x.shape} @ {y.shape}")
    if bias is not None and tuple(bias.shape) != (M,):
        raise ValueError(f"matmul: bias {tuple(bias.shape)} != ({M},)")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"matmul: residual {tuple(residual.shape)} != ({M}, {N})")
    out_dtype = _out_dtype("matmul", x, out_dtype)
    bk, stages, how = _route_plan("matmul", x, y, K, bm, bk, bn, split_k,
                                  route, stages)
    check_int32("matmul", M=M, N=N, K=K)
    if on_cpu("matmul", x, y, epilogue=(bias, residual)):
        return matmul_plain(x, y, bias=bias, residual=residual, relu=relu,
                            out_dtype=out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws = (torch.empty((split_k, M, N), dtype=torch.float32, device=x.device)
          if split_k > 1 else None)
    if route == "wgmma":
        err = _wgmma(x, y, bias, residual, out, ws, 1, M, N, K, relu, bm, bn,
                     stages, split_k, out_dtype, how, 0, 0)
    else:
        lib, suffix = _LIB[x.dtype]
        fn = bind(lib, f"rt_matmul_{suffix}", 6, 11)
        err = fn(ptr(x), ptr(y), ptr(bias), ptr(residual), ptr(out), ptr(ws),
                 M, N, K, int(relu), bm, bn, bk, split_k,
                 *_bf16(out_dtype, bias, residual), stream_of(x))
    check_launch("matmul", err)
    count_launch("matmul", (M, K, N, bm, bk, bn, split_k, ep_name(bias),
                            ep_name(residual), bool(relu), route, stages, how,
                            dtype_name(x.dtype), dtype_name(out_dtype)))
    return out


def _wgmma(x, y, bias, residual, out, ws, B, M, N, K, relu, bm, bn, stages,
           split_k, out_dtype, how, sx, sy) -> int:
    """Launch csrc/matmul_wgmma.cu's kernel under loaders ``how``; its
    cudaError_t."""
    fn = bind("matmul_wgmma", "rt_matmul_wgmma_bf16", 6, 14, n_longs=2)
    gather = [int(h == "gather") for h in how.split("/")]
    return fn(ptr(x), ptr(y), ptr(bias), ptr(residual), ptr(out), ptr(ws), B,
              M, N, K, int(relu), bm, bn, stages, split_k,
              *_bf16(out_dtype, bias, residual), *gather, sx, sy, stream_of(x))


def matmul_batch_plain(x: torch.Tensor, y: torch.Tensor, *,
                       bias: Optional[torch.Tensor] = None,
                       residual: Optional[torch.Tensor] = None,
                       relu: bool = False, out_dtype=None) -> torch.Tensor:
    """x (B, M, K) @ y (B, K, N), then bias (M,) -> residual (B, M, N) ->
    ReLU, in fp32, stored as ``out_dtype`` (default: the operands' dtype)."""
    return _plain(x, y, bias, residual, relu, out_dtype, channel_axis=1)


def _batch_stride(name: str, t: torch.Tensor) -> int:
    """Element stride between the matrices of a (B, R, C) operand whose
    matrices are each contiguous: 0 for a batch broadcast with ``expand``."""
    if not t[0].is_contiguous():
        raise ValueError(f"{name}: each matrix of the batch must be contiguous")
    return _batch_stride_of(t)


def matmul_batch(x: torch.Tensor, y: torch.Tensor, *, bm: int = 64,
                 bk: Optional[int] = None, bn: int = 64, split_k: int = 1,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False, out_dtype=None, route: str = "mma.sync",
                 stages: Optional[int] = None) -> torch.Tensor:
    """x (B, M, K) @ y (B, K, N) -> (B, M, N) in ``out_dtype`` (default: the
    operands' dtype), the batch on the grid's z axis, with the epilogue
    applied once to the fp32 sum. ``bias`` is
    (M,), ``residual`` is (B, M, N). ``x`` and ``y`` may be broadcast over
    the batch (``expand``, batch stride 0): the kernel reads such an operand
    in place through its batch stride (passed as 64 bits), and no copy per
    batch entry is made. Ragged edges are zero-filled in the kernel.
    ``route`` and ``stages`` as in ``matmul``."""
    B, M, K = x.shape
    B2, K2, N = y.shape
    if (B, K) != (B2, K2) or B < 1:
        raise ValueError(f"matmul_batch: {tuple(x.shape)} @ {tuple(y.shape)}")
    if bias is not None and tuple(bias.shape) != (M,):
        raise ValueError(f"matmul_batch: bias {tuple(bias.shape)} != ({M},)")
    if residual is not None and tuple(residual.shape) != (B, M, N):
        raise ValueError(f"matmul_batch: residual {tuple(residual.shape)} "
                         f"!= {(B, M, N)}")
    out_dtype = _out_dtype("matmul_batch", x, out_dtype)
    bk, stages, how = _route_plan("matmul_batch", x, y, K, bm, bk, bn,
                                  split_k, route, stages)
    check_int32("matmul_batch", B=B, M=M, N=N, K=K)
    sx, sy = _batch_stride("matmul_batch", x), _batch_stride("matmul_batch", y)
    if on_cpu("matmul_batch", x[0], y[0], epilogue=(bias, residual)):
        return matmul_batch_plain(x, y, bias=bias, residual=residual, relu=relu,
                                  out_dtype=out_dtype)
    out = torch.empty((B, M, N), dtype=out_dtype, device=x.device)
    ws = (torch.empty((split_k, B, M, N), dtype=torch.float32, device=x.device)
          if split_k > 1 else None)
    if route == "wgmma":
        err = _wgmma(x, y, bias, residual, out, ws, B, M, N, K, relu, bm, bn,
                     stages, split_k, out_dtype, how, sx, sy)
    else:
        lib, suffix = _LIB[x.dtype]
        fn = bind(lib, f"rt_matmul_batch_{suffix}", 6, 12, n_longs=2)
        err = fn(ptr(x), ptr(y), ptr(bias), ptr(residual), ptr(out), ptr(ws),
                 B, M, N, K, int(relu), bm, bn, bk, split_k,
                 *_bf16(out_dtype, bias, residual), sx, sy, stream_of(x))
    check_launch("matmul_batch", err)
    count_launch("matmul_batch", (B, M, K, N, sx == 0, sy == 0, bm, bk, bn,
                                  split_k, ep_name(bias), ep_name(residual),
                                  bool(relu), route, stages, how,
                                  dtype_name(x.dtype), dtype_name(out_dtype)))
    return out
