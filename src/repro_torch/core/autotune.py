"""Kernel-variant selection: the port of ``repro.core.autotune``.

Three parts.

**Tile columns of the conv kernels** (``PALLAS_CONV_BASES``,
``pallas_columns``). A tile column ``<base>@<variant>`` is a runnable base
primitive executed under one tile variant of a hand-written kernel
(``primitives/variants.py``); selection treats each pair as its own column.
The reference's columns take the matmul variants only; the port's take every
variant family its kernels have (``mm-*``, ``conv-bk*``, ``wino-*``),
filtered to the pairs the plan can run: 55 columns over the five bases, of
which the 40 ``mm-*`` ones are the reference's.

**The matmul-site autotune** (``matmul_sites``, ``build_dataset``,
``train_cost_model``, ``autotune_arch``): the paper's technique applied to
the matmul kernel at the GEMM sites of the LM configs. The "primitives" are
the 8 ``mm-*`` variants of ``kernels/matmul/ops.VARIANTS``, the "layers" the
per-device GEMMs of one layer of a config (QKV and output projections, MLP
up and down, expert GEMMs, SSM projections). An NN2 learns a GEMM's time
under each variant from (M, K, N); a chain PBQP with zero edges (a variant
switch moves no layout) picks a variant per site.

The costs are measured on the card: ``MeasuredCost`` times each variant
through ``matmul_op`` with ``profiler/device.time_callable`` (CUDA events,
the median of ``GEMM_REPEATS`` after ``GEMM_WARMUP``) on operands of its
``dtype``, bf16 by default: the reference tunes bf16 GEMMs (its surface
prices 2-byte operands, ``analytic_cost(..., dtype_bytes=2)``), and the
kernel takes bf16 on the card. ``GemmDataset.dtype`` records the dtype the
rows were timed at. The cost source is an argument
(``cost_fn(M, K, N, variant) -> seconds``), so the CPU tests inject the
reference's analytic surface instead. Sampling design of ``build_dataset``
(the reference prices 3,000 log-uniform GEMMs of up to 2^17 x 2^15 x 2^15,
one of them ~2.8e14 FLOPs, on an analytic surface; measured, that takes
hours):

1. the distinct sites of the ten configs at the reference's
   ``batch_tokens=65536, tp=16`` (``SITE_BATCH_TOKENS``, ``SITE_TP``), all of
   them, whatever their size;
2. then a sample seeded by ``seed``: M log-uniform in [2^7, 2^17], K and N in
   [2^7, 2^15] (the reference's ranges), a draw over ``SAMPLE_MAX_FLOPS``
   (2·M·K·N) redrawn, up to ``SAMPLE_ROWS`` rows, stopped early once the
   dataset's measuring time passes ``BUDGET_S`` seconds.

``AutotuneResult.oracle_s`` is the best of the measured (or injected) costs
per site, not the analytic surface.

**The analytic tile-cost surface** (``analytic_cost``,
``conv_tile_time_batch``, ``pallas_dlt_time_batch``, ``PallasTileProvider``):
the cost model of the simulated tile platform
(``service.platforms.PallasPlatform``), the reference's math and
counter-based noise, bit for bit. It prices the reference's blocks (the
``VARIANTS`` tables of the three kernels' ``ops``), never the card's
``CTA_TILES``, and its three constants are the simulated platform's
parameters, not a measurement of any device. Nothing here uses it as a
default: ``build_dataset`` and ``autotune_arch`` take it only as an
injected ``cost_fn``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.configs.base import ArchConfig
from repro_torch.core import pbqp
from repro_torch.core.perfmodel import PerfModel, fit_perf_model
from repro_torch.kernels.im2col_gemm.ops import VARIANTS as CONV_VARIANTS
from repro_torch.kernels.matmul.ops import VARIANTS as MM_VARIANTS, matmul_op
from repro_torch.kernels.winograd.ops import VARIANTS as WINO_VARIANTS
from repro_torch.primitives import layouts as L
from repro_torch.primitives.conv import (FAMILIES, compile_traits, name_hash64,
                                         split_tile, tile_columns)
from repro_torch.profiler.device import time_callable
from repro_torch.profiler.simulators import _lognormal, _mix64

# Kernel-backed base primitives: im2col lowerings ride the matmul or the
# implicit-GEMM conv kernel, winograd the Winograd point-GEMM, 1x1 the
# matmul or the implicit-GEMM conv. Only runnable bases.
PALLAS_CONV_BASES: Tuple[str, ...] = (
    "im2col-copy-ab-ki",
    "im2col-scan-ab-ki",
    "winograd-2x2-3x3",
    "winograd-4x4-3x3",
    "conv-1x1-gemm-ab-ki",
)

TILE_VARIANTS: Tuple[str, ...] = (*MM_VARIANTS, *CONV_VARIANTS, *WINO_VARIANTS)

SITE_BATCH_TOKENS = 65536           # the reference's autotune defaults
SITE_TP = 16
SAMPLE_ROWS = 400                   # sampled GEMMs beyond the sites, at most
SAMPLE_MAX_FLOPS = 2e11             # 2·M·K·N of one sampled GEMM, at most
BUDGET_S = 45.0                     # measuring seconds after which sampling stops
GEMM_WARMUP = 1                     # MeasuredCost: untimed calls ...
GEMM_REPEATS = 3                    # ... and timed ones (median) a variant

CostFn = Callable[[int, int, int, str], float]


def pallas_columns(bases: Sequence[str] = PALLAS_CONV_BASES,
                   variants: Optional[Sequence[str]] = None) -> List[str]:
    """The (base primitive × tile variant) column set, pairs the plan can
    run only; ``variants`` defaults to every variant of the three kernels."""
    return tile_columns(bases, list(variants) if variants is not None
                        else list(TILE_VARIANTS))


# ---------------------------------------------------------------------------
# The analytic tile-cost surface of the simulated tile platform. Each CNN
# layer config (k, c, im, s, f) lowers to the GEMM its base primitive runs;
# each (primitive, tile) column prices that GEMM under its block shape via
# ``analytic_cost``. The result is the simulators' (L, P) matrix contract:
# NaN where the base primitive is inapplicable, deterministic lognormal
# noise keyed on the full column name.
# ---------------------------------------------------------------------------

# Parameters of the simulated tile platform, the reference's values: peak
# product rate (FLOP/s), memory rate (bytes/s) and the on-chip tile memory
# (bytes) a block's working set must fit
_PEAK = 197e12
_HBM_BW = 819e9
_VMEM_BYTES = 64 * 2 ** 20
_TILE_SIGMA = 0.03                  # lognormal noise floor of the simulated profiler


def analytic_cost(M: int, K: int, N: int, bm: int, bk: int, bn: int,
                  dtype_bytes: int = 2) -> float:
    """Simulated seconds of a tiled (M,K)x(K,N) GEMM under (bm, bk, bn)
    blocks. Non-linear in the blocks: product-unit alignment, tile-memory
    residency, per-tile grid overheads and operands re-streamed across tile
    passes."""
    gm, gn, gk = -(-M // bm), -(-N // bn), -(-K // bk)
    # padding waste from tile quantisation
    eff_shape = (M / (gm * bm)) * (N / (gn * bn)) * (K / (gk * bk))
    # alignment: sub-128 blocks underuse the product unit
    align = min(bm, 128) / 128 * min(bn, 128) / 128 * min(bk, 128) / 128
    mxu_eff = 0.9 * eff_shape * (0.55 + 0.45 * align)
    # residency: the working set must fit the tile memory; overflow thrashes
    ws = dtype_bytes * (bm * bk + bk * bn) + 4 * bm * bn
    if ws > _VMEM_BYTES:
        mxu_eff *= 0.25
    flops = 2.0 * M * N * K
    t_compute = flops / (_PEAK * mxu_eff)
    # memory: x re-read gn times, y re-read gm times (output-stationary)
    traffic = dtype_bytes * (M * K * gn + K * N * gm) + dtype_bytes * M * N
    t_mem = traffic / _HBM_BW
    t_grid = gm * gn * gk * 1.2e-6      # per-tile dispatch overhead
    return max(t_compute, t_mem) + t_grid


def _analytic_cost_np(M, K, N, bm: int, bk: int, bn: int,
                      dtype_bytes: int = 2) -> np.ndarray:
    """Broadcasting twin of ``analytic_cost`` (identical math; the
    residency branch depends on the blocks only)."""
    M, K, N = (np.asarray(a, np.float64) for a in (M, K, N))
    gm, gn, gk = np.ceil(M / bm), np.ceil(N / bn), np.ceil(K / bk)
    eff_shape = (M / (gm * bm)) * (N / (gn * bn)) * (K / (gk * bk))
    align = min(bm, 128) / 128 * min(bn, 128) / 128 * min(bk, 128) / 128
    mxu_eff = 0.9 * eff_shape * (0.55 + 0.45 * align)
    ws = dtype_bytes * (bm * bk + bk * bn) + 4 * bm * bn
    if ws > _VMEM_BYTES:
        mxu_eff = mxu_eff * 0.25
    flops = 2.0 * M * N * K
    t_compute = flops / (_PEAK * np.maximum(mxu_eff, 1e-9))
    traffic = dtype_bytes * (M * K * gn + K * N * gm) + dtype_bytes * M * N
    t_mem = traffic / _HBM_BW
    t_grid = gm * gn * gk * 1.2e-6
    return np.maximum(t_compute, t_mem) + t_grid


def _variant_blocks(variant: Optional[str]) -> Tuple[int, int, int]:
    """(bm, bk, bn) GEMM blocks a tile variant names in the reference's
    tables: ``mm-*`` directly, ``conv-bkB`` its B-sized output-channel
    (GEMM M) block, ``wino-KxT`` the point-GEMM's (K, T) = (M, N) blocks;
    (128, 128, 128) for anything else."""
    if variant in MM_VARIANTS:
        return MM_VARIANTS[variant]
    if variant is not None and variant.startswith("conv-bk"):
        b = CONV_VARIANTS.get(variant)
        return (b, 128, 128) if b else (128, 128, 128)
    if variant is not None and variant.startswith("wino-"):
        kt = WINO_VARIANTS.get(variant)
        return (kt[0], 128, kt[1]) if kt else (128, 128, 128)
    return (128, 128, 128)


def _simulated_columns(columns: Optional[Sequence[str]]) -> Tuple[str, ...]:
    """``columns``, or the simulated platform's default: the reference's 40,
    ``PALLAS_CONV_BASES`` x the matmul ``VARIANTS``."""
    return tuple(columns) if columns is not None else tuple(
        pallas_columns(variants=list(MM_VARIANTS)))


def conv_tile_time_batch(configs: np.ndarray,
                         columns: Optional[Sequence[str]] = None,
                         *, noisy: bool = True,
                         time_scale: float = 1.0) -> np.ndarray:
    """(L, 5) conv configs -> (L, P) simulated per-image seconds over tile
    columns. Per base family the layer lowers to:

    * im2col: (k, c·f²) @ (c·f², oh·ow), plus the patch matrix written once;
    * 1x1: (k, c) @ (c, oh·ow);
    * winograd: n² point GEMMs (k, c) @ (c, tiles) plus input and output
      transform traffic (n = tile_m + r − 1, tiles = ⌈oh/m⌉·⌈ow/m⌉).

    NaN where the base primitive is inapplicable."""
    names = _simulated_columns(columns)
    cfg = np.asarray(configs, np.int64)
    if cfg.ndim != 2 or cfg.shape[1] != 5:
        raise ValueError(f"configs must be (L, 5), got {cfg.shape}")
    tr = compile_traits(names)
    ki, ci, imi, si, fi = (cfg[:, j] for j in range(5))
    app = tr.applicable_mask(ki, ci, imi, si, fi)            # (L, P)
    o = (imi - fi) // np.maximum(si, 1) + 1                  # (L,)
    k = ki.astype(np.float64)
    c = ci.astype(np.float64)
    f = fi.astype(np.float64)
    P = o.astype(np.float64) ** 2

    out = np.empty((cfg.shape[0], len(names)), np.float64)
    for j, name in enumerate(names):
        base, variant = split_tile(name)
        bm, bk, bn = _variant_blocks(variant)
        if base.startswith("conv-1x1"):
            t = _analytic_cost_np(k, c, P, bm, bk, bn)
        elif base.startswith("winograd"):
            m = int(tr.tile_m[j]) or 2
            r = 5 if tr.fam[j] == FAMILIES.index("wino5") else 3
            n = m + r - 1
            tiles = np.ceil(o / m) ** 2
            t = (n * n) * _analytic_cost_np(k, c, tiles, bm, bk, bn)
            t = t + 2.0 * 2 * (c + k) * n * n * tiles / _HBM_BW
        else:                                      # im2col lowerings
            t = _analytic_cost_np(k, c * f * f, P, bm, bk, bn)
            t = t + 2.0 * c * f * f * P / _HBM_BW
        out[:, j] = t
    if noisy:
        h = _mix64(tr.key[None, :].astype(np.uint64))
        for fld in (ki, ci, imi, si, fi):
            h = _mix64(h ^ fld.astype(np.uint64)[:, None])
        out *= _lognormal(h, _TILE_SIGMA)
    out *= time_scale
    out[~app] = np.nan
    return out


def _dlt_pairs() -> List[Tuple[str, str]]:
    """The non-identity DLT (src, dst) pairs, in ``layouts.dlt_pairs()`` order."""
    return [(s, d) for (s, d) in L.dlt_pairs() if s != d]


def pallas_dlt_time_batch(pairs: np.ndarray, *, noisy: bool = True,
                          time_scale: float = 1.0) -> np.ndarray:
    """(M, 2) (c, im) pairs -> (M, 6) simulated seconds of the non-identity
    DLTs, priced as permute traffic (a full chw<->hwc transpose streams
    worse than an adjacent swap)."""
    pr = np.asarray(pairs, np.int64)
    if pr.ndim != 2 or pr.shape[1] != 2:
        raise ValueError(f"pairs must be (M, 2), got {pr.shape}")
    ni = _dlt_pairs()
    eff = np.array([0.35 if {s, d} == {"chw", "hwc"} else 0.6 for (s, d) in ni])
    keys = np.array([name_hash64("pallas-dlt|" + L.dlt_name(s, d))
                     for (s, d) in ni], np.uint64)
    c = pr[:, 0].astype(np.float64)
    im = pr[:, 1].astype(np.float64)
    bytes_moved = 2.0 * 4.0 * c * im * im                    # read + write
    out = bytes_moved[:, None] / (_HBM_BW * eff[None, :]) + 2e-6
    if noisy:
        h = _mix64(keys[None, :])
        for fld in (pr[:, 0], pr[:, 1]):
            h = _mix64(h ^ fld.astype(np.uint64)[:, None])
        out *= _lognormal(h, _TILE_SIGMA)
    return out * time_scale


class PallasTileProvider:
    """Cost provider over (primitive, tile) columns priced by the analytic
    surface: the simulated tile platform's ground truth for selection."""

    def __init__(self, columns: Optional[Sequence[str]] = None, *,
                 noisy: bool = True, time_scale: float = 1.0):
        self.columns = list(_simulated_columns(columns))
        self.noisy = noisy
        self.time_scale = time_scale

    def primitive_cost_matrix(self, configs: np.ndarray) -> np.ndarray:
        if len(configs) == 0:
            return np.zeros((0, len(self.columns)))
        return conv_tile_time_batch(configs, self.columns, noisy=self.noisy,
                                    time_scale=self.time_scale)

    def dlt_cost_matrix(self, pairs: np.ndarray) -> np.ndarray:
        if len(pairs) == 0:
            return np.zeros((0, len(_dlt_pairs())))
        return pallas_dlt_time_batch(pairs, noisy=self.noisy,
                                     time_scale=self.time_scale)


def matmul_sites(cfg: ArchConfig, seq: int = 4096, batch_tokens: int = SITE_BATCH_TOKENS,
                 tp: int = SITE_TP) -> List[Tuple[str, int, int, int]]:
    """(name, M, K, N) matmul sites for one layer of ``cfg``, after TP
    sharding by ``tp`` (the per-device GEMM the kernel actually runs)."""
    d, hd = cfg.d_model, cfg.hd
    M = batch_tokens
    sites = []
    if cfg.attn_kind == "gqa":
        sites += [("wq", M, d, max(cfg.n_heads * hd // tp, 128)),
                  ("wk", M, d, max(cfg.n_kv_heads * hd // tp, 128)),
                  ("wo", M, max(cfg.n_heads * hd // tp, 128), d)]
    elif cfg.attn_kind == "mla":
        m = cfg.mla
        sites += [("wdq", M, d, m.q_lora),
                  ("wuq", M, m.q_lora, max(cfg.n_heads * (m.qk_nope + m.qk_rope) // tp, 128)),
                  ("wo", M, max(cfg.n_heads * m.v_head // tp, 128), d)]
    if cfg.moe is not None:
        ff = cfg.moe.d_ff
        tokens_per_expert = int(1.25 * M * cfg.moe.top_k / cfg.moe.n_experts)
        sites += [("expert_up", max(tokens_per_expert, 128), d, ff),
                  ("expert_down", max(tokens_per_expert, 128), ff, d)]
    elif cfg.d_ff:
        sites += [("mlp_up", M, d, max(cfg.d_ff // tp, 128)),
                  ("mlp_down", M, max(cfg.d_ff // tp, 128), d)]
    if cfg.ssm is not None:
        din = cfg.ssm.d_inner(d)
        sites += [("ssm_in", M, d, max((2 * din) // tp, 128)),
                  ("ssm_out", M, max(din // tp, 128), d)]
    return sites


class MeasuredCost:
    """``cost(M, K, N, variant) -> seconds`` of ``matmul_op`` on the card:
    unit-normal operands of ``dtype`` (default bf16, the 2-byte operands the
    reference's surface prices) drawn from ``seed``, the median CUDA-event
    time of ``GEMM_REPEATS`` calls after ``GEMM_WARMUP``. Each (M, K, N,
    variant) is timed once and remembered in ``times``, so the dataset and
    ``autotune_arch`` share their site timings."""

    def __init__(self, device="cuda", seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError("MeasuredCost times the card; pass cost_fn= for "
                             "any other cost source")
        self.seed = seed
        self.dtype = dtype
        self.times: Dict[Tuple[int, int, int, str], float] = {}

    def __call__(self, M: int, K: int, N: int, variant: str) -> float:
        key = (int(M), int(K), int(N), variant)
        if key not in self.times:
            g = torch.Generator(device=self.device).manual_seed(self.seed)
            x = torch.randn(key[0], key[1], generator=g, device=self.device,
                            dtype=self.dtype)
            y = torch.randn(key[1], key[2], generator=g, device=self.device,
                            dtype=self.dtype)
            self.times[key] = time_callable(
                lambda: matmul_op(x, y, variant), repeats=GEMM_REPEATS,
                warmup=GEMM_WARMUP, device=self.device).device
        return self.times[key]


@dataclasses.dataclass
class GemmDataset:
    """(M, K, N) -> seconds under each variant; the first ``n_sites`` rows
    are the LM sites, the rest the sample. ``seconds``: wall time spent in
    the cost source; ``dtype``: the operand dtype the cost source timed
    (its ``dtype`` attribute, as ``MeasuredCost`` has), None where it
    states none."""
    feats: np.ndarray                    # (n, 3) M, K, N
    times: np.ndarray                    # (n, len(names)) seconds
    names: List[str]
    n_sites: int
    seconds: float
    dtype: Optional[torch.dtype] = None

    def split(self, seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(train, val, test) row indices: 80 / 10 / 10 % of a permutation
        drawn from ``seed``, so sites and sample rows land in every part."""
        n = len(self.feats)
        perm = np.random.default_rng(seed).permutation(n)
        a, b = int(0.8 * n), int(0.9 * n)
        return perm[:a], perm[a:b], perm[b:]


def site_shapes(configs: Sequence[ArchConfig], batch_tokens: int = SITE_BATCH_TOKENS,
                tp: int = SITE_TP) -> List[Tuple[int, int, int]]:
    """The distinct (M, K, N) of every config's sites, in first-seen order."""
    out: Dict[Tuple[int, int, int], None] = {}
    for cfg in configs:
        for _, m, k, n in matmul_sites(cfg, batch_tokens=batch_tokens, tp=tp):
            out[(m, k, n)] = None
    return list(out)


def build_dataset(cost_fn: Optional[CostFn] = None, *,
                  configs: Optional[Sequence[ArchConfig]] = None,
                  batch_tokens: int = SITE_BATCH_TOKENS, tp: int = SITE_TP,
                  sample_rows: int = SAMPLE_ROWS,
                  max_flops: float = SAMPLE_MAX_FLOPS,
                  budget_s: float = BUDGET_S, seed: int = 0,
                  device="cuda") -> GemmDataset:
    """The autotune's dataset under the sampling design of the module
    docstring: every distinct site of ``configs`` (default: the ten
    registered configs), then up to ``sample_rows`` seeded log-uniform GEMMs
    of at most ``max_flops``, until ``budget_s`` seconds have gone into the
    cost source. ``cost_fn`` defaults to ``MeasuredCost(device)``."""
    if cost_fn is None:
        cost_fn = MeasuredCost(device, seed)
    if configs is None:
        configs = cb.all_assigned()
    names = list(MM_VARIANTS)
    shapes = site_shapes(configs, batch_tokens, tp)
    n_sites = len(shapes)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    rows = []
    for m, k, n in shapes:
        rows.append([cost_fn(m, k, n, v) for v in names])
    seen = set(shapes)
    while len(rows) - n_sites < sample_rows and time.perf_counter() - t0 < budget_s:
        m = int(2 ** rng.uniform(7, 17))
        k = int(2 ** rng.uniform(7, 15))
        n = int(2 ** rng.uniform(7, 15))
        if 2.0 * m * k * n > max_flops or (m, k, n) in seen:
            continue
        seen.add((m, k, n))
        shapes.append((m, k, n))
        rows.append([cost_fn(m, k, n, v) for v in names])
    return GemmDataset(np.array(shapes, float), np.array(rows, float), names,
                       n_sites, time.perf_counter() - t0,
                       getattr(cost_fn, "dtype", None))


def train_cost_model(data: GemmDataset, *, seed: int = 0, max_iters: int = 4000,
                     device="cuda") -> PerfModel:
    """NN2 over ``data``'s train rows, early-stopped on its val rows
    (``GemmDataset.split``); the test rows stay held out."""
    tr, va, _ = data.split(seed)
    return fit_perf_model("nn2", data.feats[tr], data.times[tr], data.feats[va],
                          data.times[va], columns=data.names,
                          max_iters=max_iters, seed=seed, device=device)


@dataclasses.dataclass
class AutotuneResult:
    assignment: Dict[str, str]           # site -> variant
    predicted_s: float                   # the selected variants' cost
    default_s: float                     # all sites on the first variant
    oracle_s: float                      # the best cost per site

    @property
    def speedup_vs_default(self) -> float:
        return self.default_s / self.predicted_s if self.predicted_s else 1.0


def autotune_arch(cfg: ArchConfig, model: PerfModel, tp: int = SITE_TP,
                  batch_tokens: int = SITE_BATCH_TOKENS,
                  cost_fn: Optional[CostFn] = None, device="cuda") -> AutotuneResult:
    """PBQP-select a kernel variant per matmul site of ``cfg`` from
    ``model``'s predictions (chain graph; variant switches carry no layout
    cost, so edges are zero and the graph reduces to per-site argmins, which
    PBQP handles as R0 reductions). The selection, the all-first-variant
    default and the per-site best are priced by ``cost_fn`` (default:
    ``MeasuredCost(device)``)."""
    if cost_fn is None:
        cost_fn = MeasuredCost(device)
    sites = matmul_sites(cfg, batch_tokens=batch_tokens, tp=tp)
    names = list(model.columns)
    feats = np.array([[m, k, n] for (_, m, k, n) in sites], float)
    pred = model.predict(feats)                      # (n_sites, n_variants)

    g = pbqp.PBQPGraph()
    for i in range(len(sites)):
        g.add_node(i, pred[i], labels=names)
    lab = pbqp.solve(g).labelled(g)

    true = np.array([[cost_fn(m, k, n, v) for v in names] for (_, m, k, n) in sites])
    sel = sum(true[i, names.index(lab[i])] for i in range(len(sites)))
    return AutotuneResult({s[0]: lab[i] for i, s in enumerate(sites)},
                          float(sel), float(true[:, 0].sum()),
                          float(true.min(axis=1).sum()))


def mdrae_held_out(model: PerfModel, data: GemmDataset, seed: int = 0) -> float:
    """``model``'s MdRAE on ``data``'s test rows (``split(seed)``)."""
    te = data.split(seed)[2]
    return model.mdrae(data.feats[te], data.times[te])

