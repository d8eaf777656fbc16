"""Analytic platform simulators for primitive execution time (DESIGN.md §2.1).

The container has one CPU, so the paper's three profiled machines (Intel
i9-9900K, AMD A10-7850K, ARM Cortex-A73) are replaced by parameterised
analytic timing models with realistic *structure*:

  * compute term: GEMM-shaped work runs at ``peak * eff(M, N, K)`` where the
    efficiency saturates in each dimension (small-dim penalties) and depends
    on SIMD width utilisation (``-vec-N`` variants);
  * memory term: ``bytes / bw(working_set)`` with a cache-hierarchy bandwidth
    staircase (L1/L2/L3/DRAM cliffs at platform-specific sizes);
  * family-specific work models: im2col pays lowering traffic, kn2 computes
    on the full image and pays accumulate traffic, Winograd pays transform
    FLOPs + tile-quantisation waste, MEC keeps a small working set but pays
    partitioned-GEMM overheads, direct has no lowering but poor compute
    efficiency;
  * per-call overhead and deterministic multiplicative lognormal noise
    (σ: intel 2.5%, amd 3%, arm 6% — the paper's observed MdRAE floors).

Crucially, platforms are *correlated but not proportional* in log-time:
cache-cliff positions, SIMD widths and GEMM efficiencies differ, so a model
trained on one platform transfers imperfectly — a constant per-primitive
factor helps (paper's "Factor Intel") but fine-tuning is required to close
the gap. This is the structure the paper's transfer study measures.

Batched estimation (DESIGN.md §2.4): ``primitive_time_batch`` and
``dlt_time_batch`` evaluate the family models for *all* configs × *all*
registry columns in one numpy broadcast pass, with the registry traits
pre-compiled into per-column arrays (``primitives.conv.compile_traits``).
The lognormal noise is a counter-based hash stream (splitmix64 finaliser over
the integer key fields) rather than a per-call sha256, so a whole noise
matrix is one vectorised evaluation.

This is the port's own copy of ``repro.profiler.simulators``: the platform
constants, the batched family models and the noise stream (uint64
wraparound under ``np.errstate``) are the reference's line for line, so
both packages produce the same matrices bit for bit. Only the batched API
is carried over; the reference's scalar API and its pre-vectorisation
oracle are not.

Times are in seconds.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.primitives import layouts as L
from repro_torch.primitives.conv import (FAMILIES, PRIMITIVE_NAMES, T_VARIANTS,
                                         compile_traits, name_hash64)


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    clock_ghz: float
    vec_width: int          # fp32 lanes
    fma_ports: int
    gemm_eff: float         # best-case fraction of peak for large GEMM
    l1_kb: float
    l2_kb: float
    l3_kb: float            # 0 => no L3
    bw_l1: float            # GB/s
    bw_l2: float
    bw_l3: float
    bw_dram: float
    overhead_us: float      # per primitive call
    noise_sigma: float
    # efficiency saturation constants (smaller = less small-dim penalty)
    sat_m: float
    sat_n: float
    sat_k: float
    transpose_eff: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def peak_gflops(self) -> float:
        return self.clock_ghz * self.vec_width * self.fma_ports * 2.0


INTEL = Platform(
    name="intel", clock_ghz=5.0, vec_width=8, fma_ports=2, gemm_eff=0.88,
    l1_kb=32, l2_kb=256, l3_kb=16384, bw_l1=400, bw_l2=180, bw_l3=90,
    bw_dram=38, overhead_us=1.5, noise_sigma=0.025,
    sat_m=10, sat_n=28, sat_k=22,
    transpose_eff={"adjacent": 0.62, "full": 0.38})

AMD = Platform(
    name="amd", clock_ghz=3.7, vec_width=8, fma_ports=1, gemm_eff=0.74,
    l1_kb=16, l2_kb=2048, l3_kb=0, bw_l1=220, bw_l2=80, bw_l3=0,
    bw_dram=18, overhead_us=2.8, noise_sigma=0.030,
    sat_m=14, sat_n=40, sat_k=30,
    transpose_eff={"adjacent": 0.5, "full": 0.3})

ARM = Platform(
    name="arm", clock_ghz=2.36, vec_width=4, fma_ports=1, gemm_eff=0.62,
    l1_kb=32, l2_kb=1024, l3_kb=0, bw_l1=90, bw_l2=35, bw_l3=0,
    bw_dram=7.5, overhead_us=6.0, noise_sigma=0.060,
    sat_m=18, sat_n=64, sat_k=44,
    transpose_eff={"adjacent": 0.42, "full": 0.22})

PLATFORMS: Dict[str, Platform] = {"intel": INTEL, "amd": AMD, "arm": ARM}


# ---------------------------------------------------------------------------
# Building blocks (broadcasting — accept scalars or arrays)
# ---------------------------------------------------------------------------

def _bw(plat: Platform, working_set_bytes) -> np.ndarray:
    """Cache staircase, GB/s (smoothed cliffs)."""
    kb = working_set_bytes / 1024.0
    levels = [(plat.l1_kb, plat.bw_l1), (plat.l2_kb, plat.bw_l2)]
    if plat.l3_kb:
        levels.append((plat.l3_kb, plat.bw_l3))
    bw = plat.bw_dram
    for size, level_bw in reversed(levels):
        # logistic blend around each cliff
        frac = 1.0 / (1.0 + np.exp(4.0 * (np.log(kb + 1e-9) - math.log(size))))
        bw = bw + frac * (level_bw - bw)
    return bw


def _gemm_time(plat: Platform, M, N, K, vec, trans_penalty=1.0) -> np.ndarray:
    """Seconds for a (M,K)x(K,N) fp32 GEMM on this platform.

    ``vec`` is a per-column float array of explicit SIMD widths with 0.0
    meaning "unspecified" (no adjustment); ``trans_penalty`` broadcasts the
    same way. Operation order mirrors the original scalar model exactly.
    """
    flops = 2.0 * M * N * K
    eff = (plat.gemm_eff
           * M / (M + plat.sat_m)
           * N / (N + plat.sat_n)
           * K / (K + plat.sat_k))
    # SIMD-width variants: perfect fit gives a bonus, overwide ops are
    # emulated (severe), narrow explicit vec under-uses wide units (mild).
    vec = np.asarray(vec, np.float64)
    safe = np.where(vec == 0.0, 1.0, vec)
    factor = np.where(vec == 0.0, 1.0,
                      np.where(vec > plat.vec_width,
                               0.30 * plat.vec_width / safe,
                               np.where(vec == plat.vec_width, 1.12,
                                        0.72 + 0.28 * vec / plat.vec_width)))
    eff = eff * factor
    eff = eff / trans_penalty
    t_compute = flops / (plat.peak_gflops * 1e9 * np.maximum(eff, 1e-3))
    ws = 4.0 * (M * K + K * N + M * N)
    t_mem = ws / (_bw(plat, ws) * 1e9)
    return np.maximum(t_compute, t_mem)


def _stream_time(plat: Platform, bytes_moved, footprint, eff=1.0) -> np.ndarray:
    return bytes_moved / (_bw(plat, footprint) * 1e9 * eff)


# ---------------------------------------------------------------------------
# Counter-based noise stream (splitmix64 finaliser over integer key fields)
# ---------------------------------------------------------------------------

_MASK52 = (1 << 52) - 1
_MIX_A = 0xBF58476D1CE4E5B9
_MIX_B = 0x94D049BB133111EB


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finaliser on uint64 arrays."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(_MIX_A)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(_MIX_B)
    return x ^ (x >> np.uint64(31))


@lru_cache(maxsize=64)
def _plat_key(name: str) -> int:
    return name_hash64("plat|" + name)


def _lognormal(h: np.ndarray, sigma: float) -> np.ndarray:
    """Lognormal factors exp(sigma * z), z standard normal drawn from the
    hashes ``h`` (Box-Muller over two 52-bit fields)."""
    u = (h & np.uint64(_MASK52)).astype(np.float64) / float(1 << 52)
    v = ((h >> np.uint64(8)) & np.uint64(_MASK52)).astype(np.float64) / float(1 << 52)
    z = np.sqrt(-2.0 * np.log(np.maximum(u, 1e-12))) * np.cos(2 * np.pi * v)
    return np.exp(sigma * z)


def _noise_matrix(plat: Platform, col_keys: np.ndarray, *fields) -> np.ndarray:
    """(L, P) lognormal noise: one hash stream per (column, field-tuple)."""
    h = _mix64(np.uint64(_plat_key(plat.name)) ^ col_keys.astype(np.uint64)[None, :])
    for f in fields:
        h = _mix64(h ^ np.asarray(f, np.uint64)[:, None])
    return _lognormal(h, plat.noise_sigma)


_TRANS_PENALTY = {None: 1.0, "atb": 1.06, "abt": 1.06, "atbt": 1.16}

# transpose penalty per T_VARIANTS code, for vectorised lookup
_TRANS_TABLE = np.array([_TRANS_PENALTY[v] for v in T_VARIANTS], np.float64)

_DLT_PAIRS_NI: Tuple[Tuple[str, str], ...] = tuple(
    (s, d) for (s, d) in L.dlt_pairs() if s != d)
_DLT_FULL = np.array([{s, d} == {"chw", "hwc"} for (s, d) in _DLT_PAIRS_NI])
_DLT_KEYS = np.array([name_hash64("dlt|" + L.dlt_name(s, d))
                      for (s, d) in _DLT_PAIRS_NI], np.uint64)


# ---------------------------------------------------------------------------
# Batched per-family time models
# ---------------------------------------------------------------------------

def primitive_time_batch(plat: Platform, configs: np.ndarray,
                         noisy: bool = True,
                         columns: Optional[Sequence[str]] = None) -> np.ndarray:
    """Simulated execution times for every (config, registry column) pair.

    ``configs`` is (L, 5) integer rows (k, c, im, s, f); returns an (L, P)
    float matrix in ``columns`` order (default: the full registry), NaN where
    a primitive is inapplicable. One broadcast pass over the family models —
    no Python loop over layers or primitives.
    """
    cfg = np.asarray(configs)
    if cfg.ndim != 2 or cfg.shape[1] != 5:
        raise ValueError(f"configs must be (L, 5), got {cfg.shape}")
    names = tuple(columns) if columns is not None else tuple(PRIMITIVE_NAMES)
    tr = compile_traits(names)
    cfg = cfg.astype(np.int64)
    ki, ci, imi, si, fi = (cfg[:, j] for j in range(5))
    app = tr.applicable_mask(ki, ci, imi, si, fi)            # (L, P)

    k, c, im, s, f = (a.astype(np.float64)[:, None] for a in (ki, ci, imi, si, fi))
    o_int = ((imi - fi) // si + 1)[:, None]                  # (L, 1) int
    o = o_int.astype(np.float64)
    P = o * o
    in_bytes = 4.0 * c * im * im
    w_bytes = 4.0 * k * c * f * f
    out_bytes = 4.0 * k * P
    base = plat.overhead_us * 1e-6

    out = np.empty((cfg.shape[0], len(names)), np.float64)
    fam = tr.fam
    with np.errstate(all="ignore"):
        cols = np.nonzero(fam == FAMILIES.index("direct"))[0]
        if cols.size:
            # no lowering; poor compute efficiency (no blocking), input
            # re-read f*f times when it does not fit cache.
            flops = 2.0 * k * c * f * f * P
            eff = 0.22 * (plat.vec_width / 8.0) ** 0.25
            t_cmp = flops / (plat.peak_gflops * 1e9 * eff)
            reread = np.where(in_bytes > plat.l2_kb * 1024, f * f, 1.0)
            t_mem = _stream_time(plat, in_bytes * reread + w_bytes + out_bytes,
                                 in_bytes)
            out[:, cols] = base + np.maximum(t_cmp, t_mem)

        cols = np.nonzero(fam == FAMILIES.index("im2"))[0]
        if cols.size:
            vec = tr.vec[cols]
            trans = _TRANS_TABLE[tr.t_idx[cols]]
            lower_bytes = 4.0 * c * f * f * P
            # copy materialises the patch matrix (write+read), scan gathers
            # with poorer locality but half the traffic.
            t_scan = _stream_time(plat, lower_bytes, in_bytes, eff=0.45)
            t_copy = _stream_time(plat, 2.0 * lower_bytes, lower_bytes, eff=0.85)
            t_lower = np.where(tr.scan[cols][None, :], t_scan, t_copy)
            t_g = _gemm_time(plat, k, P, c * f * f, vec, trans)
            # ki (chw) output from pixel-major GEMM pays a strided-write factor
            eff_out = np.where(tr.order_ki[cols], 0.8, 1.0)[None, :]
            t_out = _stream_time(plat, out_bytes, out_bytes, eff=eff_out)
            out[:, cols] = base + t_lower + t_g + t_out

        cols = np.nonzero(fam == FAMILIES.index("kn2"))[0]
        if cols.size:
            vec = tr.vec[cols]
            trans = _TRANS_TABLE[tr.t_idx[cols]]
            # f*f GEMMs over the FULL image + shifted accumulation traffic.
            t_g = f * f * _gemm_time(plat, k, im * im, c, vec, trans)
            acc_bytes = 4.0 * k * P * f * f * 2.0
            t_acc = _stream_time(plat, acc_bytes, 4.0 * k * im * im, eff=0.7)
            # "-as" variants: single fused reduction
            t_acc = t_acc * np.where(tr.variant_as[cols], 0.8, 1.0)[None, :]
            out[:, cols] = base + t_g + t_acc

        cols = np.nonzero((fam == FAMILIES.index("wino3"))
                          | (fam == FAMILIES.index("wino5")))[0]
        if cols.size:
            vec = tr.vec[cols]
            m = tr.tile_m[cols][None, :]                     # (1, W) int
            r = fi[:, None]                                  # (L, 1) int
            n = m + r - 1                                    # (L, W) int
            oned = tr.oned[cols][None, :]
            # 1-D: rows x row-tiles; 2-D: tile quantisation waste
            tiles1 = o_int * (-(-o_int // m))
            th = -(-o_int // m)
            tiles2 = th * th
            tiles = np.where(oned, tiles1, tiles2)
            tr_flops = np.where(
                oned,
                2.0 * (c + k) * tiles1 * n * n + 2.0 * k * tiles1 * m * n,
                (2.0 * c * tiles2 * 2 * n * n * n        # input transform
                 + 2.0 * k * c * 2 * n * n * r           # kernel transform
                 + 2.0 * k * tiles2 * 2 * n * n * m))    # output transform
            gemms1 = r * n                                # r kernel-rows x n points
            t_g = np.where(
                oned,
                gemms1 * _gemm_time(plat, k, tiles1 / np.maximum(1, n), c, vec),
                n * n * _gemm_time(plat, k, tiles2, c, vec))
            t_tr = tr_flops / (plat.peak_gflops * 1e9 * 0.35)
            t_mem = _stream_time(plat, in_bytes + out_bytes + 4.0 * c * tiles * n * n,
                                 4.0 * c * tiles * n * n, eff=0.8)
            out[:, cols] = base + t_g + t_tr + t_mem

        cols = np.nonzero(fam == FAMILIES.index("c1x1"))[0]
        if cols.size:
            vec = tr.vec[cols]
            trans = _TRANS_TABLE[tr.t_idx[cols]]
            t_g = _gemm_time(plat, k, P, c, vec, trans)
            strided = np.where(s == 1.0, 1.0, 0.6)
            t_mem = _stream_time(plat, in_bytes / (s * s) + out_bytes, in_bytes,
                                 eff=strided)
            out[:, cols] = base + t_g + t_mem

        cols = np.nonzero(fam == FAMILIES.index("mec"))[0]
        if cols.size:
            vec = tr.vec[cols]
            # partial lowering: ow strips of (h x f) columns; f partitioned
            # GEMMs, each seeing a smaller K (worse efficiency) and a small
            # per-partition call overhead — MEC trades time for memory.
            lower_bytes = 4.0 * c * im * f * o
            t_lower = _stream_time(plat, 2.0 * lower_bytes, lower_bytes, eff=0.8)
            t_g = f * _gemm_time(plat, k, P, c * f, vec)
            t_part = f * plat.overhead_us * 0.3e-6
            out[:, cols] = base + t_lower + t_g + t_part

        if noisy:
            out = out * _noise_matrix(plat, tr.key, ki, ci, imi, si, fi)
    out[~app] = np.nan
    return out


def dlt_time_batch(plat: Platform, pairs: np.ndarray,
                   noisy: bool = True) -> np.ndarray:
    """Simulated DLT times for every ((c, im) pair, non-identity layout pair).

    ``pairs`` is (M, 2) integer rows (c, im); returns (M, 6) in
    ``layouts.dlt_pairs()`` order with identity pairs excluded.
    """
    pr = np.asarray(pairs)
    if pr.ndim != 2 or pr.shape[1] != 2:
        raise ValueError(f"pairs must be (M, 2), got {pr.shape}")
    pr = pr.astype(np.int64)
    ci, imi = pr[:, 0], pr[:, 1]
    c, im = (a.astype(np.float64)[:, None] for a in (ci, imi))
    bytes_moved = 2.0 * 4.0 * c * im * im
    # chw<->hwc moves the innermost axis (worst); others swap adjacent axes.
    eff = np.where(_DLT_FULL, plat.transpose_eff["full"],
                   plat.transpose_eff["adjacent"])[None, :]
    tm = plat.overhead_us * 0.5e-6 + _stream_time(plat, bytes_moved,
                                                  bytes_moved / 2, eff=eff)
    if noisy:
        tm = tm * _noise_matrix(plat, _DLT_KEYS, ci, imi)
    return tm
