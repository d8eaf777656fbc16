"""Measured profiler on the GPU — the port of ``repro.profiler.host``
(paper §4.1 methodology: warmed up, median of repeats, normally distributed
input data), timing the primitives and the data-layout transformations on
an explicit device.

A column is a base primitive or a tile column ``<base>@<variant>``. A tile
column runs ``variants.conv_variant_call``, the call a compiled plan makes,
so profiling it launches the hand-written matmul, implicit-GEMM conv and
Winograd kernels. NaN means "inapplicable" and nothing else; any other
failure (a kernel that refuses a shape, memory running out) raises.

Each entry is the reference's quantity: the median over ``repeats`` of the
wall time from the call to a sync of the calling thread's current stream
(all of the call's work, none of another thread's stream), after ``warmup``
calls (which also absorb a kernel library's first load and its launch-plan
host work). The served paths are host-bound (the card idles most of an
unprofiled burst), so wall time is the cost that binds; device time alone
would rank primitives by the part that does not. Beside it, every
measurement records the median CUDA-event time of the same calls
(``Timing.device``): NaN on the CPU, where there is no device clock. The
two events bracket the call on the stream, so that time also counts the
gaps in which the device waits for the host to enqueue the call's next
launch; for a host-bound call it approaches the wall time. Kernel time
alone needs a trace or a replayed graph (``chip_smoke.py`` does both).

Inputs follow ``host.py``: ``standard_normal`` draws from one
``np.random.default_rng(0)`` per batch, the image laid out by
``layouts.from_chw`` and made contiguous in that layout, as the reference's
materialised array is. A DLT is timed as the permutation made contiguous:
the copy a consumer needing its layout pays (a torch permutation alone is a
view and costs nothing on the device).

The device defaults to ``cuda``; ``device="cpu"`` is for the tests.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.primitives import layouts as L
from repro_torch.primitives.conv import RUNNABLE, REGISTRY, split_tile
from repro_torch.primitives.variants import conv_variant_call
from repro_torch.profiler.dataset import PerfDataset


class Timing(NamedTuple):
    """A measurement in seconds: ``wall`` (host clock, call to sync) and
    ``device`` (CUDA events around the same call; NaN on the CPU). Fields
    are floats, arrays or datasets alike."""
    wall: Any
    device: Any


_NAN = Timing(float("nan"), float("nan"))


def platform_label(device) -> str:
    """The ``PerfDataset.platform`` of a measurement on ``device``."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def time_callable(fn: Callable, *args, repeats: int = 25, warmup: int = 2,
                  device="cuda") -> Timing:
    """Median wall time of ``fn(*args)`` up to a sync of the current
    stream, and median CUDA-event time of the same calls (paper: 25
    repeats, the median)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync() -> None:
        # the calling thread's stream only: a serving worker's probe must
        # not wait for what another worker's stream has in flight
        if cuda:
            torch.cuda.current_stream(dev).synchronize()

    for _ in range(warmup):
        fn(*args)
        sync()
    walls, devs = [], []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn(*args)
        if cuda:
            end.record()
        sync()
        walls.append(time.perf_counter() - t0)
        if cuda:
            devs.append(start.elapsed_time(end) * 1e-3)
    return Timing(float(np.median(walls)),
                  float(np.median(devs)) if cuda else float("nan"))


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(device)


def column_callable(name: str, stride: int) -> Callable:
    """``(x, w) -> y`` of column ``name``: the base impl, or the tile
    variant's kernel route (``conv_variant_call``)."""
    base, variant = split_tile(name)
    p = REGISTRY[base]
    if variant is None:
        return lambda x, w: p.impl(x, w, stride)
    return lambda x, w: conv_variant_call(p, variant, x, w, stride)


def applicable(name: str, k: int, c: int, im: int, s: int, f: int) -> bool:
    p = REGISTRY[split_tile(name)[0]]
    return p.impl is not None and p.applicable(k, c, im, s, f)


def profile_primitive(name: str, k: int, c: int, im: int, s: int, f: int,
                      repeats: int = 25, rng: Optional[np.random.Generator] = None,
                      device="cuda") -> Timing:
    """Measured runtime (seconds) of column ``name``; NaN if inapplicable
    or simulated-only."""
    if not applicable(name, k, c, im, s, f):
        return _NAN
    rng = rng or np.random.default_rng(0)
    p = REGISTRY[split_tile(name)[0]]
    x_chw = _upload(rng.standard_normal((c, im, im)), device)
    x = L.from_chw(x_chw, p.in_layout).contiguous()
    w = _upload(rng.standard_normal((k, c, f, f)), device)
    return time_callable(column_callable(name, s), x, w, repeats=repeats,
                         device=device)


def profile_dlt(src: str, dst: str, c: int, im: int, repeats: int = 25,
                device="cuda") -> Timing:
    if src == dst:
        return Timing(0.0, 0.0)
    rng = np.random.default_rng(0)
    x = L.from_chw(_upload(rng.standard_normal((c, im, im)), device), src).contiguous()
    return time_callable(lambda t: L.transform(t, src, dst).contiguous(), x,
                         repeats=repeats, device=device)


def profile_primitive_batch(configs: Sequence[Tuple[int, int, int, int, int]],
                            columns: Optional[Sequence[str]] = None,
                            repeats: int = 25, device="cuda") -> Timing:
    """(L, P) measured runtimes over ``configs`` × ``columns`` (wall and
    device matrices) — the simulator's ``primitive_time_batch`` contract.
    One input RNG is shared across the batch, as in the reference."""
    cols = list(columns) if columns is not None else list(RUNNABLE)
    wall = np.full((len(configs), len(cols)), np.nan)
    dev = np.full_like(wall, np.nan)
    rng = np.random.default_rng(0)
    for i, (k, c, im, s, f) in enumerate(np.asarray(configs, int).reshape(-1, 5)):
        for j, name in enumerate(cols):
            wall[i, j], dev[i, j] = profile_primitive(
                name, int(k), int(c), int(im), int(s), int(f),
                repeats=repeats, rng=rng, device=device)
    return Timing(wall, dev)


def dlt_columns() -> list:
    """The six non-identity DLT columns, in ``layouts.dlt_pairs()`` order."""
    return [L.dlt_name(s, d) for (s, d) in L.dlt_pairs() if s != d]


def profile_dlt_batch(pairs: Sequence[Tuple[int, int]], repeats: int = 25,
                      device="cuda") -> Timing:
    """(M, 6) measured DLT runtimes in ``layouts.dlt_pairs()`` order with
    identity pairs excluded."""
    ni = [(s, d) for (s, d) in L.dlt_pairs() if s != d]
    wall = np.zeros((len(pairs), len(ni)))
    dev = np.zeros_like(wall)
    for i, (c, im) in enumerate(np.asarray(pairs, int).reshape(-1, 2)):
        for j, (s, d) in enumerate(ni):
            wall[i, j], dev[i, j] = profile_dlt(s, d, int(c), int(im),
                                                repeats=repeats, device=device)
    return Timing(wall, dev)


def profile_primitive_dataset(configs: Sequence[Tuple[int, int, int, int, int]],
                              primitives: Optional[Sequence[str]] = None,
                              repeats: int = 9, device="cuda") -> Timing:
    """Profile ``configs`` x ``primitives`` on ``device``: a ``Timing`` of
    two ``PerfDataset``s, wall (the dataset the models train on) and
    device. This is the expensive stage the paper replaces."""
    prims = list(primitives) if primitives is not None else list(RUNNABLE)
    feats = np.array(configs, np.float64).reshape(-1, 5)
    t = profile_primitive_batch(configs, prims, repeats=repeats, device=device)
    names, label = ["k", "c", "im", "s", "f"], platform_label(device)
    return Timing(*(PerfDataset(feats, m, prims, names, label) for m in t))


def profile_dlt_dataset(pairs: Sequence[Tuple[int, int]], repeats: int = 9,
                        device="cuda") -> Timing:
    feats = np.array(pairs, np.float64).reshape(-1, 2)
    t = profile_dlt_batch(pairs, repeats=repeats, device=device)
    label = platform_label(device)
    return Timing(*(PerfDataset(feats, m, dlt_columns(), ["c", "im"], label)
                    for m in t))
