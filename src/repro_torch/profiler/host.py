"""Measured profiler on this machine's CPU — the port of
``repro.profiler.host`` (paper §4.1 methodology: warmed up, median of
repeats, normally distributed input data), with the reference's API.

A thin layer over ``profiler/device.py`` at ``device="cpu"``: the same
timing loop, inputs and NaN rule, returning the wall medians (there is no
device clock on the CPU). Columns are base primitives only: on the CPU a
tile column ``<base>@<variant>`` runs its base's plain version, so timing
it would time one op under many names (``ValueError``).

Used by ``service.platforms.HostPlatform``: the paper's own setting, a
real CPU profiled at reduced scale.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.primitives.conv import RUNNABLE, split_tile
from repro_torch.profiler import device as D
from repro_torch.profiler.dataset import PerfDataset

CPU = "cpu"
LABEL = "host-cpu"                  # the reference's PerfDataset.platform


def base_columns(columns: Optional[Sequence[str]]) -> List[str]:
    """``columns`` (default: the 21 runnable primitives), refusing tile
    columns."""
    cols = list(columns) if columns is not None else list(RUNNABLE)
    tiles = [c for c in cols if split_tile(c)[1] is not None]
    if tiles:
        raise ValueError(f"cannot profile tile columns {tiles} on the CPU: a "
                         f"tile column runs its base primitive's plain "
                         f"version there")
    return cols


def time_callable(fn: Callable, *args, repeats: int = 25, warmup: int = 2) -> float:
    """Median wall time of ``fn(*args)`` (paper: 25 repeats, the median)."""
    return D.time_callable(fn, *args, repeats=repeats, warmup=warmup,
                           device=CPU).wall


def profile_primitive(name: str, k: int, c: int, im: int, s: int, f: int,
                      repeats: int = 25,
                      rng: Optional[np.random.Generator] = None) -> float:
    """Measured seconds; NaN if inapplicable or simulated-only."""
    base_columns([name])
    return D.profile_primitive(name, k, c, im, s, f, repeats=repeats, rng=rng,
                               device=CPU).wall


def profile_dlt(src: str, dst: str, c: int, im: int, repeats: int = 25) -> float:
    return D.profile_dlt(src, dst, c, im, repeats=repeats, device=CPU).wall


def profile_primitive_batch(configs: Sequence[Tuple[int, int, int, int, int]],
                            columns: Optional[Sequence[str]] = None,
                            repeats: int = 25) -> np.ndarray:
    """(L, P) measured seconds over ``configs`` × ``columns``."""
    return D.profile_primitive_batch(configs, base_columns(columns),
                                     repeats=repeats, device=CPU).wall


def profile_dlt_batch(pairs: Sequence[Tuple[int, int]],
                      repeats: int = 25) -> np.ndarray:
    """(M, 6) measured DLT seconds in ``layouts.dlt_pairs()`` order, identity
    pairs excluded."""
    return D.profile_dlt_batch(pairs, repeats=repeats, device=CPU).wall


def profile_primitive_dataset(configs: Sequence[Tuple[int, int, int, int, int]],
                              primitives: Optional[Sequence[str]] = None,
                              repeats: int = 9) -> PerfDataset:
    """Profile ``configs`` x ``primitives`` on this host: the expensive
    stage the paper replaces, kept small."""
    ds = D.profile_primitive_dataset(configs, base_columns(primitives),
                                     repeats=repeats, device=CPU).wall
    return dataclasses.replace(ds, platform=LABEL)


def profile_dlt_dataset(pairs: Sequence[Tuple[int, int]],
                        repeats: int = 9) -> PerfDataset:
    ds = D.profile_dlt_dataset(pairs, repeats=repeats, device=CPU).wall
    return dataclasses.replace(ds, platform=LABEL)
