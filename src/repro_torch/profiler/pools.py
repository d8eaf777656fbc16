"""Layer-configuration pools (paper §3.2.1, Tables 1/2/7).

The paper collects 475 unique (c, k, im) triplets from a pool of common
architectures, crosses them with the (f, s) grid from Table 1 and filters
impossible combinations (f > im). We build the triplet pool from our CNN zoo
plus the paper's explicit parameter ranges. The port's own copy of
``repro.profiler.pools``, over the port's copy of the zoo, so both packages
build the same pools.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

from repro_torch.models import cnn_zoo

# Table 1 common ranges
F_VALUES = (1, 3, 5, 7, 9, 11)
S_VALUES = (1, 2, 4)


def triplet_pool() -> List[Tuple[int, int, int]]:
    """(c, k, im) triplets as they occur in the zoo (Table 7 analogue)."""
    return cnn_zoo.pool_triplets()


def config_pool(max_triplets: int | None = None,
                f_values: Sequence[int] = F_VALUES,
                s_values: Sequence[int] = S_VALUES) -> List[Tuple[int, int, int, int, int]]:
    """(k, c, im, s, f) layer configurations: triplets x (f, s) grid with
    impossible values filtered (paper §3.2.1)."""
    trips = triplet_pool()
    if max_triplets is not None:
        trips = trips[:: max(1, len(trips) // max_triplets)][:max_triplets]
    out = []
    for (c, k, im) in trips:
        for f, s in itertools.product(f_values, s_values):
            if f > im:
                continue
            out.append((k, c, im, s, f))
    return out


def dlt_pool(max_pairs: int | None = None) -> List[Tuple[int, int]]:
    """(c, im) pairs for the DLT dataset — both layer inputs and outputs
    occur as transformed tensors."""
    pairs = set()
    for (c, k, im) in triplet_pool():
        pairs.add((c, im))
        pairs.add((k, im))
    pairs = sorted(pairs)
    if max_pairs is not None:
        pairs = pairs[:: max(1, len(pairs) // max_pairs)][:max_pairs]
    return pairs
