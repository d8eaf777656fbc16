"""Caps torch's intra-op threads at this process's share of the cores when
pytest-xdist runs several workers (``PYTEST_XDIST_WORKER_COUNT``).

Each worker's torch otherwise starts one OpenMP thread per core, so six
workers on eight cores run 48 threads whose parallel regions wait on each
other, and the small-MLP fits of ``test_torch_training.py`` slow by an
order of magnitude. Every ``tests/test_torch_*.py`` imports this module
first; one process run (no xdist) keeps torch's default.
"""
import os

import torch


_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
