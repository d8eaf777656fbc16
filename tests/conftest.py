"""Shared fixtures. NOTE: no XLA_FLAGS device forcing here — smoke tests and
benches must see 1 device (the dry-run sets its own count in-process).
Distribution tests that need a host mesh spawn subprocesses."""
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one (run on the "
                   "card with `-m gpu`)")


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    """Surface hypothesis-stub skips as their own summary line: a local run
    without the real engine must say how many property tests it silently
    skipped, so local green != property-tested (README "Tests")."""
    import sys
    stub = sys.modules.get("hypothesis_stub")
    if stub is None or not getattr(stub, "STUBBED", None):
        return
    names = sorted(set(stub.STUBBED))
    terminalreporter.write_sep(
        "-", f"hypothesis stubbed: {len(names)} property test(s) skipped, "
             f"NOT run — install hypothesis for the real engine")
