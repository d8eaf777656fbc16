"""Concurrent serving core on one device (DESIGN.md §8, §12): per-network
queues with timed batch windows, a worker pool with one CUDA stream per
worker, drift-triggered recalibration with canary hot-swap, fault
injection, fallback and circuit breakers, cross-backend routing, and the
process front end (intake processes assembling batches in shared-memory
slabs).

    from repro_torch.service.serving import OptimisedServer, make_recalibrator

    server = OptimisedServer(workers=2, max_wait_ms=5.0,
                             recalibrate=make_recalibrator(store=store))
    server.register(opt)
    ticket = server.submit(opt.net, image)
    ticket.wait()

The names load lazily (PEP 562): the front end's intake processes import
``serving.frontend`` and ``serving.queues`` only, and must not load torch.
"""
import importlib

_EXPORTS = {
    "DriftMonitor": "drift", "DriftStats": "drift", "LayerProfile": "drift",
    "ServedObservation": "drift",
    "Fault": "faults", "FaultError": "faults", "FaultInjector": "faults",
    "ProcessFrontend": "frontend", "SlabHandle": "frontend",
    "SlabPool": "frontend",
    "CircuitBreaker": "health", "CorruptOutput": "health",
    "BatchGroup": "queues", "NetQueue": "queues", "Ticket": "queues",
    "OptimisedServer": "server", "layer_profile": "server", "main": "server",
    "make_recalibrator": "server",
    "WorkerPool": "workers",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
