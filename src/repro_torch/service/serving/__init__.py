"""Concurrent serving core on one device (DESIGN.md §8): per-network queues
with timed batch windows, a worker pool with one CUDA stream per worker,
drift-triggered recalibration with canary hot-swap, fault injection,
fallback and circuit breakers, and cross-backend routing. The process front
end is not ported yet.

    from repro_torch.service.serving import OptimisedServer, make_recalibrator

    server = OptimisedServer(workers=2, max_wait_ms=5.0,
                             recalibrate=make_recalibrator(store=store))
    server.register(opt)
    ticket = server.submit(opt.net, image)
    ticket.wait()
"""
from repro_torch.service.serving.drift import (DriftMonitor, DriftStats,
                                               LayerProfile, ServedObservation)
from repro_torch.service.serving.faults import Fault, FaultError, FaultInjector
from repro_torch.service.serving.health import CircuitBreaker, CorruptOutput
from repro_torch.service.serving.queues import NetQueue, Ticket
from repro_torch.service.serving.server import (OptimisedServer,
                                                layer_profile, main,
                                                make_recalibrator)
from repro_torch.service.serving.workers import WorkerPool

__all__ = [
    "CircuitBreaker", "CorruptOutput", "DriftMonitor", "DriftStats", "Fault",
    "FaultError", "FaultInjector", "LayerProfile", "NetQueue",
    "OptimisedServer", "ServedObservation", "Ticket",
    "WorkerPool", "layer_profile", "main", "make_recalibrator",
]
