"""The serving CLI and its documented entry points — the port of
``repro.service.server``:

    python -m repro_torch.service.server --net edge_cnn --platform arm \
        --workers 2 --store <copy of artifacts/>
    python -m repro_torch.service.server ... --device cpu   # no card
    from repro_torch.service.server import OptimisedServer, Ticket
"""
from repro_torch.service.serving.drift import DriftMonitor, DriftStats
from repro_torch.service.serving.queues import NetQueue, Ticket
from repro_torch.service.serving.server import (OptimisedServer, main,
                                                make_recalibrator)
from repro_torch.service.serving.workers import WorkerPool

__all__ = [
    "DriftMonitor", "DriftStats", "NetQueue", "OptimisedServer", "Ticket",
    "WorkerPool", "main", "make_recalibrator",
]

if __name__ == "__main__":
    raise SystemExit(main())
