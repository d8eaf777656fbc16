"""Service layer of the port: platform abstraction (the simulated platforms
and the measured GPU), artifact store, the profile → model → select
pipeline and the concurrent serving core.

    from repro_torch.service import ArtifactStore, OptimisedServer, optimise

    store = ArtifactStore("artifacts-copy")          # models load onto cuda
    opt = optimise("edge_cnn", "arm", store=store, max_triplets=60,
                   max_iters=2000, executable=True)
    server = OptimisedServer(workers=2, max_wait_ms=5.0,
                             recalibrate=make_recalibrator(store=store))
    server.register(opt)

    # the paper's transfer: a simulated platform's model onto the card
    intel = get_platform("intel").pretrain(store=store, max_iters=2000)
    gpu = GpuPlatform(configs=..., dlt_pairs=..., store=store)
    opt = optimise("edge_cnn", gpu, base=intel, budget=28, mode="finetune",
                   store=store, executable=True)
"""
from repro_torch.service.artifacts import ArtifactStore, digest
from repro_torch.service.pipeline import (OptimisedNetwork, optimise,
                                          reoptimise, safe_assignment)
from repro_torch.service.platforms import (GpuPlatform, Platform,
                                           PlatformModels, SimulatedPlatform,
                                           device_machine_id, get_platform)
from repro_torch.service.serving import (CircuitBreaker, CorruptOutput,
                                         DriftMonitor, DriftStats, Fault,
                                         FaultError, FaultInjector,
                                         LayerProfile, NetQueue,
                                         OptimisedServer, ServedObservation,
                                         Ticket, WorkerPool, layer_profile,
                                         make_recalibrator)
from repro_torch.service.store_backends import (BackendError, LocalDirBackend,
                                                ObjectStoreBackend,
                                                ScriptedFaults, StoreBackend,
                                                get_backend)

__all__ = [
    "ArtifactStore", "BackendError", "CircuitBreaker", "CorruptOutput",
    "DriftMonitor", "DriftStats", "Fault", "FaultError", "FaultInjector",
    "GpuPlatform", "LayerProfile", "LocalDirBackend", "NetQueue",
    "ObjectStoreBackend",
    "OptimisedNetwork", "OptimisedServer", "Platform", "PlatformModels",
    "ScriptedFaults", "ServedObservation", "SimulatedPlatform",
    "StoreBackend", "Ticket", "WorkerPool", "device_machine_id", "digest",
    "get_backend", "get_platform", "layer_profile", "make_recalibrator",
    "optimise", "reoptimise", "safe_assignment",
]
