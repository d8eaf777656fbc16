"""Service layer of the port: platform abstraction (the simulated platforms,
the simulated tile platform, the measured host CPU and the measured GPU),
artifact store, the profile → model → select pipeline and the concurrent
serving core.

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

    # the simulated tile platform: its plans serve on the kernels
    tpu = optimise("edge_cnn", "tpu", base=intel, budget=0.05,
                   executable=True)

The names load lazily (PEP 562), so importing ``repro_torch.service``
loads nothing: the serving front end's intake processes import its
torch-free submodules only.
"""
import importlib

_EXPORTS = {
    "ArtifactStore": "artifacts", "digest": "artifacts",
    "OptimisedNetwork": "pipeline", "optimise": "pipeline",
    "reoptimise": "pipeline", "safe_assignment": "pipeline",
    "GpuPlatform": "platforms", "HostPlatform": "platforms",
    "PallasPlatform": "platforms", "Platform": "platforms",
    "PlatformModels": "platforms", "SimulatedPlatform": "platforms",
    "device_machine_id": "platforms", "get_platform": "platforms",
    "host_machine_id": "platforms",
    "BackendError": "store_backends", "LocalDirBackend": "store_backends",
    "ObjectStoreBackend": "store_backends", "ScriptedFaults": "store_backends",
    "StoreBackend": "store_backends", "get_backend": "store_backends",
    **{name: "serving" for name in (
        "BatchGroup", "CircuitBreaker", "CorruptOutput", "DriftMonitor",
        "DriftStats", "Fault", "FaultError", "FaultInjector", "LayerProfile",
        "NetQueue", "OptimisedServer", "ProcessFrontend", "ServedObservation",
        "SlabHandle", "SlabPool", "Ticket", "WorkerPool", "layer_profile",
        "make_recalibrator")},
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
