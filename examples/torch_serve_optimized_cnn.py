"""End-to-end serving driver on the PyTorch port (the paper's deployment
story), through the service layer: a ``GpuPlatform`` profiles the port's
primitives ON THE CARD, ``optimise`` trains a model and PBQP-selects an
executable assignment, and an ``OptimisedServer`` serves batched requests
through the compiled whole-graph plan — reported against a fixed-primitive
baseline (the port's counterpart of ``examples/serve_optimized_cnn.py``,
whose ``HostPlatform`` profiles the host CPU).

Batching knob: ``--batch N`` sets the request batch size; ``--sweep`` prints
an images/s curve over batch sizes 1/4/16. ``--workers N`` serves baseline
and optimised nets through ONE concurrent server (N worker threads,
``--max-wait-ms`` batch windows) instead of sequential measurements.
``--backends`` also routes one request stream across backends by predicted
cost: simulated platforms (``intel``, ``amd``, ``arm``), the simulated tile
platform (``tpu`` / ``pallas``, whose plan runs the hand-written kernels),
``host`` (this machine's CPU, measured on the pool above) and ``gpu`` (the
platform profiled above); every plan serves on ``--device``. Other names
raise as ``get_platform`` does.

The platform measures the card: without one ``GpuPlatform`` raises.
``--device cpu`` profiles and serves on the host instead, for the tests.

Run:  PYTHONPATH=src python examples/torch_serve_optimized_cnn.py [--requests 32]
      [--batch 8] [--sweep] [--workers 2] [--max-wait-ms 5] [--backends arm,gpu]
"""
import argparse
import time
from typing import List, Optional

import numpy as np

from repro_torch.models import cnn_zoo
from repro_torch.models.cnn_zoo import ConvLayer
from repro_torch.primitives.executor import make_weights
from repro_torch.service import (GpuPlatform, HostPlatform, OptimisedNetwork,
                                 OptimisedServer, get_platform, optimise)

PRIMITIVES = ["im2col-copy-ab-ki", "im2col-scan-ab-ki", "kn2row", "mec-col",
              "winograd-2x2-3x3", "conv-1x1-gemm-ab-ki", "direct-sum2d"]
DLT_PAIRS = [(16, 30), (32, 28), (32, 26), (64, 13)]
EXTRA_CONFIGS = {(32, 16, 28, 1, 3), (64, 32, 14, 1, 3), (16, 8, 30, 1, 3)}


def run(*, requests: int = 16, batch: int = 8, sweep: bool = False,
        workers: int = 0, max_wait_ms: float = 5.0,
        latency_budget_ms: float = float("inf"),
        backends: Optional[List[str]] = None, max_iters: int = 1200,
        repeats: int = 5, device="cuda") -> dict:
    """Profile, optimise and serve edge_cnn, printed as the reference
    prints it. Returns the img/s figures, the two networks and their
    weights, and ``samples``: (network, inputs, outputs) of the last
    request of each sequential measurement and of the first ``batch``
    tickets a net of the concurrent one, for an oracle to check."""
    print(f"== profiling primitives on {device} (the stage the perf model replaces) ==")
    t0 = time.perf_counter()
    spec = cnn_zoo.get("edge_cnn")
    convs = [(i, n) for i, n in enumerate(spec.nodes) if isinstance(n, ConvLayer)]
    pool = sorted({n.config for _, n in convs} | EXTRA_CONFIGS)
    platform = GpuPlatform(configs=pool, dlt_pairs=DLT_PAIRS,
                           primitives=PRIMITIVES, repeats=repeats, device=device)
    opt = optimise(spec, platform, executable=True, max_iters=max_iters, device=device)
    out = {"device": str(device), "profile_optimise_s": time.perf_counter() - t0,
           "profiled_configs": platform.primitive_dataset().n,
           "assignment": [opt.assignment[i] for i, _ in convs], "samples": []}
    print(f"   profiled {out['profiled_configs']} configs and "
          f"optimised in {out['profile_optimise_s']:.1f}s")
    print("   assignment:", out["assignment"])

    weights = make_weights(spec, device=device)
    baseline_asg = {i: ("conv-1x1-gemm-ab-ki" if n.f == 1 else "direct-sum2d")
                    for i, n in convs}
    baseline_asg.update({i: "chw" for i, n in enumerate(spec.nodes)
                         if not isinstance(n, ConvLayer)})
    baseline = OptimisedNetwork.from_assignment(
        spec, baseline_asg, net="edge_cnn_baseline", platform=platform,
        models=opt.models, columns=opt.columns)
    out.update(opt=opt, baseline=baseline, weights=weights)

    rng = np.random.default_rng(0)
    c, im = spec.nodes[0].c, spec.nodes[0].im
    images = lambda n: rng.standard_normal((n, c, im, im)).astype(np.float32)

    def serve(registered: OptimisedNetwork, tag, b):
        # one server per measurement: register, warm the plan once, then
        # serve the request stream batch-by-batch through the queue
        server = OptimisedServer(max_batch=b, latency_budget_ms=float("inf"),
                                 device=device)
        server.register(registered, weights=weights)
        server.serve(registered.net, images(b))
        t0 = time.perf_counter()
        for _ in range(requests):
            xs = images(b)
            ys = server.serve(registered.net, xs)
        dt = time.perf_counter() - t0
        server.stop()
        out["samples"].append((registered, xs, ys))
        print(f"   {tag:10s}: batch {b:3d} | {requests * b / dt:8.1f} img/s "
              f"({dt / requests * 1e3:.2f} ms/request)")
        return dt

    print(f"== serving {requests} request batches of {batch} ==")
    t_base = serve(baseline, "baseline", batch)
    t_opt = serve(opt, "optimised", batch)
    out["img_s"] = {"baseline": requests * batch / t_base,
                    "optimised": requests * batch / t_opt}
    out["speedup"] = t_base / t_opt
    print(f"   speedup: {out['speedup']:.2f}x")

    if workers:
        print(f"== concurrent serving core: both nets, {workers} "
              f"workers, {max_wait_ms:.0f} ms batch window ==")
        server = OptimisedServer(max_batch=batch, latency_budget_ms=latency_budget_ms,
                                 workers=workers, max_wait_ms=max_wait_ms,
                                 queue_depth=2 * requests * batch, device=device)
        server.register(opt, weights=weights)
        server.register(baseline, weights=weights)
        s0 = server.stats(opt.net)
        print(f"   batch cap {s0['batch_cap']}, effective window "
              f"{s0['effective_wait_ms']:.2f} ms "
              f"(cap {max_wait_ms:.1f} ms, budget {latency_budget_ms:.0f} ms)")
        for net in (opt.net, baseline.net):     # warm the plan cache
            server.serve(net, images(batch))
        sent = {opt.net: [], baseline.net: []}
        t0 = time.perf_counter()
        for _ in range(requests):
            for net in sent:
                sent[net] += [(x, server.submit(net, x)) for x in images(batch)]
        for pairs in sent.values():
            for _, t in pairs:
                t.wait(120.0)
        dt = time.perf_counter() - t0
        tickets = [t for pairs in sent.values() for _, t in pairs]
        served = sum(1 for t in tickets if t.done and t.error is None)
        for net, registered in ((opt.net, opt), (baseline.net, baseline)):
            s = server.stats(net)
            print(f"   {net:20s}: queue p50/p99 "
                  f"{s['queue_wait_p50_ms']:6.2f}/{s['queue_wait_p99_ms']:6.2f} ms "
                  f"({s['dispatches']} dispatches, {s['padded']} padded, "
                  f"{s['rejected']} rejected)")
            if s["failed_dispatches"] or s["fallback_images"]:
                print(f"   {'':20s}  {s['failed_dispatches']} dispatches "
                      f"failed ({s['retries']} retried), "
                      f"{s['fallback_images']} images served degraded, "
                      f"ledger {s['failures']}")
            first = [(x, t) for x, t in sent[net][:batch] if t.error is None]
            out["samples"].append((registered, np.stack([x for x, _ in first]),
                                   [t.result for _, t in first]))
        out["concurrent"] = {"img_s": served / dt, "failed": len(tickets) - served,
                             "sequential_img_s": 2 * requests * batch / (t_base + t_opt)}
        print(f"   both nets: {served / dt:8.1f} img/s overlapped "
              f"({len(tickets) - served} failed/rejected) "
              f"vs {out['concurrent']['sequential_img_s']:8.1f} sequential")
        server.stop()

    if backends:
        print(f"== cross-backend routing: {', '.join(backends)} ==")
        base = get_platform("intel", max_triplets=8).pretrain(max_iters=400, device=device)
        server = OptimisedServer(max_batch=batch, latency_budget_ms=float("inf"),
                                 workers=max(workers, 2), max_wait_ms=max_wait_ms,
                                 queue_depth=2 * requests * batch, device=device)
        for name in backends:
            plat = (platform if name == "gpu" else
                    HostPlatform(configs=pool, dlt_pairs=DLT_PAIRS,
                                 primitives=PRIMITIVES, repeats=repeats)
                    if name == "host" else get_platform(name, max_triplets=8))
            o = optimise(spec, plat, base=base, budget=0.05, executable=True,
                         max_iters=400, device=device)
            server.register(o, backend=name, weights=weights, max_inflight=1)
        server.serve(spec.name, images(batch))
        t0 = time.perf_counter()
        for _ in range(requests):
            server.serve(spec.name, images(batch))
        dt = time.perf_counter() - t0
        s = server.stats(spec.name)
        out["routed"] = {"img_s": requests * batch / dt,
                         "backends": {b: bs["images"] for b, bs in s["backends"].items()}}
        print(f"   routed: {requests * batch / dt:8.1f} img/s across {len(backends)} backends")
        for b, bs in s["backends"].items():
            print(f"   backend {b:6s}: {bs['dispatches']} dispatches, "
                  f"{bs['images']} images, queue p50/p99 "
                  f"{bs['queue_wait_p50_ms']:.2f}/{bs['queue_wait_p99_ms']:.2f} ms")
        server.stop()

    if sweep:
        print("== throughput vs batch size (optimised assignment) ==")
        out["sweep"] = {b: requests * b / serve(opt, f"batch={b}", b) for b in (1, 4, 16)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=16,
                    help="number of request batches per measurement")
    ap.add_argument("--batch", type=int, default=8,
                    help="images per request batch (the batching knob)")
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep batch sizes 1/4/16 on the optimised net")
    ap.add_argument("--workers", type=int, default=0,
                    help="serve both nets concurrently through this many "
                         "worker threads (0 = sequential pump mode)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="batch window cap when --workers > 0")
    ap.add_argument("--latency-budget-ms", type=float, default=float("inf"),
                    help="per-request latency budget for the concurrent "
                         "serving section; inf = batch-size cap only")
    ap.add_argument("--backends", default=None, metavar="P1,P2,...",
                    help="also route one request stream across these "
                         "platforms by predicted cost (e.g. 'arm,tpu,host,"
                         "gpu')")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    backends = ([s.strip() for s in args.backends.split(",") if s.strip()]
                if args.backends else None)
    return run(requests=args.requests, batch=args.batch, sweep=args.sweep,
               workers=args.workers, max_wait_ms=args.max_wait_ms,
               latency_budget_ms=args.latency_budget_ms, backends=backends,
               device=args.device)


if __name__ == "__main__":
    main()
