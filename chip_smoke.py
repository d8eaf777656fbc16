#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py            # from the repository root

Drives the port's main path — lower -> compile_plan -> OptimisedServer —
through its hand-written kernels and checks every result. Phases, each of
which asserts:

1. The card (``nvidia-smi`` name and power limit), the torch / CUDA / nvcc
   versions, and the kernel build (one ``nvcc`` per source, in parallel,
   into ``build/kernels/``).
2. Each kernel against its plain PyTorch version on the card: at every call
   signature the served paths give it (recorded while the server binds and
   warms its per-bucket plans), and at the largest of them under every
   ``VARIANTS`` key and every epilogue combination. Each kernel is then
   timed over one b=8 forward pass of every path that runs it (device
   time, launches replayed from a CUDA graph) beside its plain version,
   one library call computing the same function, and its bound.
3. edge_cnn served in bursts of 1, 3 and 8 under (a) the PBQP-selected tile
   assignment and (b) the kernel-mix assignment.
4. resnet18 at its published width (224x224 input, 64-512 channels) served
   in bursts of 8 under the kernel-mix assignment.

Every served response is held at rtol=atol=1e-3 against the port's
interpreted executor on the card under the base (non-tile) columns — plain
torch, no hand-written kernel — so the oracle is independent of the kernels.
Launch counters are zeroed just before each served path and read just after
it. Each path's served img/s at b=8 follows, over several windows of
back-to-back bursts so the spread shows, with the device-busy time of one
burst under ``torch.profiler`` and the device ops that took most of it.
The last line of output is the ``{"ok": true, "device": ...}`` record.
The script fails (non-zero exit, no result) without a CUDA device.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from importlib import metadata
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): fp32 outside
# the tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

# BENCH_executor.json -> networks.edge_cnn.tile_variant.selected_assignment:
# the PBQP-selected tile column per edge_cnn conv node (joins take "chw")
EDGE_CNN_PBQP = {
    0: "im2col-copy-ab-ki@mm-256x256x256", 1: "im2col-scan-ab-ki@mm-256x256x256",
    2: "im2col-copy-ab-ki@mm-256x256x256", 3: "im2col-copy-ab-ki@mm-256x256x256",
    5: "im2col-scan-ab-ki@mm-256x256x256", 6: "im2col-scan-ab-ki@mm-256x256x256",
    7: "conv-1x1-gemm-ab-ki@mm-128x256x128", 9: "im2col-copy-ab-ki@mm-256x256x256",
    10: "im2col-scan-ab-ki@mm-256x256x256", 11: "im2col-copy-ab-ki@mm-256x256x256",
    12: "im2col-scan-ab-ki@mm-256x256x256", 14: "im2col-scan-ab-ki@mm-256x256x256",
    15: "im2col-scan-ab-ki@mm-256x256x256", 17: "im2col-scan-ab-ki@mm-256x256x256",
}

KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)   # fp32, unit-scale operands: sum order only
SERVE_TOL = dict(rtol=1e-3, atol=1e-3)    # fp32 sum order compounding over ~20 layers
RATE_WINDOWS, RATE_WINDOW_S = 5, 2.0      # served img/s: windows per path, seconds each
TOP_DEVICE_OPS = 8                        # device ops listed per profiled burst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20, help="timed launches per call")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import common
    from repro_torch.models import cnn_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: card, toolchain, build ----------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = next(line.strip() for line in subprocess.run(
        [common.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True).stdout.splitlines() if "release" in line)
    try:
        triton = metadata.version("triton")       # not used by the port
    except metadata.PackageNotFoundError:
        triton = "not installed"
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  nvcc: {nvcc}  triton {triton}")
    build_s = common.build_kernels()
    print(f"kernel build: {build_s:.1f} s ({len(common.SOURCES)} sources, "
          f"parallel nvcc, sm_90a)", flush=True)

    # -- phase 2: register the served paths, hold each kernel to its plain
    # version at their shapes, time it -----------------------------------
    paths = {
        "edge_cnn_pbqp": (cnn_zoo.get("edge_cnn"), None),
        "edge_cnn_mix": (cnn_zoo.get("edge_cnn"), kernel_mix_assignment),
        "resnet18_mix": (cnn_zoo.get("resnet18"), kernel_mix_assignment),
    }
    server, nets, weights = make_server(torch, paths, args.seed)
    seen_all = {k: set(c) for k, c in common.SEEN.items()}   # warm-up signatures
    # one b=8 forward per path: each kernel's launches and signatures per pass
    rng = np.random.default_rng(args.seed + 1)
    per_pass = {k: {} for k in common.KERNELS}
    for name, opt in nets.items():
        common.reset_launches()
        server.serve(name, list(images(rng, opt.spec, 8)))
        for k in common.KERNELS:
            if common.SEEN[k]:
                per_pass[k][name] = dict(common.SEEN[k])
    report = {k: check_and_time(torch, k, seen_all[k], per_pass[k], args.reps)
              for k in common.KERNELS}
    torch.cuda.synchronize()

    # -- phases 3 and 4: serve and hold every response to the oracle ------
    bursts = {"edge_cnn_pbqp": (1, 3, 8), "edge_cnn_mix": (1, 3, 8),
              "resnet18_mix": (8,)}
    launches = {}
    serve_err = {}
    for name, sizes in bursts.items():
        opt = nets[name]
        reqs = [images(rng, opt.spec, b) for b in sizes]
        common.reset_launches()
        outs = [server.serve(name, list(r)) for r in reqs]
        torch.cuda.synchronize()
        launches[name] = dict(common.LAUNCHES)
        want = routed_kernels(opt.assignment)
        assert all(launches[name][k] > 0 for k in want), (name, launches[name])
        assert all(launches[name][k] == 0 for k in common.KERNELS if k not in want)
        serve_err[name] = check_responses(opt, weights[name], reqs, outs)
        print(f"served {name}: bursts {sizes}, max |served - oracle| = "
              f"{serve_err[name]:.3g}, launches {launches[name]}", flush=True)
    for k in common.KERNELS:
        assert sum(launches[p][k] for p in launches) > 0, k

    rates = {name: images_per_s(server, nets[name], rng) for name in nets}
    busy = {name: device_busy(server, nets[name], rng) for name in nets}

    # -- report -----------------------------------------------------------
    summary = {k: {"launches": {p: launches[p][k] for p in launches},
                   "max_abs_err": r["max_abs_err"],
                   "b8_pass": r["passes"]}
               for k, r in report.items()}
    print("kernels: " + json.dumps(summary))
    for name, r in rates.items():
        med = float(np.median(r))
        print(f"served img/s {name} b=8: median {med!r} over {len(r)} windows "
              f"{[round(x, 1) for x in r]} (min {min(r)!r}, max {max(r)!r})"
              f"  ({smi})")
        busy_ms, wall_ms, top = busy[name]
        burst_ms = 8e3 / med
        if busy_ms is None:
            print(f"  one profiled burst {name}: wall {wall_ms!r} ms, device "
                  f"busy not measured (no device events recorded)")
            continue
        print(f"  one profiled burst {name}: wall {wall_ms!r} ms, device busy "
              f"{busy_ms!r} ms; busy share {busy_ms / wall_ms!r} of the "
              f"profiled burst, {busy_ms / burst_ms!r} of the median "
              f"unprofiled burst ({burst_ms!r} ms)")
        for op, ms in top:
            print(f"    device {ms:.4f} ms  {op}")
    rows = []
    for k, r in report.items():
        # headline times: the path where the kernel does the most work
        path, t = max(r["passes"].items(), key=lambda pt: pt[1]["bound_ms"])
        rows.append({"name": k, "route": "cuda", "source": r["source"],
                     "replaces": r["replaces"],
                     "launches": sum(launches[p][k] for p in launches),
                     "max_abs_err": r["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "launches_per_pass": t["launches"],
                     "timed_on": f"{path} b=8 forward", "card": smi})
    print(json.dumps({"kernels": rows}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# Served paths
# ---------------------------------------------------------------------------

def make_server(torch, paths, seed):
    """One pump-mode server on the card holding every path (batch cap 8),
    with random weights from ``seed``. Registering binds and warms one plan
    per pow2 bucket, which records every kernel call signature."""
    from repro_torch.primitives.executor import make_weights
    from repro_torch.service.pipeline import OptimisedNetwork
    from repro_torch.service.serving.server import OptimisedServer
    server = OptimisedServer(max_batch=8, latency_budget_ms=float("inf"),
                             device="cuda")
    nets, weights = {}, {}
    for name, (spec, rule) in paths.items():
        asg = rule(spec) if rule is not None else {
            i: EDGE_CNN_PBQP.get(i, "chw") for i in range(len(spec.nodes))}
        nets[name] = OptimisedNetwork.from_assignment(spec, asg, net=name)
        weights[name] = make_weights(spec, seed, device="cuda")
        server.register(nets[name], weights=weights[name])
    torch.cuda.synchronize()
    return server, nets, weights


def images(rng, spec, n):
    node = spec.nodes[0]
    return rng.standard_normal((n, node.c, node.im, node.im)).astype(np.float32)


def routed_kernels(assignment):
    """Kernels an assignment's tile columns launch."""
    from repro_torch.primitives.conv import resolve, split_tile
    out = set()
    for col in assignment.values():
        variant = split_tile(col)[1]
        if variant is None:
            continue
        if variant.startswith("conv-bk"):
            out.add("conv_im2col_batch")
        elif variant.startswith("wino-") or resolve(col).family == "wino3":
            out.add("winograd_point_gemm_batch")
        else:
            out.add("matmul")
    return out


def check_responses(opt, weights, reqs, outs) -> float:
    """Every response against the interpreted executor under the base
    columns (plain torch on the card, no kernel). Returns the max error."""
    from repro_torch.kernels import common
    from repro_torch.primitives.conv import split_tile
    from repro_torch.primitives.executor import execute
    from repro_torch.primitives.plan import sink_nodes
    base = {i: split_tile(c)[0] for i, c in opt.assignment.items()}
    sink = sink_nodes(opt.spec)[-1]
    before = dict(common.LAUNCHES)
    worst = 0.0
    for xs, ys in zip(reqs, outs):
        for x, y in zip(xs, ys):
            rep = execute(opt.spec, base, weights, x=x, compiled=False,
                          device="cuda")
            want = rep.outputs[sink].cpu().numpy()
            assert y.shape == want.shape and np.isfinite(y).all()
            np.testing.assert_allclose(y, want, **SERVE_TOL)
            worst = max(worst, float(np.abs(y - want).max()))
    assert common.LAUNCHES == before, "the oracle must not launch a kernel"
    return worst


def images_per_s(server, opt, rng) -> list:
    """Served img/s at b=8, once per window: back-to-back bursts on the
    host clock until ``RATE_WINDOW_S`` seconds have passed, each burst ending in
    a device sync (``serve`` copies the results back). One rate per
    window, so the run-to-run spread shows."""
    reqs = [list(images(rng, opt.spec, 8)) for _ in range(4)]
    server.serve(opt.net, reqs[0])
    rates = []
    for _ in range(RATE_WINDOWS):
        n, t0 = 0, time.perf_counter()
        while True:
            server.serve(opt.net, reqs[n % len(reqs)])
            n += 1
            dt = time.perf_counter() - t0
            if dt >= RATE_WINDOW_S:
                break
        rates.append(8 * n / dt)
    return rates


def device_busy(server, opt, rng):
    """One served b=8 burst under ``torch.profiler``: (device-busy ms, wall
    ms, the ``TOP_DEVICE_OPS`` device ops by time as (name, ms)). Busy time is the
    union of the device events' own intervals (kernels and copies). The
    CPU-side rows, which Kineto tags with their kernel's time, and user
    annotations are left out, so no device time counts twice. Busy ms is
    None when the profiler recorded no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = list(images(rng, opt.spec, 8))
    server.serve(opt.net, reqs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.serve(opt.net, reqs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    by_op = {}
    for e in evs:
        by_op[e.name[:90]] = by_op.get(e.name[:90], 0.0) + e.time_range.elapsed_us() * 1e-3
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP_DEVICE_OPS]
    return (busy_us * 1e-3 if evs else None), wall_ms, ranked


def kernel_mix_assignment(spec):
    """The kernel-mix tile assignment, which routes a net through the
    implicit-GEMM conv and the Winograd point-GEMM kernels, the latter
    under both a ``wino-*`` and an ``mm-*`` tiling (the matmul kernel is
    covered by the PBQP path's ``mm-*`` columns): 1x1 convs ->
    ``conv-1x1-gemm-ab-ki@conv-bk64``; the first 3x3 stride-1 conv in topo
    order where F(4x4, 3x3) applies -> ``winograd-4x4-3x3@mm-128x128x128``;
    every other 3x3 stride-1 conv -> ``winograd-2x2-3x3@wino-128x128``;
    every other conv -> ``im2col-copy-ab-ki@conv-bk128``; ``chw``
    elsewhere."""
    from repro_torch.models.cnn_zoo import ConvLayer
    from repro_torch.primitives.conv import REGISTRY
    from repro_torch.primitives.plan import topo_order
    asg = {}
    wino44 = REGISTRY["winograd-4x4-3x3"]
    first44 = True
    for i in topo_order(spec):
        node = spec.nodes[i]
        if not isinstance(node, ConvLayer):
            asg[i] = "chw"
        elif node.f == 1:
            asg[i] = "conv-1x1-gemm-ab-ki@conv-bk64"
        elif node.f == 3 and node.s == 1:
            if first44 and wino44.applicable(*node.config):
                asg[i] = "winograd-4x4-3x3@mm-128x128x128"
                first44 = False
            else:
                asg[i] = "winograd-2x2-3x3@wino-128x128"
        else:
            asg[i] = "im2col-copy-ab-ki@conv-bk128"
    return asg


# ---------------------------------------------------------------------------
# Kernels against their plain versions, and their times
# ---------------------------------------------------------------------------

def kernel_table(torch):
    """Per kernel: source, replaced TPU kernel, the wrapper / plain / library
    callables over one signature's operands, and the signature's work."""
    from repro_torch.kernels.im2col_gemm.im2col_gemm import (
        conv_im2col_batch, conv_im2col_batch_plain)
    from repro_torch.kernels.im2col_gemm.ops import CTA_TILES as CONV_TILES
    from repro_torch.kernels.im2col_gemm.ref import conv_ref
    from repro_torch.kernels.matmul.matmul import matmul, matmul_plain
    from repro_torch.kernels.matmul.ops import CTA_TILES as MM_TILES
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.winograd.ops import CTA_TILES as WINO_TILES
    from repro_torch.kernels.winograd.ref import point_gemm_ref
    from repro_torch.kernels.winograd.winograd import (
        winograd_point_gemm_batch, winograd_point_gemm_batch_plain)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda") * scale

    def mm_ops(sig):
        M, K, N, bm, bk, bn, hb, hr, relu = sig
        x, y = rnd(M, K, scale=K ** -0.5), rnd(K, N)
        ep = dict(bias=rnd(M) if hb else None,
                  residual=rnd(M, N) if hr else None, relu=relu)
        return (lambda: matmul(x, y, bm=bm, bk=bk, bn=bn, **ep),
                lambda: matmul_plain(x, y, **ep),
                lambda: matmul_ref(x, y))

    def mm_work(sig):
        M, K, N, *_, hb, hr, relu = sig
        return (2 * M * K * N + M * N * (hb + hr + relu),
                4 * (M * K + K * N + M * N * (1 + hr) + M * hb))

    def conv_ops(sig):
        N, C, H, W, K, f, s, bm, bk, bn, hb, hr, relu = sig
        oh, ow = (H - f) // s + 1, (W - f) // s + 1
        x, w = rnd(N, C, H, W), rnd(K, C, f, f, scale=(C * f * f) ** -0.5)
        ep = dict(bias=rnd(K) if hb else None,
                  residual=rnd(N, K, oh, ow) if hr else None, relu=relu)
        return (lambda: conv_im2col_batch(x, w, s, bm=bm, bk=bk, bn=bn, **ep),
                lambda: conv_im2col_batch_plain(x, w, s, **ep),
                lambda: conv_ref(x, w, s))

    def conv_work(sig):
        N, C, H, W, K, f, s, _, _, _, hb, hr, relu = sig
        P = N * ((H - f) // s + 1) * ((W - f) // s + 1)
        return (2 * P * K * C * f * f + P * K * (hb + hr + relu),
                4 * (N * C * H * W + K * C * f * f + P * K * (1 + hr) + K * hb))

    def wino_ops(sig):
        N, P, K, C, T, bm, bk, bn = sig
        u, v = rnd(P, K, C, scale=C ** -0.5), rnd(N, P, C, T)
        return (lambda: winograd_point_gemm_batch(u, v, bm=bm, bk=bk, bn=bn),
                lambda: winograd_point_gemm_batch_plain(u, v),
                lambda: point_gemm_ref(u, v))

    def wino_work(sig):
        N, P, K, C, T = sig[:5]
        return 2 * N * P * K * C * T, 4 * (P * K * C + N * P * C * T + N * P * K * T)

    eps = list(itertools.product((False, True), repeat=3))
    return {
        "matmul": dict(
            source="src/repro_torch/csrc/matmul.cu",
            replaces="src/repro/kernels/matmul/matmul.py:140",
            ops=mm_ops, work=mm_work,
            sweep=lambda s: [(*s[:3], *t, *e) for t in MM_TILES.values()
                             for e in eps]),
        "conv_im2col_batch": dict(
            source="src/repro_torch/csrc/im2col_gemm.cu",
            replaces="src/repro/kernels/im2col_gemm/im2col_gemm.py:155",
            ops=conv_ops, work=conv_work,
            sweep=lambda s: [(*s[:7], *t, *e) for t in CONV_TILES.values()
                             for e in eps]),
        "winograd_point_gemm_batch": dict(
            source="src/repro_torch/csrc/winograd.cu",
            replaces="src/repro/kernels/winograd/winograd.py:77",
            ops=wino_ops, work=wino_work,
            sweep=lambda s: [(*s[:5], *t) for t in
                             list(WINO_TILES.values()) + list(MM_TILES.values())]),
    }


def time_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds per call: ``reps`` back-to-back calls
    captured in one CUDA graph, replayed between CUDA events. The replay
    has no host work between launches, so a small kernel is timed by the
    device and not by the Python wrapper's overhead. Operands stay the
    same across calls (L2-warm where they fit in its 50 MB)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_and_time(torch, name, seen, passes, reps):
    """Hold ``name`` to its plain version at every signature in ``seen`` and
    across the tile/epilogue sweep at the largest of them; then, for each
    path in ``passes`` ({path: {signature: launches}} of one b=8 forward),
    time that pass's launches — kernel, plain version, library call and
    bound, each summed over the pass."""
    from repro_torch.kernels import common
    spec = kernel_table(torch)[name]
    assert seen, f"{name}: the served paths gave it no launch"
    largest = max(seen, key=lambda s: spec["work"](s)[0])
    worst = 0.0
    for sig in sorted(seen | set(spec["sweep"](largest))):
        kern, plain, _ = spec["ops"](sig)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), (name, sig)
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        worst = max(worst, float((got - want).abs().max()))
    out = {}
    for path, counts in passes.items():
        t = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
        flop_s = byte_s = 0.0
        for sig, n in counts.items():
            kern, plain, lib = spec["ops"](sig)
            t["ms"] += n * time_ms(torch, kern, reps)
            t["plain_ms"] += n * time_ms(torch, plain, reps)
            t["library_ms"] += n * time_ms(torch, lib, reps)
            flops, nbytes = spec["work"](sig)
            t["bound_ms"] += n * max(flops / FP32_FLOPS, nbytes / HBM_BYTES_S) * 1e3
            flop_s += n * flops / FP32_FLOPS
            byte_s += n * nbytes / HBM_BYTES_S
        t["bound_by"] = "operations" if flop_s >= byte_s else "bytes"
        t["launches"] = sum(counts.values())
        out[path] = t
        print(f"{name}: one b=8 pass of {path}: {t['launches']} launches, "
              f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
              f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} by "
              f"{t['bound_by']})", flush=True)
    common.reset_launches()          # the launches above were not the main path
    print(f"{name}: {len(seen)} served signatures + sweep hold to plain, "
          f"max |err| {worst:.3g}", flush=True)
    return {"source": spec["source"], "replaces": spec["replaces"],
            "max_abs_err": worst, "passes": out}


if __name__ == "__main__":
    raise SystemExit(main())
