#!/usr/bin/env python3
"""A/B of the bf16 batched matmul's two routes (row 4 of PERF.md's table):
``csrc/matmul.cu``'s mma.sync kernel against ``csrc/matmul_wgmma.cu``'s
wgmma kernels, in turns on one card.

    python3 tools/ab_matmul_batch_bf16.py [--reps 20] [--tiles]

Records the launch signatures of ``chip_smoke.py``'s bf16 ``matmul_batch``
pass of phase 5 (resnet18's 20 convs at 224 x 224 as per-image GEMMs at b
= 8: the (M, C f f) weights broadcast over the batch, ``F.unfold``'s
patches, bf16 bias and residual, ReLU, through ``matmul_batch_op``), then
times every layer on each route in turns, mma.sync / wgmma / wgmma /
mma.sync, each route named explicitly under the plan it gives the layer at
phase 5's variant (``ops.cta_plan``; ``ops.wgmma_plan`` under the call's
``matmul.loaders``), beside broadcast bf16 ``torch.matmul`` on the same
operands (``chip_smoke.time_ms``: launches replayed from a CUDA graph, or
timed eagerly above 1 ms). Each layer's output on both routes is held to
the plain version first (``chip_smoke.hold_bf16``). With ``--tiles`` every
wgmma tile instantiated for the layer's loaders (``matmul.wgmma_tiles``)
is also timed on it, split by the plan's rule (``ops.wgmma_split``), with
the fastest marked. Prints one line a layer and one for the pass, with the
card's name and power limit, and writes everything to ``--out`` (default
``build/ab_matmul_batch_bf16.json``). Needs a CUDA device and nvcc; exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SEED = 0
VARIANT = "mm-128x128x128"                # matmul_batch_op's default: phase 5's plans
ORDER = ("mma.sync", "wgmma", "wgmma", "mma.sync")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20,
                    help="calls a timing averages (chip_smoke.time_ms)")
    ap.add_argument("--tiles", action="store_true",
                    help="also time every wgmma tile of the layer's loaders")
    ap.add_argument("--out", default=str(ROOT / "build" / "ab_matmul_batch_bf16.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ab_matmul_batch_bf16: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import common
    from repro_torch.kernels.matmul.matmul import (loaders, matmul_batch,
                                                   matmul_batch_plain, packs,
                                                   wgmma_tiles)
    from repro_torch.kernels.matmul.ops import cta_plan, plan, wgmma_split
    from repro_torch.models import cnn_zoo
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    for name in [n for n in common.LIBRARIES if n not in ("matmul_bf16", "matmul_wgmma")]:
        del common.LIBRARIES[name]
    build_s = common.build_kernels()
    smi = card()
    batch = smoke.ENTRY_BATCH
    layers = smoke.conv_layers(cnn_zoo.get("resnet18"))
    common.reset_launches()
    smoke.drive_matmul_batch(torch, "cuda", np.random.default_rng(SEED), layers,
                             batch, bf16=True)
    torch.cuda.synchronize()
    seen = list(common.SEEN["matmul_batch"])
    assert len(seen) == len(layers), seen
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    path = f"resnet18 convs as GEMMs, b={batch} bf16"
    report = {"card": smi, "build_s": build_s, "variant": VARIANT, "path": path,
              "layers": []}
    totals = {"runs": [0.0] * len(ORDER), "library": 0.0}
    for (lname, C, H, K, f, s), sig in zip(layers, seen):
        oh = (H - f) // s + 1
        M, Kd, N = K, C * f * f, oh * oh
        x = rnd(batch, C, H, H)
        wm = rnd(M, Kd, scale=Kd ** -0.5)
        a, b = wm.expand(batch, M, Kd), F.unfold(x, f, stride=s)
        ep = dict(bias=rnd(M), residual=rnd(batch, M, N), relu=True)
        how = loaders(a, b)
        assert sig[-3] == how and sig[-5] == "wgmma", (lname, sig)
        bm, bn, bk, split = cta_plan(M, N, Kd, batch, VARIANT, torch.bfloat16)
        wp = plan(a, b, VARIANT)
        calls = {"mma.sync": lambda: matmul_batch(a, b, bm=bm, bk=bk, bn=bn,
                                                  split_k=split, route="mma.sync", **ep),
                 "wgmma": lambda: matmul_batch(a, b, **wp, **ep)}
        want = matmul_batch_plain(a, b, out_dtype=torch.float32, **ep)
        for call in calls.values():
            smoke.hold_bf16(torch, call(), want, smoke.KERNEL_TOL["atol"])
        runs = [smoke.time_ms(torch, calls[rt], args.reps) for rt in ORDER]
        lib = smoke.time_ms(torch, lambda: torch.matmul(a, b), args.reps)
        row = {"layer": lname, "M": M, "K": Kd, "N": N, "loaders": how,
               "packed": packs(a, b, how), "mma_plan": [bm, bk, bn, split],
               "wgmma_plan": [wp["bm"], wp["bn"], wp["stages"], wp["split_k"]],
               "runs": runs, "library_ms": lib}
        if args.tiles:
            tiles = {}
            cols, entries = (N * batch, 1) if row["packed"] else (N, batch)
            for tbm, tbn, tst in wgmma_tiles(how):
                tsplit = wgmma_split(-(-M // tbm) * -(-cols // tbn) * entries, Kd)
                tcall = lambda: matmul_batch(a, b, bm=tbm, bn=tbn,  # noqa: E731
                                             stages=tst, split_k=tsplit,
                                             route="wgmma", **ep)
                smoke.hold_bf16(torch, tcall(), want, smoke.KERNEL_TOL["atol"])
                tiles[f"{tbm}x{tbn}x{tst} split {tsplit}"] = smoke.time_ms(
                    torch, tcall, args.reps)
            row["tiles"] = tiles
            row["best_tile"] = min(tiles, key=tiles.get)
        report["layers"].append(row)
        for i, t in enumerate(runs):
            totals["runs"][i] += t
        totals["library"] += lib
        print(f"{path} {lname} (M {M}, K {Kd}, N {N}, {how}"
              f"{', packed' if row['packed'] else ''}): "
              + " / ".join(f"{t:.4f}" for t in runs)
              + f" ms (mma.sync {bm}x{bk}x{bn} split {split}; wgmma "
              f"{wp['bm']}x{wp['bn']}x{wp['stages']} split {wp['split_k']}); "
              f"torch.matmul {lib:.4f}"
              + (f"; best tile {row['best_tile']} {row['tiles'][row['best_tile']]:.4f}"
                 if args.tiles else ""), flush=True)
        if args.tiles:
            print("    tiles: " + ", ".join(f"{k} {t:.4f}" for k, t in row["tiles"].items()))
    report.update(totals)
    print(f"{path}: mma.sync / wgmma / wgmma / mma.sync "
          + " / ".join(f"{t:.4f}" for t in totals["runs"])
          + f" ms; torch.matmul {totals['library']:.4f} ms; build {build_s:.1f} s  ({smi})",
          flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
