#!/usr/bin/env python3
"""A/B of the bf16 Winograd point-GEMM's two routes (rows 3 and 6 of
PERF.md's table): ``csrc/winograd.cu``'s mma.sync kernel against
``csrc/winograd_wgmma.cu``'s wgmma kernel, in turns on one card.

    python3 tools/ab_wino_bf16.py [--reps 20] [--tiles]

Records the launch signatures of ``chip_smoke.py``'s two bf16 point-GEMM
passes of phase 5 (``winograd_point_gemm`` on the F(2x2) point-GEMMs of
resnet18's 13 3x3 stride-1 convs of one 224 x 224 image,
``winograd_point_gemm_batch`` on them at b = 8), then times every layer of
each pass on each route in turns, mma.sync / wgmma / wgmma / mma.sync,
each under the plan its route gives it under ``wino-128x128``
(``ops.cta_plan`` and ``ops.wgmma_plan``, whichever route ``ops.route``
sends the layer to), beside broadcast bf16
``torch.matmul`` on the same operands (``chip_smoke.time_ms``: launches
replayed from a CUDA graph, or timed eagerly above 1 ms). Each layer's
output on both routes is held to the plain version first
(``chip_smoke.hold_bf16``). With ``--tiles`` every instantiated wgmma tile
is also timed on every layer, with the fastest marked. Prints one line a layer and a pass, with the card's name
and power limit, and writes everything to ``--out`` (default
``build/ab_wino_bf16.json``). Needs a CUDA device and nvcc; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SEED = 0
VARIANT = "wino-128x128"                  # phase 5's plans
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
                    help="also time every instantiated wgmma tile a layer")
    ap.add_argument("--out", default=str(ROOT / "build" / "ab_wino_bf16.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_wino_bf16: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import common
    from repro_torch.kernels.winograd.ops import cta_plan, route, wgmma_plan
    from repro_torch.kernels.winograd.winograd import (
        WGMMA_TILES, winograd_point_gemm, winograd_point_gemm_batch,
        winograd_point_gemm_batch_plain, winograd_point_gemm_plain)
    from repro_torch.models import cnn_zoo
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    # the two routes' bf16 kernels and the fp32 input transform of the drive
    for name in [n for n in common.LIBRARIES
                 if n not in ("winograd", "winograd_bf16", "winograd_wgmma")]:
        del common.LIBRARIES[name]
    build_s = common.build_kernels()
    smi = card()
    layers = [l for l in smoke.conv_layers(cnn_zoo.get("resnet18"))
              if l[4] == 3 and l[5] == 1]
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    report = {"card": smi, "build_s": build_s, "variant": VARIANT, "passes": {}}
    for batch in (None, smoke.ENTRY_BATCH):
        path = ("resnet18 3x3 s1 point-GEMMs, 1 image, F(2x2) bf16" if batch is None
                else f"resnet18 3x3 s1 point-GEMMs, b={batch}, F(2x2) bf16")
        kernel = "winograd_point_gemm" if batch is None else "winograd_point_gemm_batch"
        common.reset_launches()
        smoke.drive_point_gemm(torch, "cuda", np.random.default_rng(SEED), layers, batch)
        torch.cuda.synchronize()
        seen = list(common.SEEN[kernel])
        assert len(seen) == len(layers), seen
        rows, totals = [], {"runs": [0.0] * len(ORDER), "library": 0.0}
        for (lname, C, H, K, _, _), sig in zip(layers, seen):
            T, P = sig[-7], sig[-10]
            lead = () if batch is None else (batch,)
            u = rnd(P, K, C, scale=C ** -0.5)
            v = rnd(*lead, P, C, T)
            n = P * (batch or 1)
            bm, bn, bk, split = cta_plan(K, T, C, n, VARIANT, torch.bfloat16)
            wbm, wbn = wgmma_plan(K, T, n, batch or 1)
            assert route(u, v) == sig[-2], (lname, sig)
            kern, plain = ((winograd_point_gemm, winograd_point_gemm_plain)
                           if batch is None else
                           (winograd_point_gemm_batch, winograd_point_gemm_batch_plain))
            calls = {
                "mma.sync": lambda: kern(u, v, bm=bm, bk=bk, bn=bn, split_k=split),
                "wgmma": lambda: kern(u, v, bm=wbm, bn=wbn, route="wgmma")}
            want = plain(u.float(), v.float())
            for call in calls.values():
                smoke.hold_bf16(torch, call(), want, smoke.KERNEL_TOL["atol"])
            runs = [smoke.time_ms(torch, calls[rt], args.reps) for rt in ORDER]
            lib = smoke.time_ms(torch, lambda: torch.matmul(u, v), args.reps)
            row = {"layer": lname, "C": C, "K": K, "T": T, "N": batch or 1,
                   "route": sig[-2], "mma_plan": [bm, bk, bn, split],
                   "wgmma_plan": [wbm, wbn], "runs": runs, "library_ms": lib}
            if args.tiles:
                tiles = {}
                for tbm, tbn in WGMMA_TILES:
                    tcall = lambda: kern(u, v, bm=tbm, bn=tbn,  # noqa: E731
                                         route="wgmma")
                    smoke.hold_bf16(torch, tcall(), want, smoke.KERNEL_TOL["atol"])
                    tiles[f"{tbm}x{tbn}"] = smoke.time_ms(torch, tcall, args.reps)
                row["tiles"] = tiles
                row["best_tile"] = min(tiles, key=tiles.get)
            rows.append(row)
            for i, x in enumerate(runs):
                totals["runs"][i] += x
            totals["library"] += lib
            print(f"{path} {lname} (C {C}, K {K}, T {T}): "
                  + " / ".join(f"{x:.4f}" for x in runs)
                  + f" ms (mma.sync {bm}x{bk}x{bn} split {split}; wgmma {wbm}x{wbn}; "
                  f"routed {sig[-2]}); torch.matmul {lib:.4f}"
                  + (f"; best tile {row['best_tile']} {row['tiles'][row['best_tile']]:.4f}"
                     if args.tiles else ""), flush=True)
        report["passes"][path] = {"layers": rows, **totals}
        print(f"{path}: mma.sync / wgmma / wgmma / mma.sync "
              + " / ".join(f"{x:.4f}" for x in totals["runs"])
              + f" ms; torch.matmul {totals['library']:.4f} ms  ({smi})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
