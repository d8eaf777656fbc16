#!/usr/bin/env python3
"""A/B of the bf16 implicit-GEMM conv's two routes (rows 2 and 5 of
PERF.md's table): ``csrc/im2col_gemm.cu``'s mma.sync kernel against
``csrc/conv_wgmma.cu``'s wgmma kernel, in turns on one card.

    python3 tools/ab_conv_bf16.py [--reps 20] [--tiles]

Records the launch signatures of ``chip_smoke.py``'s two bf16 conv passes
of phase 5 (``conv_im2col_op`` on resnet18's 20 convs of one 224 x 224
image, ``conv_im2col_batch_op`` on them at b = 8, bias and residual bf16,
ReLU), then times every layer of each pass on each route in turns,
mma.sync / wgmma / wgmma / mma.sync, each under the plan its entry point
gives it (``ops.cta_plan`` and ``ops.wgmma_plan`` under ``conv-bk128``),
beside bf16 ``F.conv2d`` on the same operands (``chip_smoke.time_ms``:
launches replayed from a CUDA graph, or timed eagerly above 1 ms). Each
layer's wgmma output is held to the plain version first
(``chip_smoke.hold_bf16``). With ``--tiles`` every instantiated wgmma tile
is also timed on every layer, unsplit and under the plan's split, with the
fastest marked. Prints one line a layer and a pass, with the card's name
and power limit, and writes everything to ``--out`` (default
``build/ab_conv_bf16.json``). Needs a CUDA device and nvcc; exits
non-zero without one.
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
VARIANT = "conv-bk128"                    # the entry points' default
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
    ap.add_argument("--out", default=str(ROOT / "build" / "ab_conv_bf16.json"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ab_conv_bf16: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import common
    from repro_torch.kernels.im2col_gemm.im2col_gemm import (
        WGMMA_TILES, conv_im2col, conv_im2col_batch, conv_im2col_batch_plain,
        conv_im2col_plain)
    from repro_torch.kernels.im2col_gemm.ops import cta_plan, wgmma_plan
    from repro_torch.models import cnn_zoo
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    for name in [n for n in common.LIBRARIES if n not in ("im2col_gemm_bf16", "conv_wgmma")]:
        del common.LIBRARIES[name]         # the two routes' bf16 kernels alone
    build_s = common.build_kernels()
    smi = card()
    layers = smoke.conv_layers(cnn_zoo.get("resnet18"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    report = {"card": smi, "build_s": build_s, "variant": VARIANT, "passes": {}}
    for batch in (None, smoke.ENTRY_BATCH):
        path = "resnet18 convs, 1 image bf16" if batch is None else \
            f"resnet18 convs, b={batch} bf16"
        kernel = "conv_im2col" if batch is None else "conv_im2col_batch"
        common.reset_launches()
        smoke.drive_conv_im2col(torch, "cuda", np.random.default_rng(SEED), layers,
                                batch, bf16=True)
        torch.cuda.synchronize()
        seen = list(common.SEEN[kernel])
        assert len(seen) == len(layers) and {s[-2] for s in seen} == {"wgmma"}, seen
        rows, totals = [], {"runs": [0.0] * len(ORDER), "library": 0.0}
        for (lname, C, H, K, f, s), sig in zip(layers, seen):
            n = batch or 1
            oh = (H - f) // s + 1
            lead = () if batch is None else (batch,)
            x = rnd(*lead, C, H, H)
            w = rnd(K, C, f, f, scale=(C * f * f) ** -0.5)
            ep = dict(bias=rnd(K), residual=rnd(*lead, K, oh, oh), relu=True)
            P, R = n * oh * oh, C * f * f
            bm, bn, bk, split = cta_plan(K, P, R, VARIANT, torch.bfloat16)
            wbm, wbn, _, wsplit = wgmma_plan(K, P, R, VARIANT)
            kern, plain = ((conv_im2col, conv_im2col_plain) if batch is None
                           else (conv_im2col_batch, conv_im2col_batch_plain))
            calls = {
                "mma.sync": lambda: kern(x, w, s, bm=bm, bk=bk, bn=bn, split_k=split, **ep),
                "wgmma": lambda: kern(x, w, s, bm=wbm, bn=wbn, split_k=wsplit,
                                      route="wgmma", **ep)}
            ep32 = dict(bias=ep["bias"].float(), residual=ep["residual"].float(), relu=True)
            want = plain(x.float(), w.float(), s, **ep32)
            for rt, call in calls.items():
                smoke.hold_bf16(torch, call(), want, smoke.KERNEL_TOL["atol"])
            xb = x if batch else x[None]
            runs = [smoke.time_ms(torch, calls[rt], args.reps) for rt in ORDER]
            lib = smoke.time_ms(torch, lambda: F.conv2d(xb, w, stride=s), args.reps)
            row = {"layer": lname, "C": C, "H": H, "K": K, "f": f, "s": s, "P": P,
                   "mma_plan": [bm, bk, bn, split], "wgmma_plan": [wbm, wbn, wsplit],
                   "runs": runs, "library_ms": lib}
            if args.tiles:
                tiles = {}
                for tbm, tbn in WGMMA_TILES:
                    for sp in sorted({1, wsplit}):
                        try:
                            tcall = lambda: kern(x, w, s, bm=tbm, bn=tbn,  # noqa: E731
                                                 split_k=sp, route="wgmma", **ep)
                            smoke.hold_bf16(torch, tcall(), want, smoke.KERNEL_TOL["atol"])
                        except ValueError:         # a split a step short
                            continue
                        tiles[f"{tbm}x{tbn} split {sp}"] = smoke.time_ms(
                            torch, tcall, args.reps)
                row["tiles"] = tiles
                row["best_tile"] = min(tiles, key=tiles.get)
            rows.append(row)
            for i, v in enumerate(runs):
                totals["runs"][i] += v
            totals["library"] += lib
            print(f"{path} {lname} (C {C}, H {H}, K {K}, f {f}, s {s}, P {P}): "
                  + " / ".join(f"{v:.4f}" for v in runs)
                  + f" ms (mma.sync {bm}x{bk}x{bn} split {split}; wgmma {wbm}x{wbn} "
                  f"split {wsplit}); F.conv2d {lib:.4f}"
                  + (f"; best tile {row['best_tile']} {row['tiles'][row['best_tile']]:.4f}"
                     if args.tiles else ""), flush=True)
        report["passes"][path] = {"layers": rows, **totals}
        print(f"{path}: mma.sync / wgmma / wgmma / mma.sync "
              + " / ".join(f"{v:.4f}" for v in totals["runs"])
              + f" ms; F.conv2d {totals['library']:.4f} ms  ({smi})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
