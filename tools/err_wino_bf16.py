#!/usr/bin/env python3
"""Accuracy of the bf16 Winograd point-GEMM's wgmma route
(``csrc/winograd_wgmma.cu``) on resnet18's 13 F(2x2) point-GEMMs, one or
more source trees in turn on one card.

    python3 tools/err_wino_bf16.py --trees build/other .

Each tree runs in a process of its own that imports the tree's
``repro_torch`` (``<tree>/src``) and builds only its ``winograd_wgmma``
library, into ``<tree>/build``. For each of resnet18's 13 3x3 stride-1
convs (K = C, T as phase 5 of ``chip_smoke.py`` gives them at 224 x 224),
on one image and at b = 8, u (16, K, C) and v (N, 16, C, T) are numpy
normals from a fixed seed rounded once to bf16 (the same values in every
tree), and the wgmma route runs them on every tile of the tree's
``WGMMA_TILES``. Each output is compared with the exact product of the
same bf16 values (float64 on the card):

- ``rel``: the largest |out - exact| over the largest |exact|;
- ``ulps``: the largest |out - exact| in units of the bf16 spacing at
  |exact| (one correct rounding is at most 0.5);
- ``over``: how many outputs lie more than half a spacing from the exact
  product, that is, what the fp32 sums' own rounding adds to the one bf16
  rounding at the store.

Prints one line per tree, layer and batch, with the card's name and power
limit, and writes every reading to ``--out`` (default
``build/err_wino_bf16.json``). Needs a CUDA device and nvcc; exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
# (C, T) of resnet18's 13 3x3 stride-1 convs at F(2x2), K = C
RESNET18 = [(64, 2916), (64, 2809), (64, 2704), (64, 2601), (128, 576),
            (128, 529), (128, 484), (256, 100), (256, 81), (256, 64),
            (512, 9), (512, 4), (512, 1)]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def measure(tree: Path) -> dict:
    """One tree, in this process, on its own sources."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("err_wino_bf16: no CUDA device")
    from repro_torch.kernels import common
    from repro_torch.kernels.winograd.winograd import (WGMMA_TILES,
                                                       winograd_point_gemm,
                                                       winograd_point_gemm_batch)
    for name in [n for n in common.LIBRARIES if n != "winograd_wgmma"]:
        del common.LIBRARIES[name]
    build_s = common.build_kernels()
    rng = np.random.default_rng(SEED)

    def rnd(*shape, scale=1.0):
        x = (rng.standard_normal(shape, dtype=np.float32) * scale)
        return torch.from_numpy(x).cuda().bfloat16()

    rows = []
    for C, T in RESNET18:
        for n in (1, 8):
            u = rnd(16, C, C, scale=C ** -0.5)
            v = rnd(n, 16, C, T)
            exact = torch.matmul(u.double(), v.double())
            mag = exact.abs()
            spacing = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -120))) - 7)
            row = {"C": C, "K": C, "T": T, "N": n, "tiles": {}}
            for bm, bn in WGMMA_TILES:
                if n == 1:
                    out = winograd_point_gemm(u, v[0], bm=bm, bn=bn, route="wgmma")[None]
                else:
                    out = winograd_point_gemm_batch(u, v, bm=bm, bn=bn, route="wgmma")
                err = (out.double() - exact).abs()
                ulps = err / spacing
                row["tiles"][f"{bm}x{bn}"] = {
                    "rel": float(err.max() / mag.max()),
                    "ulps": float(ulps.max()),
                    "over": int((ulps > 0.5).sum()),
                    "outputs": out.numel()}
            rows.append(row)
            del exact, mag, spacing
    return {"tree": str(tree), "build_s": build_s, "card": card(), "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)],
                    help="source trees, each measured in its own process")
    ap.add_argument("--out", default=str(ROOT / "build" / "err_wino_bf16.json"),
                    help="where the readings are written, as JSON")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve())))
        return 0
    trees = []
    for i, t in enumerate(args.trees):
        tree = Path(t).resolve()
        r = subprocess.run([sys.executable, __file__, "--measure", str(tree)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        got = json.loads(r.stdout.strip().splitlines()[-1])
        trees.append(got)
        for row in got["rows"]:
            tiles = "; ".join(f"{k} rel {x['rel']:.3g} ulps {x['ulps']:.4f} over "
                              f"{x['over']} of {x['outputs']}"
                              for k, x in row["tiles"].items())
            print(f"tree {i} ({tree}) C {row['C']} T {row['T']} N {row['N']}: "
                  f"{tiles}", flush=True)
        print(f"tree {i}: build {got['build_s']:.1f} s  ({got['card']})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card(), "trees": trees}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
