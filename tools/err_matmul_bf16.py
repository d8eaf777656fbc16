#!/usr/bin/env python3
"""Accuracy of the bf16 batched matmul's gathered wgmma kernel
(``csrc/matmul_wgmma.cu``'s ``matmul_gather_kernel``) on resnet18's 20
convs as per-image GEMMs, one or more source trees in turn on one card.

    python3 tools/err_matmul_bf16.py --trees build/other .

Each tree runs in a process of its own that imports the tree's
``repro_torch`` (``<tree>/src``) and builds only its ``matmul_wgmma``
library, into ``<tree>/build``. For each of resnet18's 20 convs at 224 x
224 (the shapes of ``chip_smoke.py``'s phase 5: the (M, C f f) weights
broadcast over b = 8, ``F.unfold``'s patches), numpy normals from a fixed
seed rounded once to bf16 (the same values in every tree) run on every
wgmma tile instantiated for the call's loaders (``matmul.wgmma_tiles``,
split by ``ops.wgmma_split``), no epilogue, bf16 output. Each output is
compared with the exact product of the same bf16 values (float64 on the
card):

- ``rel``: the largest |out - exact| over the largest |exact|;
- ``ulps``: the largest |out - exact| in units of the bf16 spacing at
  |exact| (one correct rounding is at most 0.5);
- ``over``: how many outputs lie more than half a spacing from the exact
  product, that is, what the fp32 sums' own rounding adds to the one bf16
  rounding at the store.

Prints one line per tree and layer, with the card's name and power limit,
and writes every reading to ``--out`` (default
``build/err_matmul_bf16.json``). Needs a CUDA device and nvcc; exits
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
BATCH = 8
# (C, H, K, f, s) of resnet18's 20 convs at 224 x 224 (chip_smoke.conv_layers)
RESNET18 = [(3, 224, 64, 7, 2), (64, 109, 64, 3, 1), (64, 107, 64, 3, 1),
            (64, 105, 64, 3, 1), (64, 103, 64, 3, 1), (64, 101, 128, 1, 2),
            (64, 101, 128, 3, 2), (128, 50, 128, 3, 1), (128, 48, 128, 3, 1),
            (128, 46, 128, 3, 1), (128, 44, 256, 1, 2), (128, 44, 256, 3, 2),
            (256, 21, 256, 3, 1), (256, 19, 256, 3, 1), (256, 17, 256, 3, 1),
            (256, 15, 512, 1, 2), (256, 15, 512, 3, 2), (512, 7, 512, 3, 1),
            (512, 5, 512, 3, 1), (512, 3, 512, 3, 1)]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def measure(tree: Path) -> dict:
    """One tree, in this process, on its own sources."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("err_matmul_bf16: no CUDA device")
    from repro_torch.kernels import common
    from repro_torch.kernels.matmul.matmul import (loaders, matmul_batch, packs,
                                                   wgmma_tiles)
    from repro_torch.kernels.matmul.ops import wgmma_split
    for name in [n for n in common.LIBRARIES if n != "matmul_wgmma"]:
        del common.LIBRARIES[name]
    build_s = common.build_kernels()
    rng = np.random.default_rng(SEED)

    def rnd(*shape, scale=1.0):
        x = (rng.standard_normal(shape, dtype=np.float32) * scale)
        return torch.from_numpy(x).cuda().bfloat16()

    rows = []
    for C, H, K, f, s in RESNET18:
        oh = (H - f) // s + 1
        M, Kd, N = K, C * f * f, oh * oh
        wm = rnd(M, Kd, scale=Kd ** -0.5)
        a, b = wm.expand(BATCH, M, Kd), F.unfold(rnd(BATCH, C, H, H), f, stride=s)
        exact = torch.matmul(wm.double(), b.double())
        mag = exact.abs()
        spacing = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -120))) - 7)
        how = loaders(a, b)
        cols, entries = (N * BATCH, 1) if packs(a, b, how) else (N, BATCH)
        row = {"M": M, "K": Kd, "N": N, "loaders": how, "tiles": {}}
        for bm, bn, st in wgmma_tiles(how):
            split = wgmma_split(-(-M // bm) * -(-cols // bn) * entries, Kd)
            out = matmul_batch(a, b, bm=bm, bn=bn, stages=st, split_k=split,
                               route="wgmma")
            err = (out.double() - exact).abs()
            ulps = err / spacing
            row["tiles"][f"{bm}x{bn} split {split}"] = {
                "rel": float(err.max() / mag.max()), "ulps": float(ulps.max()),
                "over": int((ulps > 0.5).sum()), "outputs": out.numel()}
        rows.append(row)
        del exact, mag, spacing
    return {"tree": str(tree), "build_s": build_s, "card": card(), "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)],
                    help="source trees, each measured in its own process")
    ap.add_argument("--out", default=str(ROOT / "build" / "err_matmul_bf16.json"),
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
            return r.returncode or 1
        got = json.loads(r.stdout.strip().splitlines()[-1])
        trees.append(got)
        for row in got["rows"]:
            tiles = "; ".join(f"{k} rel {x['rel']:.3g} ulps {x['ulps']:.4f} over "
                              f"{x['over']} of {x['outputs']}"
                              for k, x in row["tiles"].items())
            print(f"tree {i} ({tree}) M {row['M']} K {row['K']} N {row['N']} "
                  f"{row['loaders']}: {tiles}", flush=True)
        print(f"tree {i}: build {got['build_s']:.1f} s  ({got['card']})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card(), "trees": trees}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
