#!/usr/bin/env python3
"""Whether two source trees give bit-equal bf16 outputs on the calls a
change must leave alone, each tree in a process of its own on one card.

    python3 tools/same_outputs_bf16.py --trees build/parent .

The calls, on numpy normals from a fixed seed rounded once to bf16 (the
same values in every tree), each under the plan its tree's ``ops`` give
it:

- ``matmul_op`` at the 39 LM GEMM sites of the registered configs
  (``core/autotune.site_shapes``) with M cut to 256, under every matmul
  variant, and ``matmul_batch_op`` on resnet18's three aligned convs as
  GEMMs (conv8, conv12, down23: weights broadcast over b = 8, bias and
  residual, ReLU): operands TMA addresses whole (``csrc/matmul_wgmma.cu``'s
  first kernel);
- ``winograd_point_gemm`` (one image) and ``winograd_point_gemm_batch`` (b
  = 8) on resnet18's 13 F(2x2) point-GEMMs, as ``chip_smoke.py``'s phase 5
  routes them (``csrc/winograd_wgmma.cu`` where the route rule sends them).

Each tree builds only ``matmul_wgmma``, ``matmul_bf16``, ``winograd_wgmma``
and ``winograd_bf16`` into ``<tree>/build`` and reports a SHA-256 digest of
each output's bytes, its route and its plan. Prints, per call, whether
every tree's digest is the same, and a count, with the card's name and
power limit; writes every digest to ``--out`` (default
``build/same_outputs_bf16.json``). Needs a CUDA device and nvcc; exits
non-zero without one, and 1 where any digest differs.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
SITE_M = 256
BATCH = 8
# (C, H, K, f, s) of resnet18's aligned convs as GEMMs: conv8, conv12, down23
ALIGNED_CONVS = [(128, 50, 128, 3, 1), (128, 46, 128, 3, 1), (256, 15, 512, 1, 2)]
# (C, T) of resnet18's 13 3x3 stride-1 convs at F(2x2), K = C
WINO = [(64, 2916), (64, 2809), (64, 2704), (64, 2601), (128, 576), (128, 529),
        (128, 484), (256, 100), (256, 81), (256, 64), (512, 9), (512, 4), (512, 1)]


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
        raise SystemExit("same_outputs_bf16: no CUDA device")
    from repro_torch.configs import base as cb
    from repro_torch.core import autotune as AT
    from repro_torch.kernels import common
    from repro_torch.kernels.matmul.ops import VARIANTS, matmul_batch_op, matmul_op
    from repro_torch.kernels.matmul.ops import plan as mm_plan
    from repro_torch.kernels.winograd.ops import plan as wino_plan
    from repro_torch.kernels.winograd.winograd import (winograd_point_gemm,
                                                       winograd_point_gemm_batch)
    keep = ("matmul_wgmma", "matmul_bf16", "winograd_wgmma", "winograd_bf16")
    for name in [n for n in common.LIBRARIES if n not in keep]:
        del common.LIBRARIES[name]
    common.build_kernels()
    rng = np.random.default_rng(SEED)

    def rnd(*shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).cuda().bfloat16()

    def digest(t) -> str:
        torch.cuda.synchronize()
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()[:16]

    out = {}
    for m, k, n in sorted(AT.site_shapes(cb.all_assigned())):
        x, y = rnd(SITE_M, k, scale=k ** -0.5), rnd(k, n)
        for v in sorted(VARIANTS):
            p = mm_plan(x, y, v)
            out[f"site ({SITE_M}, {k}, {n}) {v}"] = (digest(matmul_op(x, y, v)),
                                                    p["route"], sorted(p.items()))
    for C, H, K, f, s in ALIGNED_CONVS:
        oh = (H - f) // s + 1
        w = rnd(K, C * f * f, scale=(C * f * f) ** -0.5)
        a, b = w.expand(BATCH, *w.shape), F.unfold(rnd(BATCH, C, H, H), f, stride=s)
        ep = dict(bias=rnd(K), residual=rnd(BATCH, K, oh * oh), relu=True)
        p = mm_plan(a, b, "mm-128x128x128")
        out[f"conv as GEMM ({K}, {C * f * f}, {oh * oh}) b={BATCH}"] = (
            digest(matmul_batch_op(a, b, **ep)), p["route"], sorted(p.items()))
    for C, T in WINO:
        u = rnd(16, C, C, scale=C ** -0.5)
        for n in (1, BATCH):
            v = rnd(16, C, T) if n == 1 else rnd(n, 16, C, T)
            p = wino_plan(u, v, "wino-128x128")
            call = winograd_point_gemm if n == 1 else winograd_point_gemm_batch
            out[f"point-GEMM C {C} T {T} n {n}"] = (digest(call(u, v, **p)),
                                                    p["route"], sorted(p.items()))
    return {"tree": str(tree), "card": card(), "calls": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)],
                    help="source trees, each run in its own process")
    ap.add_argument("--out", default=str(ROOT / "build" / "same_outputs_bf16.json"))
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve())))
        return 0
    trees = []
    for t in args.trees:
        r = subprocess.run([sys.executable, __file__, "--measure", str(Path(t).resolve())],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode or 1
        trees.append(json.loads(r.stdout.strip().splitlines()[-1]))
    differ = 0
    for call in trees[0]["calls"]:
        got = [tr["calls"].get(call) for tr in trees]
        same = all(g is not None and g[0] == got[0][0] for g in got)
        differ += not same
        print(f"{'same  ' if same else 'DIFFER'} {call}: "
              + " | ".join(f"{g[0]} {g[1]}" if g else "missing" for g in got))
    print(f"{len(trees[0]['calls']) - differ} of {len(trees[0]['calls'])} calls "
          f"bit-equal across {len(trees)} trees  ({trees[0]['card']})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(trees, indent=1))
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
