#!/usr/bin/env python3
"""A/B of the bf16 matmul kernel at the LM GEMM sites, two source trees on
one card, in turns.

    python3 tools/ab_matmul_sites.py --trees build/parent . --order 0,1,1,0

Each turn runs in a process of its own that imports the tree's
``repro_torch`` (``<tree>/src``), builds its kernels into ``<tree>/build``
and times, on bf16 operands from a fixed seed:

- every ``mm-*`` variant at each of the 39 distinct sites of
  ``core/autotune.site_shapes`` through the tree's ``MeasuredCost`` (the
  cost the matmul-site autotune fits its model to: CUDA events around
  each eager call, so the wrapper's host time counts), and bf16
  ``torch.matmul`` at each site: the best variant's ms per site, and the
  seconds the 312 timings took; then the best variant and
  ``torch.matmul`` again as ``chip_smoke.py`` times a kernel (``graph_ms``:
  back-to-back calls replayed from a CUDA graph, no host time between);
- row 1's bf16 pass: one layer of chatglm3_6b's 5 sites, each under its
  best variant, through ``matmul_op``, each call timed as ``chip_smoke.py``
  times a kernel (``time_ms``: back-to-back calls replayed from a CUDA
  graph), summed over the layer, beside ``torch.matmul`` timed the same
  way.

Writes the turns in order, with the card's name and power limit, to
``--out`` (default ``build/ab_matmul_sites.json``) and prints one line per
turn. Needs a CUDA
device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
ARCH = "chatglm3_6b"


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def measure(tree: Path) -> dict:
    """One turn, in this process, on ``tree``'s sources."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_matmul_sites: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import base as cb
    from repro_torch.core import autotune as AT
    from repro_torch.kernels import common
    from repro_torch.kernels.matmul.ops import VARIANTS, matmul_op
    from repro_torch.profiler.device import time_callable
    spec = importlib.util.spec_from_file_location("tree_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    build_s = common.build_kernels()
    cost = AT.MeasuredCost("cuda", SEED)
    sites = AT.site_shapes(cb.all_assigned())
    t0 = time.perf_counter()
    times = {(m, k, n): {v: cost(m, k, n, v) for v in VARIANTS} for m, k, n in sites}
    timing_s = time.perf_counter() - t0
    out = {"tree": str(tree), "build_s": build_s, "timing_s": timing_s, "sites": []}
    for (m, k, n), row in times.items():
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(m, k, generator=g, device="cuda", dtype=torch.bfloat16)
        y = torch.randn(k, n, generator=g, device="cuda", dtype=torch.bfloat16)
        lib = time_callable(torch.matmul, x, y, repeats=AT.GEMM_REPEATS,
                            warmup=AT.GEMM_WARMUP, device="cuda").device
        best = min(row, key=row.get)
        out["sites"].append({
            "M": m, "K": k, "N": n, "variant": best, "ms": row[best] * 1e3,
            "torch_matmul_ms": lib * 1e3,
            "graph_ms": smoke.time_ms(torch, lambda: matmul_op(x, y, best), 20),
            "torch_matmul_graph_ms": smoke.time_ms(torch, lambda: torch.matmul(x, y), 20),
            "all_ms": {v: t * 1e3 for v, t in row.items()}})
        del x, y
    cfg = next(c for c in cb.all_assigned() if c.name == ARCH)
    layer, lib_layer = 0.0, 0.0
    for site, m, k, n in AT.matmul_sites(cfg):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(m, k, generator=g, device="cuda", dtype=torch.bfloat16)
        y = torch.randn(k, n, generator=g, device="cuda", dtype=torch.bfloat16)
        best = min(times[(m, k, n)], key=times[(m, k, n)].get)
        layer += smoke.time_ms(torch, lambda: matmul_op(x, y, best), 20)
        lib_layer += smoke.time_ms(torch, lambda: torch.matmul(x, y), 20)
        del x, y
    out["row1_pass_ms"] = layer
    out["row1_torch_matmul_ms"] = lib_layer
    out["card"] = card()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="source trees, the parent first")
    ap.add_argument("--order", default="0,1,1,0", help="tree indices, in turn")
    ap.add_argument("--out", default=str(ROOT / "build" / "ab_matmul_sites.json"),
                    help="where the turns are written, as JSON")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve())))
        return 0
    turns = []
    for i in (int(t) for t in args.order.split(",")):
        tree = Path(args.trees[i]).resolve()
        r = subprocess.run([sys.executable, __file__, "--measure", str(tree)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        turn = json.loads(r.stdout.strip().splitlines()[-1])
        turn["index"] = i
        turns.append(turn)
        ratio = [s["ms"] / s["torch_matmul_ms"] for s in turn["sites"]]
        print(f"tree {i} ({tree}): row 1 pass {turn['row1_pass_ms']:.4f} ms "
              f"(torch.matmul {turn['row1_torch_matmul_ms']:.4f}); best variant "
              f"{min(ratio):.2f}-{max(ratio):.2f}x torch.matmul over "
              f"{len(ratio)} sites; timing {turn['timing_s']:.1f} s, build "
              f"{turn['build_s']:.1f} s  ({turn['card']})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card(), "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
