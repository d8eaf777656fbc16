#!/usr/bin/env python3
"""A/B of the fp32 flash attention kernel at phase 5's shapes, two source
trees on one card, in turns.

    python3 tools/ab_flash_fp32.py --trees build/parent . --order 0,1,1,0

Each turn runs in a process of its own that imports the tree's
``repro_torch`` (``<tree>/src``), builds only its fp32 flash attention
library (``flash_attention`` of ``kernels/common.LIBRARIES``) into
``<tree>/build`` and times, at each of ``chip_smoke.ATTENTION``'s shapes
(chatglm3_6b causal and full, internvl2_1b causal; S = 4,096, B = 1) on
fp32 q, k, v from a fixed seed, the kernel under ``fa-128x128``'s tile
(the tile phase 5 and the LM prefill run) as ``chip_smoke.py`` times a
kernel (``chip_smoke.time_ms``):

- ``repeated``: K and V repeated to the query heads beforehand, the only
  call a tree whose ``flash_attention`` has no ``rep`` takes;
- ``in_place`` (trees with ``rep``): K and V at their KV heads, read in
  place, as such a tree's phase 5 runs it.

The outputs of both calls must agree bit for bit within a turn. Writes the
turns in order, with the card's name and power limit, to ``--out``
(default ``build/ab_flash_fp32.json``) and prints one line per turn and
shape. Needs a CUDA device and nvcc; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
VARIANT = "fa-128x128"


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def measure(tree: Path, reps: int) -> dict:
    """One turn, in this process, on ``tree``'s sources."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash_fp32: no CUDA device")
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import cta_tile
    spec = importlib.util.spec_from_file_location("tree_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    for name in [n for n in common.LIBRARIES if n != "flash_attention"]:
        del common.LIBRARIES[name]         # this turn times the fp32 kernel alone
    build_s = common.build_kernels()
    has_rep = "rep" in inspect.signature(flash_attention).parameters
    out = {"tree": str(tree), "build_s": build_s, "has_rep": has_rep, "shapes": {}}
    for name, cfg in smoke.ATTENTION.items():
        H, Hkv, d, S, causal = (cfg[k] for k in ("heads", "kv_heads", "head_dim",
                                                 "seq", "causal"))
        rep = H // Hkv
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q = torch.randn(H, S, d, generator=g, device="cuda")
        k, v = (torch.randn(Hkv, S, d, generator=g, device="cuda") for _ in range(2))
        kr, vr = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
        bq, bkv = cta_tile(VARIANT, d)
        kw = dict(causal=causal, bq=bq, bkv=bkv)
        calls = {"repeated": lambda: flash_attention(q, kr, vr, **kw)}
        if has_rep:
            calls["in_place"] = lambda: flash_attention(q, k, v, rep=rep, **kw)
        outs = [f() for f in calls.values()]
        assert all(torch.equal(o, outs[0]) for o in outs), name
        out["shapes"][name] = {"tile": [bq, bkv], "rep": rep,
                               **{c: smoke.time_ms(torch, f, reps)
                                  for c, f in calls.items()}}
        del q, k, v, kr, vr, outs
    out["card"] = card()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="source trees, the parent first")
    ap.add_argument("--order", default="0,1,1,0", help="tree indices, in turn")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls a timing averages (chip_smoke.time_ms)")
    ap.add_argument("--out", default=str(ROOT / "build" / "ab_flash_fp32.json"),
                    help="where the turns are written, as JSON")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve(), args.reps)))
        return 0
    turns = []
    for i in (int(t) for t in args.order.split(",")):
        tree = Path(args.trees[i]).resolve()
        r = subprocess.run([sys.executable, __file__, "--measure", str(tree),
                            "--reps", str(args.reps)], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        turn = json.loads(r.stdout.strip().splitlines()[-1])
        turn["index"] = i
        turns.append(turn)
        for name, row in turn["shapes"].items():
            times = ", ".join(f"{c} {row[c]:.4f} ms" for c in ("repeated", "in_place")
                              if c in row)
            print(f"tree {i} ({tree}) {name} tile {row['tile']}: {times}; build "
                  f"{turn['build_s']:.1f} s  ({turn['card']})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card(), "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
