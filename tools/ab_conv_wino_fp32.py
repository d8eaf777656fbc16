#!/usr/bin/env python3
"""A/B of the fp32 matmul, implicit-GEMM conv and Winograd point-GEMM
kernels (rows 1, 2, 3, 5 and 6 of PERF.md's table), two source trees on one
card, in turns.

    python3 tools/ab_conv_wino_fp32.py --trees build/parent . --order 0,1,1,0

Each turn runs in a process of its own that imports the tree's
``repro_torch`` (``<tree>/src``) and ``chip_smoke.py``, builds only its
fp32 matmul, conv and Winograd libraries (``matmul``, ``im2col_gemm`` and
``winograd`` of ``kernels/common.LIBRARIES``) into ``<tree>/build``,
records the launch
signatures of the passes ``chip_smoke.py`` times these rows on, and times
each pass as ``chip_smoke.check_and_time`` does (each signature's kernel
call through the tree's own ``kernel_table``, ``chip_smoke.time_ms``,
times its launches, summed over the pass):

- row 1 (``matmul``): one b=8 forward of edge_cnn / PBQP, served by
  ``chip_smoke.make_server``;
- rows 2 and 3 (``conv_im2col_batch``, ``winograd_point_gemm_batch``): one
  b=8 forward of resnet18 / mix, served likewise;
- row 5 (``conv_im2col``): phase 5's ``conv_im2col_op`` pass over
  resnet18's 20 convs on one image;
- row 6 (``winograd_point_gemm``): phase 5's F(2x2) ``winograd_conv_op``
  pass over resnet18's 13 3x3 stride-1 convs on one image.

The passes' inputs come from a fixed seed; each tree reads its own
signature format. Writes the turns in order, with the card's name and
power limit, to ``--out`` (default ``build/ab_conv_wino_fp32.json``) and
prints one line per turn. Needs a CUDA device and nvcc; exits non-zero
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
SEED = 0
ROWS = ("matmul", "conv_im2col_batch", "winograd_point_gemm_batch",
        "conv_im2col", "winograd_point_gemm")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def measure(tree: Path, reps: int) -> dict:
    """One turn, in this process, on ``tree``'s sources."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_conv_wino_fp32: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import common
    from repro_torch.models import cnn_zoo
    spec = importlib.util.spec_from_file_location("tree_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    for name in [n for n in common.LIBRARIES
                 if n not in ("matmul", "im2col_gemm", "winograd")]:
        del common.LIBRARIES[name]         # this turn times the fp32 kernels alone
    build_s = common.build_kernels()
    passes = {}
    server, nets, _ = smoke.make_server(
        torch, {"edge_cnn_pbqp": (cnn_zoo.get("edge_cnn"), None),
                "resnet18_mix": (cnn_zoo.get("resnet18"), smoke.kernel_mix_assignment)},
        SEED)
    for path, rows in (("edge_cnn_pbqp", ROWS[:1]), ("resnet18_mix", ROWS[1:3])):
        opt = nets[path]
        common.reset_launches()
        server.serve(path, list(smoke.images(np.random.default_rng(SEED), opt.spec, 8)))
        torch.cuda.synchronize()
        for k in rows:
            passes[k] = dict(common.SEEN[k])
    layers = smoke.conv_layers(cnn_zoo.get("resnet18"))
    wino = [l for l in layers if l[4] == 3 and l[5] == 1]
    for k, drive in (("conv_im2col", lambda r: smoke.drive_conv_im2col(torch, "cuda", r, layers)),
                     ("winograd_point_gemm",
                      lambda r: smoke.drive_winograd(torch, "cuda", r, wino, 2))):
        common.reset_launches()
        drive(np.random.default_rng(SEED))
        torch.cuda.synchronize()
        passes[k] = dict(common.SEEN[k])
    table = smoke.kernel_table(torch)
    out = {"tree": str(tree), "build_s": build_s, "rows": {}}
    for k in ROWS:
        assert passes[k], (k, "the pass launched no kernel")
        ms = sum(n * smoke.time_ms(torch, table[k]["ops"](sig)[0], reps)
                 for sig, n in passes[k].items())
        out["rows"][k] = {"ms": ms, "launches": sum(passes[k].values())}
    out["card"] = card()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="source trees, the parent first")
    ap.add_argument("--order", default="0,1,1,0", help="tree indices, in turn")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls a timing averages (chip_smoke.time_ms)")
    ap.add_argument("--out", default=str(ROOT / "build" / "ab_conv_wino_fp32.json"),
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
        rows = ", ".join(f"{k} {v['ms']:.4f} ms ({v['launches']})"
                         for k, v in turn["rows"].items())
        print(f"tree {i} ({tree}): {rows}; build {turn['build_s']:.1f} s  "
              f"({turn['card']})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card(), "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
