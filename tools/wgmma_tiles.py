#!/usr/bin/env python3
"""The wgmma matmul kernel tile by tile, on the card.

    python3 tools/wgmma_tiles.py

1. ``nvcc -Xptxas -v`` on ``csrc/matmul_wgmma.cu``: registers, spills and
   any ptxas note (C7514 "wgmma serialized" means an accumulator is read
   while a wgmma group is in flight).
2. Every instantiated tile (``matmul.WGMMA_TILES``) against the plain
   version on ragged aligned shapes, unsplit and split, bias, residual and
   ReLU, fp32 output at 1e-4 of the largest |plain| and bf16 within one
   rounding; the batched kernel with either operand broadcast.
3. Each tile's time at chatglm3_6b's five GEMM sites and (65,536, 128, 896)
   beside bf16 ``torch.matmul`` and the best mma.sync plan (CUDA events
   around each call, ``profiler.device.time_callable``).
4. The longest K of the LM sites, (65,536, 16,384, 1,024), for a 128 x 256
   tile (no promotion) and a 128 x 128 tile (promotion): the fp32 output's
   largest error over the largest |plain|, and the bf16 output's excess
   over one rounding.

Needs a CUDA device and nvcc; exits non-zero without one or on a mismatch.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SITES = [(65536, 4096, 256), (65536, 4096, 128), (65536, 256, 4096),
         (65536, 4096, 856), (65536, 856, 4096), (65536, 128, 896)]
TIMED = [(128, 256, 4), (128, 256, 3), (128, 128, 4), (64, 256, 4), (64, 128, 8),
         (64, 128, 4)]


def ptxas_report(common) -> None:
    out = ROOT / "build" / "wgmma_tiles"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run([common.nvcc_path(), *common.NVCC_FLAGS, "-Xptxas", "-v",
                        "-I", str(common.CSRC), "-o", str(out / "lib.so"),
                        str(common.CSRC / "matmul_wgmma.cu")],
                       capture_output=True, text=True)
    print(f"nvcc -Xptxas -v: rc {r.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in (r.stdout + r.stderr).splitlines():
        if any(w in line for w in ("error", "C75", "registers", "spill")):
            print("  " + line.strip()[:200])
    if r.returncode:
        raise SystemExit(r.returncode)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wgmma_tiles: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import common
    from repro_torch.kernels.matmul.matmul import (WGMMA_TILES, matmul, matmul_batch,
                                                   matmul_batch_plain, matmul_plain)
    from repro_torch.kernels.matmul.ops import cta_plan
    from repro_torch.profiler.device import time_callable
    torch.backends.cuda.matmul.allow_tf32 = False
    ptxas_report(common)
    common.build_kernels()
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

    def ms(fn):
        return time_callable(fn, repeats=10, warmup=2, device="cuda").device * 1e3

    fails = 0

    def check(tag, got, want):
        nonlocal fails
        err = float((got.float() - want).abs().max())
        top = float(want.abs().max())
        ok = err <= 1e-4 * top + (2 ** -8 * top if got.dtype == torch.bfloat16 else 0)
        fails += not ok
        print(f"{'ok  ' if ok else 'FAIL'} {tag}: max err {err:.3g} (max |want| {top:.3g})")

    for bm, bn, st in WGMMA_TILES:
        for M, K, N in [(200, 264, 136), (72, 1032, 392), (330, 200, 264)]:
            a, b = rnd(M, K, scale=K ** -0.5), rnd(K, N)
            ep = dict(bias=rnd(M), residual=torch.randn(M, N, generator=g, device="cuda"),
                      relu=True)
            want = matmul_plain(a, b, out_dtype=torch.float32, **ep)
            steps = -(-K // 64)
            for split in (s for s in (1, 3) if s == 1 or (s - 1) * -(-steps // s) < steps):
                plan = dict(bm=bm, bn=bn, stages=st, split_k=split, route="wgmma")
                tag = f"tile {bm}x{bn}x{st} {M},{K},{N} split {split}"
                check(tag, matmul(a, b, out_dtype=torch.float32, **plan, **ep), want)
                check(tag + " bf16 out", matmul(a, b, **plan, **ep), want)
    for xb, yb in ((True, False), (False, True), (False, False)):
        B, M, K, N = 3, 128, 576, 784
        a = rnd(M, K, scale=K ** -0.5).expand(B, M, K) if xb else rnd(B, M, K, scale=K ** -0.5)
        b = rnd(K, N).expand(B, K, N) if yb else rnd(B, K, N)
        want = matmul_batch_plain(a, b, out_dtype=torch.float32)
        for bm, bn in ((128, 128), (128, 256), (64, 256)):
            check(f"batch {bm}x{bn} x_bcast={xb} y_bcast={yb}",
                  matmul_batch(a, b, bm=bm, bn=bn, stages=4, route="wgmma",
                               out_dtype=torch.float32), want)
    print(f"fails: {fails}", flush=True)

    for M, K, N in SITES:
        a, b = rnd(M, K), rnd(K, N)
        lib = ms(lambda: torch.matmul(a, b))
        row = {f"{bm}x{bn}x{st}": ms(lambda: matmul(a, b, bm=bm, bn=bn, stages=st,
                                                     route="wgmma"))
               for bm, bn, st in TIMED}
        mma = min(ms(lambda: matmul(a, b, bm=p[0], bk=p[2], bn=p[1], split_k=p[3]))
                  for p in {cta_plan(M, N, K, 1, v, torch.bfloat16)
                            for v in ("mm-256x256x256", "mm-256x128x256")})
        fl = 2 * M * K * N
        print(f"site {M},{K},{N}: torch {lib:.4f} ms ({fl / lib / 1e9:.1f} TF/s); "
              f"mma.sync {mma:.4f}; " + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"; best wgmma {fl / min(row.values()) / 1e9:.1f} TF/s", flush=True)
        del a, b

    M, K, N = 65536, 16384, 1024
    a, b = rnd(M, K), rnd(K, N)
    want = a.float() @ b.float()
    top = float(want.abs().max())
    for bm, bn, st in [(128, 256, 4), (128, 128, 4)]:
        plan = dict(bm=bm, bn=bn, stages=st, route="wgmma")
        rel = float((matmul(a, b, out_dtype=torch.float32, **plan) - want).abs().max()) / top
        excess = float(((matmul(a, b, **plan).float() - want).abs()
                        - (2 ** -8 * want.abs() + 1e-4 * top)).max())
        print(f"K=16384 {bm}x{bn}x{st}: fp32 rel {rel:.3g} (limit 1e-4), bf16 excess "
              f"{excess:.3g} (<= 0); {ms(lambda: matmul(a, b, **plan)):.4f} ms, torch "
              f"{ms(lambda: torch.matmul(a, b)):.4f}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
