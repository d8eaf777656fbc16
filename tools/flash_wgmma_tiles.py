#!/usr/bin/env python3
"""The wgmma flash attention kernel tile by tile, on the card.

    python3 tools/flash_wgmma_tiles.py [--quick] [--out PATH]

1. ``nvcc -Xptxas -v`` on ``csrc/flash_wgmma.cu``: registers, spills and
   any ptxas note (C7514 "wgmma serialized" means an accumulator is read
   while a wgmma group is in flight).
2. Every instantiated tile (``flash_attention.WGMMA_TILES``, each under
   the schedule it fixes) against the plain version on bf16 q, k, v:
   causal and not, a ragged length, Sq != Sk both ways, GQA with rep 1, 2
   and 7, each output within one bf16 rounding of the fp32 result on the
   same values plus 1e-4 of its row's largest |result| (``chip_smoke.
   hold_bf16``), and each call against its repeat, bit for bit.
3. S = 4,096 at d = 128 and inputs x4 (the card test's long and large-score
   cases) under every d = 128 tile: held the same way, and the largest
   distance from a float64 result beside the plain version's and the
   mma.sync kernel's.
4. (Without ``--quick``.) At chatglm3_6b causal and full and internvl2_1b
   causal, S = 4,096, B = 1 (``chip_smoke.ATTENTION``, K and V with their
   KV heads): the mma.sync route's tile under ``fa-128x128``, then each
   wgmma tile twice, then the mma.sync tile again
   (``chip_smoke.time_ms``), beside the bound (bf16 peak) and SDPA on K and
   V repeated to the query heads.
5. (Without ``--quick``.) At the same shapes, each route (fp32 and bf16
   mma.sync under ``fa-128x128``'s tile, bf16 wgmma under its) with K and V
   read in place (``rep``) against the same kernel on K and V repeated to
   the query heads beforehand (rep 1), in turns: in place, repeated,
   repeated, in place.

Needs a CUDA device and nvcc; exits non-zero without one or on a mismatch.
Writes its numbers as JSON to ``--out`` (default ``build/flash_wgmma_tiles.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def ptxas_report(common) -> list:
    out = ROOT / "build" / "flash_wgmma_tiles"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run([common.nvcc_path(), *common.NVCC_FLAGS, "-Xptxas", "-v",
                        "-I", str(common.CSRC), "-o", str(out / "lib.so"),
                        str(common.CSRC / "flash_wgmma.cu")],
                       capture_output=True, text=True)
    print(f"nvcc -Xptxas -v: rc {r.returncode} in {time.perf_counter() - t0:.1f} s")
    lines = [line.strip()[:220] for line in (r.stdout + r.stderr).splitlines()
             if any(w in line for w in ("error", "C75", "registers", "spill",
                                        "Compiling entry", "warning"))]
    for line in lines:
        print("  " + line)
    if r.returncode:
        raise SystemExit(r.returncode)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="checks only, no timing")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build" / "flash_wgmma_tiles.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_wgmma_tiles: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention.flash_attention import (
        WGMMA_TILES, flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import cta_tile
    from repro_torch.kernels.flash_attention.ref import attention_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    report = {"card": smi, "ptxas": ptxas_report(common)}
    print(f"build: {common.build_kernels():.1f} s", flush=True)

    def wgmma(q, k, v, tile, causal, rep):
        """One launch of the wgmma kernel under ``tile``."""
        return flash_attention(q, k, v, causal=causal, bq=tile[0], bkv=tile[1],
                               rep=rep, force_route="wgmma")

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda") * scale).bfloat16()

    # 2: every tile on ragged shapes, GQA included
    torch.manual_seed(0)
    worst = 0.0
    for tile in WGMMA_TILES:
        d = tile[2]
        for bh, sq, sk, rep in [(3, 256, 256, 1), (4, 200, 200, 2), (14, 96, 160, 7),
                                (2, 160, 96, 1), (2, 64, 1, 1), (2, 1, 300, 2)]:
            q, k, v = rnd(bh, sq, d), rnd(bh // rep, sk, d), rnd(bh // rep, sk, d)
            for causal in (True, False):
                want = flash_attention_plain(q.float(), k.float(), v.float(),
                                             causal=causal, rep=rep)
                got = wgmma(q, k, v, tile, causal, rep)
                torch.cuda.synchronize()
                try:
                    err = smoke.hold_bf16(torch, got, want, 1e-4, rows=True)
                except AssertionError as e:
                    print(f"FAIL tile {tile} {(bh, sq, sk, rep)} causal {causal}: "
                          f"{e}", flush=True)
                    raise
                assert torch.equal(wgmma(q, k, v, tile, causal, rep), got)
                worst = max(worst, err)
        print(f"tile {tile}: held on every shape", flush=True)
    report["ragged_max_abs_err"] = worst

    # 3: long and large scores at d = 128, and the distance from float64
    report["long"] = {}
    for S, x in ((4096, 1.0), (300, 4.0)):
        for causal in (True, False):
            q, k, v = (rnd(1, S, 128, scale=x) for _ in range(3))
            want = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
            exact = flash_attention_plain(q.double(), k.double(), v.double(),
                                          causal=causal)
            plain = flash_attention_plain(q, k, v, causal=causal)
            ms = flash_attention(q, k, v, causal=causal, force_route="mma.sync")
            row = {"plain": float((plain.double() - exact).abs().max()),
                   "mma.sync": float((ms.double() - exact).abs().max())}
            for tile in (t for t in WGMMA_TILES if t[2] == 128):
                got = wgmma(q, k, v, tile, causal, 1)
                smoke.hold_bf16(torch, got, want, 1e-4, rows=True)
                row[f"{tile[0]}x{tile[1]}"] = float((got.double() - exact).abs().max())
            report["long"][f"S={S} x{x} causal={causal}"] = row
            print(f"S={S} x{x} causal={causal}: max |. - float64| " +
                  ", ".join(f"{key} {err:.3g}" for key, err in row.items()), flush=True)

    if not args.quick:
        # 4: the phase-5 shapes, in turns
        report["timed"] = {}
        for name, cfg in smoke.ATTENTION.items():
            H, Hkv, d, S, causal = (cfg[k] for k in ("heads", "kv_heads", "head_dim",
                                                     "seq", "causal"))
            rep = H // Hkv
            q, k, v = rnd(H, S, d), rnd(Hkv, S, d), rnd(Hkv, S, d)
            kr, vr = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
            pairs = S * (S + 1) // 2 if causal else S * S
            bound = max(4 * d * pairs * H / smoke.BF16_FLOPS,
                        2 * H * d * 2 * (S + S) / smoke.HBM_BYTES_S) * 1e3
            bq, bkv = cta_tile("fa-128x128", d, torch.bfloat16)

            def t_ms(f):
                return smoke.time_ms(torch, f, args.reps)

            ms_call = (lambda: flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv,
                                               rep=rep, force_route="mma.sync"))
            row = {"bound_ms": bound, "sdpa_ms": t_ms(
                lambda: attention_ref(q, kr, vr, causal=causal))}
            a = t_ms(ms_call)
            for tile in (t for t in WGMMA_TILES if t[2] == d):
                f = lambda tile=tile: wgmma(q, k, v, tile, causal, rep)
                row[f"wgmma {tile[0]}x{tile[1]}"] = [t_ms(f), t_ms(f)]
            b = t_ms(ms_call)
            row[f"mma.sync {bq}x{bkv}"] = [a, b]
            report["timed"][name] = row
            print(f"{name} (S={S}, BH={H}, rep {rep}, d={d}): bound {bound:.4f} ms, "
                  f"SDPA {row['sdpa_ms']:.4f} ms", flush=True)
            for key, val in row.items():
                if isinstance(val, list):
                    print(f"    {key}: {val[0]:.4f} / {val[1]:.4f} ms", flush=True)
    if not args.quick:
        # 5: K and V read in place against repeated to the query heads
        from repro_torch.kernels.flash_attention.ops import wgmma_tile
        report["rep"] = {}
        for name, cfg in smoke.ATTENTION.items():
            H, Hkv, d, S, causal = (cfg[k] for k in ("heads", "kv_heads", "head_dim",
                                                     "seq", "causal"))
            r = H // Hkv
            for dt, route in ((torch.float32, "mma.sync"), (torch.bfloat16, "mma.sync"),
                              (torch.bfloat16, "wgmma")):
                tile = (wgmma_tile("fa-128x128", d) if route == "wgmma"
                        else cta_tile("fa-128x128", d, dt))
                q = torch.randn(H, S, d, device="cuda").to(dt)
                k, v = (torch.randn(Hkv, S, d, device="cuda").to(dt) for _ in range(2))
                kr, vr = k.repeat_interleave(r, 0), v.repeat_interleave(r, 0)
                kw = dict(causal=causal, bq=tile[0], bkv=tile[1], force_route=route)
                inplace = lambda: flash_attention(q, k, v, rep=r, **kw)
                repeated = lambda: flash_attention(q, kr, vr, **kw)
                assert torch.equal(inplace(), repeated())
                runs = [smoke.time_ms(torch, f, args.reps)
                        for f in (inplace, repeated, repeated, inplace)]
                key = f"{name} {str(dt)[6:]} {route} {tile[0]}x{tile[1]}"
                report["rep"][key] = {"in_place": runs[::3], "repeated": runs[1:3]}
                print(f"{key}: in place / repeated / repeated / in place "
                      + " / ".join(f"{x:.4f}" for x in runs) + " ms", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"flash_wgmma_tiles: ok ({smi})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
