"""LM training launcher: the port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch chatglm3_6b --steps 20
    python -m repro_torch.launch.train --arch chatglm3_6b --device cpu

It runs the reference's fault-tolerant loop on one device:
  * resume from the latest valid checkpoint on start;
  * atomic step-tagged checkpoints every ``--ckpt-every`` steps and at the
    end, under ``<ckpt-dir>/<config name>``;
  * stateless data (``data.lm.make_batch`` of the step index), so a restart
    neither replays nor skips a batch;
  * a log line at the first step and every tenth, and a straggler watchdog
    (a step over ``--straggler-factor`` x the trailing median is logged).

``--smoke`` (the default) runs the reduced config at ``--batch`` x
``--seq``; ``--full`` the registered config at the ``--shape`` cell. Each
step is timed on the host clock up to a device sync (the reference's
``block_until_ready``). ``train_loop`` is the loop itself; ``main`` calls it,
and so may a caller with any config, batch and initial parameters.

One divergence: the end-of-run checkpoint is not written again when the
last step was just saved, and it records the last loss in its manifest's
``extra`` (the reference rewrites the last step with an empty ``extra``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import base as cb
from repro_torch.data.lm import make_batch
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T


@dataclasses.dataclass
class TrainRun:
    start: int                        # the step resumed from (0: a fresh start)
    steps: List[int]                  # the steps this run took
    losses: List[float]               # each step's loss
    step_ms: List[float]              # host clock, up to a device sync
    stragglers: List[int]             # steps the watchdog flagged
    params: Optional[T.Params] = None  # after the last step
    opt_state: Optional[dict] = None


def train_loop(cfg: cb.ArchConfig, batch: int, seq: int, steps: int, *,
               ckpt_dir: Optional[str], ckpt_every: int = 25,
               straggler_factor: float = 3.0, device="cuda",
               params: Optional[T.Params] = None, seed: int = 0,
               log: Callable[[str], None] = print) -> TrainRun:
    """Train ``cfg`` up to step ``steps`` on ``device`` with the optimizer
    ``steps.optimizer_for`` names. ``params`` default to ``init_params`` from
    a ``seed``-ed generator on ``device``. With a ``ckpt_dir`` the run
    resumes from its latest checkpoint and saves every ``ckpt_every`` steps
    and at the end; ``ckpt_dir=None`` keeps no checkpoints."""
    device = torch.device(device)
    if params is None:
        params = T.init_params(torch.Generator(device=device).manual_seed(seed), cfg)
    _, opt = ST.optimizer_for(cfg)
    opt_state = opt.init(params)
    mgr = CheckpointManager(f"{ckpt_dir}/{cfg.name}", keep=3) if ckpt_dir else None
    start = None
    if mgr is not None:
        start, restored = mgr.restore_latest((params, opt_state), device=device)
        if start is not None:
            params, opt_state = restored
            log(f"[train] resumed from step {start}")
    start = start or 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step_fn = ST.make_train_step(cfg, opt)
    run = TrainRun(start, [], [], [], [])
    last_saved = None
    for step in range(start + 1, steps + 1):
        b = make_batch(cfg, batch, seq, step, device=device)
        sync()
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, b)
        sync()
        dt = time.perf_counter() - t0
        loss = float(loss)
        if len(run.step_ms) >= 5:
            med = float(np.median(run.step_ms[-20:])) / 1e3
            if dt > straggler_factor * med:
                run.stragglers.append(step)
                log(f"[train] STRAGGLER step {step}: {dt:.2f}s vs median {med:.2f}s")
        run.steps.append(step)
        run.losses.append(loss)
        run.step_ms.append(dt * 1e3)
        if step % 10 == 0 or step == start + 1:
            log(f"[train] step {step:5d} loss {loss:.4f} {dt*1e3:.0f}ms")
        if mgr is not None and step % ckpt_every == 0:
            path = mgr.save(step, (params, opt_state), extra={"loss": loss})
            last_saved = step
            log(f"[train] checkpoint -> {path}")
    if mgr is not None and last_saved != steps:
        mgr.save(steps, (params, opt_state),
                 extra={"loss": run.losses[-1]} if run.losses else None)
    run.params, run.opt_state = params, opt_state
    log("[train] done")
    return run


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cb.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
        batch, seq = args.batch, args.seq
    else:
        from repro_torch.launch.shapes import SHAPES
        cell = SHAPES[args.shape]
        batch, seq = cell.global_batch, cell.seq_len
    return train_loop(cfg, batch, seq, args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      straggler_factor=args.straggler_factor, device=args.device)


if __name__ == "__main__":
    main()
