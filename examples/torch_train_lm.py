"""LM training driver on the PyTorch port over the assigned architectures —
the training-substrate demo: any --arch from the pool, synthetic data,
AdamW/Adafactor, checkpoint/resume, loss curve (the port's counterpart of
``examples/train_lm.py``).

One divergence from the reference's script: batch ``step`` is
``data.lm.make_batch`` of the step index, as both packages' training
launchers take it, so a resumed run sees the batches an uninterrupted run
would. The reference's script draws ``synthetic_batches(seed=start)``
afresh on every start, so after a resume it trains on another stream.

Checkpoints go to ``--ckpt-dir``, default ``$REPRO_TORCH_ARTIFACTS/ckpt_example``,
else ``build/torch_artifacts/ckpt_example`` (``build/`` is not committed).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --arch mixtral_8x7b --steps 50
      PYTHONPATH=src python examples/torch_train_lm.py --device cpu
(reduced config by default; --full uses the registered config, which one
card holds only for the smaller archs: see ``python -m
repro_torch.launch.dryrun --all``).
"""
import argparse
import os
import time
from typing import Optional

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import base as cb
from repro_torch.data.lm import make_batch
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T


def default_ckpt_dir() -> str:
    root = os.environ.get("REPRO_TORCH_ARTIFACTS", os.path.join("build", "torch_artifacts"))
    return os.path.join(root, "ckpt_example")


def run(arch: str = "chatglm3_6b", steps: int = 50, batch: int = 8, seq: int = 64,
        ckpt_dir: Optional[str] = None, full: bool = False, device="cuda",
        params: Optional[T.Params] = None) -> dict:
    """Train ``arch`` (reduced unless ``full``) up to step ``steps`` on
    ``device``, resuming from ``ckpt_dir``'s latest checkpoint; a checkpoint
    every 25 steps and at the end. Parameters start from ``init_params`` of
    a generator seeded 0 on ``device``, or from ``params``. Returns the
    step resumed from, each step's loss and the last parameters."""
    cfg = cb.get(arch)
    if not full:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M device={device}")

    if params is None:
        params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    _, opt = ST.optimizer_for(cfg)
    opt_state = opt.init(params)
    mgr = CheckpointManager(ckpt_dir or default_ckpt_dir(), keep=2)

    start, restored = mgr.restore_latest((params, opt_state), device=device)
    if start is not None:
        params, opt_state = restored
        print(f"resumed from step {start}")
    start = start or 0

    step_fn = ST.make_train_step(cfg, opt)
    losses = []
    t0 = time.time()
    for step in range(start + 1, steps + 1):
        params, opt_state, loss = step_fn(params, opt_state,
                                          make_batch(cfg, batch, seq, step, device=device))
        losses.append(float(loss))
        if step % 10 == 0 or step == start + 1:
            print(f"step {step:4d} loss {losses[-1]:.4f} ({(time.time()-t0):.1f}s)")
        if step % 25 == 0:
            mgr.save(step, (params, opt_state))
            print(f"   checkpointed step {step}")
    if steps > start and steps % 25:
        mgr.save(steps, (params, opt_state))
    print("done.")
    return {"arch": cfg.name, "start": start, "losses": losses,
            "seconds": time.time() - t0, "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="chatglm3_6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
               args.full, args.device)


if __name__ == "__main__":
    main()
