"""Single-card dry run: what one (arch x shape) cell's step holds, set
against one card's memory. The one-card counterpart of the ``memory`` and
``n_params`` fields of ``repro.launch.dryrun.run_cell``.

    python -m repro_torch.launch.dryrun --all            # every cell, a table
    python -m repro_torch.launch.dryrun --arch chatglm3_6b --shape train_4k

Per cell, from ``meta`` tensors (nothing is allocated, on the card or the
host): the parameters (``transformer.param_shapes``), the optimiser state of
a train cell (``steps.optimizer_for``'s ``init`` on those parameters), the
decode cache and the inputs (``shapes.input_specs``). Their sum is the
step's argument bytes (the reference's ``memory.argument_bytes``), set
against the card's memory (``torch.cuda.get_device_properties`` when a card
is present, else ``CARD_BYTES``, an H100's 80 GB) with the largest part of
the global batch whose arguments fit beside the parameters and optimiser
state. Activations, gradients and temporaries are not estimated, so a cell
that fits here may still not run. Each cell's JSON artifact goes to
``--out`` (default ``build/dryrun``), ``<arch>.<shape>.json``.

Not ported: the reference's mesh (``mesh.py``, a 256/512-chip TPU mesh), its
sharding trees (``steps.make_aspec``, ``make_opt_shardings``, ``bind_cell``)
and its compiled-HLO roofline (``repro.dist.hloanalysis``). One card has no
mesh, and the reference cannot import any of these (``repro.dist`` is
absent), so nothing could hold a port to them.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import torch

from repro_torch.configs import base as cb
from repro_torch.launch import steps as ST
from repro_torch.launch.shapes import SHAPES, cell_applicable, input_specs
from repro_torch.models import transformer as T

CARD_BYTES = 80 * 10 ** 9        # an H100's memory, without a card to ask
NOT_ESTIMATED = "activations, gradients and temporaries"


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list tree (other leaves,
    such as an optimiser's host step counter, count 0)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def card_bytes() -> int:
    """The card's memory, or ``CARD_BYTES`` without a card."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return CARD_BYTES


def run_cell(arch: str, shape: str, out_dir: Optional[str] = None,
             card: Optional[int] = None) -> Dict:
    """The cell's memory record (written to ``out_dir`` when given): status
    ``ok`` or ``skipped``, ``step_kind``, ``n_params`` (the config's count,
    as the reference reports it) and ``memory`` in bytes, against ``card``
    bytes (default ``card_bytes()``)."""
    cfg = cb.get(arch)
    if not cell_applicable(cfg, shape):
        result = {"arch": arch, "shape": shape, "status": "skipped",
                  "reason": "full attention: no long-decode"}
    else:
        result = _measure(cfg, shape, card_bytes() if card is None else card)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}.{shape}.json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def _measure(cfg: cb.ArchConfig, shape: str, card: int) -> Dict:
    cell = SHAPES[shape]
    params = T.param_shapes(cfg)
    opt_name, opt_bytes = None, 0
    if cell.step == "train":
        opt_name, opt = ST.optimizer_for(cfg)
        opt_bytes = tree_bytes(opt.init(params))
    specs = input_specs(cfg, shape)
    cache_bytes = tree_bytes(specs.pop("cache", {}))
    input_bytes = tree_bytes(specs)
    param_bytes = tree_bytes(params)
    fixed = param_bytes + opt_bytes
    per_sequence = (cache_bytes + input_bytes) / cell.global_batch
    fit = max(0, min(cell.global_batch, int((card - fixed) // per_sequence)))
    return {
        "arch": cfg.name, "shape": shape, "status": "ok", "n_chips": 1,
        "step_kind": cell.step, "seq_len": cell.seq_len,
        "global_batch": cell.global_batch, "optimizer": opt_name,
        "param_dtype": str(cfg.param_dtype).replace("torch.", ""),
        "n_params": cfg.n_params(),
        "memory": {
            "argument_bytes": fixed + cache_bytes + input_bytes,
            "param_bytes": param_bytes, "opt_state_bytes": opt_bytes,
            "cache_bytes": cache_bytes, "input_bytes": input_bytes,
            "card_bytes": card, "fits": fixed + cache_bytes + input_bytes <= card,
            "batch_fit": fit, "batch_share": fit / cell.global_batch,
            "not_estimated": NOT_ESTIMATED,
        },
    }


def table_row(r: Dict) -> str:
    """One line of the memory table."""
    if r["status"] != "ok":
        return f"{r['arch']:20s} {r['shape']:12s} skipped ({r['reason']})"
    m = r["memory"]
    gb = lambda b: f"{b / 1e9:9.2f}"
    return (f"{r['arch']:20s} {r['shape']:12s} {r['step_kind']:7s}"
            f"{gb(m['param_bytes'])}{gb(m['opt_state_bytes'])}{gb(m['cache_bytes'])}"
            f"{gb(m['input_bytes'])}{gb(m['argument_bytes'])}  "
            f"{'yes' if m['fits'] else 'no ':3s} {m['batch_fit']:4d}/{r['global_batch']}")


TABLE_HEAD = (f"{'arch':20s} {'shape':12s} {'step':7s}{'params':>9s}{'opt':>9s}"
              f"{'cache':>9s}{'inputs':>9s}{'args GB':>9s}  fits batch")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell of the registered configs")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in cb.ASSIGNED_ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    card = card_bytes()
    print(f"card memory {card / 1e9:.2f} GB; GB below are 1e9 bytes; not "
          f"estimated: {NOT_ESTIMATED}")
    print(TABLE_HEAD)
    for arch, shape in cells:
        print(table_row(run_cell(arch, shape, args.out, card)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
