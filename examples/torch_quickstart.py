"""Quickstart on the PyTorch port: the paper's pipeline end to end through
the service layer (the port's counterpart of ``examples/quickstart.py``).

  1. a Platform profiles itself (simulated intel) and trains NN2 performance
     models on ``--device`` — one ``pretrain`` call,
  2. ``optimise`` PBQP-selects primitives for AlexNet from *predictions*,
  3. compare against selecting from measured (simulated ground-truth) costs.

Run:  PYTHONPATH=src python examples/torch_quickstart.py               # the card
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import time
from typing import Optional

from repro_torch.core.selection import build_pbqp, network_cost, select
from repro_torch.service import PlatformModels, get_platform, optimise


def run(*, device="cuda", max_triplets: int = 60, max_iters: int = 4000,
        dlt_max_iters: int = 2500, models: Optional[PlatformModels] = None) -> dict:
    """The three steps, printed as the reference prints them; returns their
    numbers. ``models`` skips the training (step 1 then only profiles)."""
    print(f"== 1. profiling + training (simulated intel platform, {device}) ==")
    intel = get_platform("intel", max_triplets=max_triplets)
    ds = intel.primitive_dataset()
    print(f"   {ds.n} layer configs x {len(ds.columns)} primitives")
    if models is None:
        models = intel.pretrain("nn2", max_iters=max_iters, dlt_kind="nn2",
                                dlt_max_iters=dlt_max_iters, device=device)
    _, _, te = ds.split()
    _, _, dte = intel.dlt_dataset().split()
    prim_mdrae = models.prim.mdrae(te.feats, te.times)
    dlt_mdrae = models.dlt.mdrae(dte.feats, dte.times)
    print(f"   primitive MdRAE: {prim_mdrae*100:.1f}%  "
          f"DLT MdRAE: {dlt_mdrae*100:.1f}%  ({models.seconds:.1f}s)")

    print("== 2. primitive selection from PREDICTED costs ==")
    t0 = time.perf_counter()
    opt = optimise("alexnet", intel, models=models, device=device)
    select_ms = (time.perf_counter() - t0) * 1e3
    print(f"   selection took {select_ms:.0f} ms "
          f"(optimal solve: {opt.selection.optimal})")
    for i, layer in enumerate(opt.spec.nodes):
        print(f"   {layer.name:18s} k={layer.k:4d} c={layer.c:4d} im={layer.im:3d} "
              f"-> {opt.assignment[i]}")

    print("== 3. quality vs selecting from measured costs ==")
    truth = intel.cost_provider()
    g_truth = build_pbqp(opt.spec, truth)
    c_model = network_cost(opt.spec, opt.assignment, graph=g_truth)
    c_truth = select(opt.spec, truth).solver_cost
    print(f"   measured-optimal: {c_truth*1e3:.3f} ms | model-selected: "
          f"{c_model*1e3:.3f} ms | increase {100*(c_model/c_truth-1):.2f}% "
          f"(paper: <= 1.1%)")
    return {"device": str(device), "n_configs": ds.n, "columns": list(ds.columns),
            "prim_mdrae": prim_mdrae, "dlt_mdrae": dlt_mdrae,
            "train_s": models.seconds, "select_ms": select_ms,
            "optimal": opt.selection.optimal, "assignment": dict(opt.assignment),
            "model_selected_s": c_model, "measured_optimal_s": c_truth}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
