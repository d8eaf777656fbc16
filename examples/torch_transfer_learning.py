"""Transfer learning across platforms (paper §4.4/§5.3) on the PyTorch
port, through the service layer: pre-train on intel, port to arm with 1% of
the data — direct / factor-corrected / fine-tuned / from scratch — beside
arm's native model, and persist every trained model in an artifact store,
so a second invocation warm-starts instead of retraining (the port's
counterpart of ``examples/transfer_learning.py``).

The store is ``$REPRO_TORCH_ARTIFACTS``, else ``build/torch_artifacts``
(``build/`` is not committed): never ``artifacts/``, whose addresses the
port shares with the reference.

Run:  PYTHONPATH=src python examples/torch_transfer_learning.py            # the card
      PYTHONPATH=src python examples/torch_transfer_learning.py --device cpu
      (run it twice to see the warm-start)
"""
import argparse
import os
from typing import Optional

from repro_torch.service import ArtifactStore, PlatformModels, get_platform


def default_store() -> str:
    return os.environ.get("REPRO_TORCH_ARTIFACTS",
                          os.path.join("build", "torch_artifacts"))


def run(store_root: Optional[str] = None, *, device="cuda", max_triplets: int = 60,
        pretrain_iters: int = 4000, calibrate_iters: int = 2000,
        budget: float = 0.01, base: Optional[PlatformModels] = None) -> dict:
    """Every step printed as the reference prints it; returns each model's
    test MdRAE on arm (intel's on intel), warm flag and seconds. Models
    train on ``device`` (the store's). ``base`` replaces the intel
    pre-training (it is then not stored)."""
    store = ArtifactStore(store_root or default_store(), device=device)
    out = {"device": str(device), "store": store.root}

    def record(key, models, mdrae):
        out[key] = {"mdrae": mdrae, "warm": models.warm, "seconds": models.seconds}
        return f"({'warm' if models.warm else 'cold'}, {models.seconds:.2f}s)"

    print("== pre-training on intel ==")
    intel = get_platform("intel", max_triplets=max_triplets)
    if base is None:
        base = intel.pretrain("nn2", store=store, max_iters=pretrain_iters)
    _, _, te = intel.primitive_dataset().split()
    tag = record("intel", base, base.prim.mdrae(te.feats, te.times))
    print(f"   intel test MdRAE: {out['intel']['mdrae']*100:.1f}% {tag}")

    print("== porting to arm ==")
    arm = get_platform("arm", max_triplets=max_triplets)
    _, _, tea = arm.primitive_dataset().split()
    out["direct"] = {"mdrae": base.prim.mdrae(tea.feats, tea.times)}
    print(f"   intel model applied directly:   MdRAE {out['direct']['mdrae']*100:.0f}%")

    fc = arm.calibrate(base, budget, mode="factor", store=store)
    tag = record("factor", fc, fc.prim.mdrae(tea.feats, tea.times))
    print(f"   + per-primitive factor (1% data): MdRAE "
          f"{out['factor']['mdrae']*100:.1f}% {tag}")

    ft = arm.calibrate(base, budget, mode="finetune", store=store,
                       max_iters=calibrate_iters)
    tag = record("finetune", ft, ft.prim.mdrae(tea.feats, tea.times))
    print(f"   + fine-tuning      (1% data): MdRAE "
          f"{out['finetune']['mdrae']*100:.1f}% {tag}")

    scratch = arm.calibrate(base, budget, mode="scratch", store=store,
                            max_iters=calibrate_iters)
    tag = record("scratch", scratch, scratch.prim.mdrae(tea.feats, tea.times))
    print(f"   from scratch       (1% data): MdRAE "
          f"{out['scratch']['mdrae']*100:.1f}% {tag}")

    native = arm.pretrain("nn2", store=store, max_iters=pretrain_iters)
    tag = record("native", native, native.prim.mdrae(tea.feats, tea.times))
    print(f"   native (all data):            MdRAE "
          f"{out['native']['mdrae']*100:.1f}% {tag}")

    out["warm"] = all(m.warm for m in (base, fc, ft, scratch, native))
    out["n_models"] = len(store.entries("models"))
    print("== artifact store ==")
    print(f"   {out['n_models']} models under {store.root!r}; this run was "
          f"{'WARM (no training)' if out['warm'] else 'COLD (trained + stored)'}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--store", default=None,
                    help="artifact store root (default: $REPRO_TORCH_ARTIFACTS, "
                         "else build/torch_artifacts)")
    args = ap.parse_args(argv)
    return run(args.store, device=args.device)


if __name__ == "__main__":
    main()
