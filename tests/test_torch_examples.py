"""The port's example scripts (``examples/torch_*.py``) against the
reference on the CPU, each through its ``run`` function at reduced
iteration counts.

- quickstart and transfer learning with the reference's trained NN2s
  carried over (``convert.perfmodel_from_state``): the same dataset sizes
  and columns, the same AlexNet assignment, the same truth-optimal cost at
  1e-6, MdRAEs at 1e-4 (a fine-tune follows the reference's trajectory, as
  ``tests/test_torch_training.py`` holds it);
- both trained cold: each MdRAE within 1.5x + 0.02 of the reference's
  (the band of ``test_torch_training.py::test_nn2_cold_fit_within_band_of_reference``:
  cold fits start from different random draws);
- transfer learning run twice into one store: the second run is warm for
  all five models;
- train_lm: losses equal to ``launch.train.train_loop``'s on the same
  reduced config and seed, a resumed run equal to an uninterrupted one,
  and from the reference's parameters its losses within 1e-4 of the
  reference's train step over the same batches;
- serve_optimized_cnn on the CPU (``device="cpu"``, a few requests),
  every served response held to the interpreted executor at 1e-3; its
  full run is a ``gpu`` test in ``tests/test_torch_gpu.py``.

Every store and checkpoint lives in ``tmp_path``.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core.selection import build_pbqp as jbuild_pbqp, network_cost as jnetwork_cost
from repro.core.selection import select as jselect
from repro.data import lm as jlm
from repro.service import artifacts as JA
from repro.service import pipeline as JPL
from repro.service import platforms as JPF
from repro_torch import convert
from repro_torch.launch import train
from repro_torch.primitives.conv import split_tile
from repro_torch.primitives.executor import execute
from repro_torch.primitives.plan import sink_nodes
from repro_torch.service import platforms as TPF
from test_torch_lm_train import _model, _port_params, ref_launch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MDRAE_RTOL = 1e-4
COST_RTOL = 1e-6
SMALL = dict(max_triplets=12)
ITERS = dict(max_iters=300, dlt_max_iters=200)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carried(jmodels):
    return TPF.PlatformModels(convert.perfmodel_from_state(jmodels.prim.to_state(), "cpu"),
                              convert.perfmodel_from_state(jmodels.dlt.to_state(), "cpu"),
                              jmodels.platform, jmodels.mode)


def _in_band(got, want):
    assert got <= 1.5 * want + 0.02, (got, want)


def _reference_quickstart(models, intel):
    """The reference script's numbers (``examples/quickstart.py``)."""
    ds = intel.primitive_dataset()
    _, _, te = ds.split()
    _, _, dte = intel.dlt_dataset().split()
    opt = JPL.optimise("alexnet", intel, models=models)
    truth = intel.cost_provider()
    return {"n_configs": ds.n, "columns": list(ds.columns),
            "prim_mdrae": models.prim.mdrae(te.feats, te.times),
            "dlt_mdrae": models.dlt.mdrae(dte.feats, dte.times),
            "assignment": dict(opt.assignment),
            "model_selected_s": jnetwork_cost(opt.spec, opt.assignment,
                                              graph=jbuild_pbqp(opt.spec, truth)),
            "measured_optimal_s": jselect(opt.spec, truth).solver_cost}


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_quickstart():
    """The reference's intel models (trained cold) and its script's numbers."""
    intel = JPF.get_platform("intel", **SMALL)
    jm = intel.pretrain("nn2", dlt_kind="nn2", **ITERS)
    return jm, _reference_quickstart(jm, intel)


def test_quickstart_with_the_reference_models(reference_quickstart):
    jm, want = reference_quickstart
    got = _example("quickstart").run(device="cpu", models=_carried(jm), **SMALL)
    assert got["n_configs"] == want["n_configs"] and got["columns"] == want["columns"]
    assert got["assignment"] == want["assignment"]
    for key in ("measured_optimal_s", "model_selected_s"):
        np.testing.assert_allclose(got[key], want[key], rtol=COST_RTOL)
    for key in ("prim_mdrae", "dlt_mdrae"):
        np.testing.assert_allclose(got[key], want[key], rtol=MDRAE_RTOL)


def test_quickstart_cold_within_band_of_reference(reference_quickstart):
    want = reference_quickstart[1]
    got = _example("quickstart").run(device="cpu", **SMALL, **ITERS)
    assert got["device"] == "cpu" and got["n_configs"] == want["n_configs"]
    _in_band(got["prim_mdrae"], want["prim_mdrae"])
    _in_band(got["dlt_mdrae"], want["dlt_mdrae"])
    np.testing.assert_allclose(got["measured_optimal_s"], want["measured_optimal_s"],
                               rtol=COST_RTOL)
    assert got["model_selected_s"] >= got["measured_optimal_s"] * (1 - COST_RTOL)


# ---------------------------------------------------------------------------
# transfer learning
# ---------------------------------------------------------------------------

TRANSFER = dict(pretrain_iters=300, calibrate_iters=200)


def _reference_transfer(store_root):
    """The reference script's MdRAEs (``examples/transfer_learning.py``)."""
    store = JA.ArtifactStore(str(store_root))
    intel = JPF.get_platform("intel", **SMALL)
    base = intel.pretrain("nn2", store=store, max_iters=300)
    _, _, te = intel.primitive_dataset().split()
    arm = JPF.get_platform("arm", **SMALL)
    _, _, tea = arm.primitive_dataset().split()
    m = lambda models: models.prim.mdrae(tea.feats, tea.times)
    kw = dict(store=store, max_iters=200)
    return base, {
        "intel": base.prim.mdrae(te.feats, te.times), "direct": m(base),
        "factor": m(arm.calibrate(base, 0.01, mode="factor", store=store)),
        "finetune": m(arm.calibrate(base, 0.01, mode="finetune", **kw)),
        "scratch": m(arm.calibrate(base, 0.01, mode="scratch", **kw)),
        "native": m(arm.pretrain("nn2", store=store, max_iters=300))}


@pytest.fixture(scope="module")
def reference_transfer(tmp_path_factory):
    """The reference script's cold run: its intel base and MdRAEs."""
    return _reference_transfer(tmp_path_factory.mktemp("ref"))


def test_transfer_with_the_reference_base(reference_transfer, tmp_path):
    """From the reference's intel NN2: intel, direct, factor and fine-tune
    MdRAEs at 1e-4; scratch and native (cold draws) within the band."""
    jbase, want = reference_transfer
    got = _example("transfer_learning").run(str(tmp_path / "port"), device="cpu",
                                            base=_carried(jbase), **SMALL, **TRANSFER)
    for key in ("intel", "direct", "factor", "finetune"):
        np.testing.assert_allclose(got[key]["mdrae"], want[key], rtol=MDRAE_RTOL, err_msg=key)
    for key in ("scratch", "native"):
        _in_band(got[key]["mdrae"], want[key])
    # stored: three calibrations and arm's native primitive and DLT models
    # (the base is not)
    assert not got["warm"] and got["n_models"] == 5


def test_transfer_cold_within_band_then_warm(reference_transfer, tmp_path):
    """Cold: every MdRAE within the band of the reference's cold run. The
    same script again on the same store: all five models warm, the same
    numbers, nothing new stored."""
    want = reference_transfer[1]
    example = _example("transfer_learning")
    cold = example.run(str(tmp_path / "port"), device="cpu", **SMALL, **TRANSFER)
    assert not cold["warm"] and cold["n_models"] == 7      # and intel's two
    for key in want:
        _in_band(cold[key]["mdrae"], want[key])
    warm = example.run(str(tmp_path / "port"), device="cpu", **SMALL, **TRANSFER)
    assert warm["warm"] and warm["n_models"] == 7
    for key in ("intel", "factor", "finetune", "scratch", "native"):
        assert warm[key]["warm"] and warm[key]["mdrae"] == cold[key]["mdrae"], key


def test_transfer_store_defaults_outside_artifacts(monkeypatch, tmp_path):
    example = _example("transfer_learning")
    monkeypatch.delenv("REPRO_TORCH_ARTIFACTS", raising=False)
    assert Path(example.default_store()).parts[0] == "build"
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path))
    assert example.default_store() == str(tmp_path)
    assert Path(_example("train_lm").default_ckpt_dir()).parent == tmp_path


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

def test_train_lm_matches_the_launcher_loop_and_resumes(tmp_path):
    """Reduced mixtral_8x7b, batch 2 x seq 16: six steps equal
    ``train_loop``'s losses bit for bit; four steps then six resuming from
    step 4 equal the uninterrupted six."""
    example = _example("train_lm")
    kw = dict(batch=2, seq=16, device="cpu")
    whole = example.run("mixtral_8x7b", 6, ckpt_dir=str(tmp_path / "a"), **kw)
    cfg = train.cb.get("mixtral_8x7b").reduced()
    loop = train.train_loop(cfg, 2, 16, 6, ckpt_dir=None, device="cpu", seed=0,
                            log=lambda s: None)
    assert whole["start"] == 0 and whole["losses"] == loop.losses
    first = example.run("mixtral_8x7b", 4, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = example.run("mixtral_8x7b", 6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed["start"] == 4
    assert first["losses"] + resumed["losses"] == whole["losses"]
    assert all(np.isfinite(whole["losses"]))


def test_train_lm_matches_the_reference_train_step(ref_launch, tmp_path):
    """From the reference's parameters (``init_params(PRNGKey(0))``,
    carried over), three AdamW steps of reduced chatglm3_6b on the batches
    of steps 1-3: each loss within 1e-4 of the reference's single-device
    loop (its ``make_train_step``, ``repro.dist`` stubbed)."""
    jsteps, _ = ref_launch
    jcfg, tcfg, jp = _model("chatglm3_6b")
    _, jopt = jsteps.optimizer_for(jcfg)
    step_fn = jax.jit(jsteps.make_train_step(jcfg, jopt))
    params, state, want = jp, jopt.init(jp), []
    for step in (1, 2, 3):
        params, state, loss = step_fn(params, state, jlm.make_batch(jcfg, 2, 16, step))
        want.append(float(loss))
    got = _example("train_lm").run("chatglm3_6b", 3, batch=2, seq=16, device="cpu",
                                   ckpt_dir=str(tmp_path), params=_port_params(jp))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# serve_optimized_cnn
# ---------------------------------------------------------------------------

def _hold_served(opt, weights, xs, ys):
    base = {i: split_tile(c)[0] for i, c in opt.assignment.items()}
    sink = sink_nodes(opt.spec)[-1]
    for x, y in zip(xs, ys):
        want = execute(opt.spec, base, weights, x=x, compiled=False,
                       device="cpu").outputs[sink].numpy()
        np.testing.assert_allclose(y, want, rtol=1e-3, atol=1e-3)


def test_serve_example_on_the_cpu():
    """The whole script on the CPU at two requests of two images, with two
    workers and an arm + gpu routed stream (the warm-up burst and two
    requests): every sampled response equals the interpreted executor under
    the base columns."""
    example = _example("serve_optimized_cnn")
    out = example.run(requests=2, batch=2, workers=2, backends=["arm", "gpu"],
                      max_iters=100, repeats=1, device="cpu")
    convs = [n for n in out["opt"].spec.nodes if hasattr(n, "k")]
    assert len(out["assignment"]) == len(convs) == 14 and out["img_s"]["optimised"] > 0
    assert set(out["assignment"]) <= set(example.PRIMITIVES)
    assert out["concurrent"]["failed"] == 0
    assert sum(out["routed"]["backends"].values()) == (1 + 2) * 2
    assert len(out["samples"]) == 4
    for opt, xs, ys in out["samples"]:
        _hold_served(opt, out["weights"], xs, ys)


def test_serve_example_routes_over_tpu_and_host():
    """``--backends tpu,host``: the simulated tile platform and this CPU
    (``HostPlatform`` measuring the script's pool) as routed backends; the
    warm-up burst and two requests of two images go through both."""
    example = _example("serve_optimized_cnn")
    out = example.run(requests=2, batch=2, backends=["tpu", "host"],
                      max_iters=100, repeats=1, device="cpu")
    assert set(out["routed"]["backends"]) == {"tpu", "host"}
    assert sum(out["routed"]["backends"].values()) == (1 + 2) * 2
