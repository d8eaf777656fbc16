"""The single-card part of ``launch/`` and the matmul-site autotune against
the reference on the CPU.

Launch: ``shapes.input_specs`` against the reference's ``ShapeDtypeStruct``
stand-ins for the ten configs x four cells (decode caches leaf by leaf), the
shapes-only parameter tree (``transformer.param_shapes``) against the
reference's ``eval_shape`` of ``init_params`` at full width and against the
port's own drawn parameters at reduced width, and ``dryrun``'s bytes.

``cfg.n_params()`` is the reference's approximate count (it leaves out norm
scales, biases and whisper's learned positions, and counts whisper's
ungated MLPs as gated), so ``dryrun``'s parameter bytes are held to the
reference's own parameter tree, not to ``n_params() x`` the dtype size.

Autotune: ``matmul_sites`` equal to the reference's; ``autotune_arch`` with
the NN2 of the reference's ``train_cost_model`` carried over and the port's
``analytic_cost`` injected as the cost gives the reference's assignment and
seconds (under the reference's ``analytic_cost``); ``build_dataset``'s
sampling design with the port's ``analytic_cost`` injected.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import autotune as JAT
from repro.kernels.matmul.ops import VARIANTS as JVARIANTS
from repro.launch import shapes as JSH
from repro.models import transformer as JT
from repro.train import optim as joptim
from repro_torch import convert
from repro_torch.configs import base as cb
from repro_torch.core import autotune as AT
from repro_torch.launch import dryrun, shapes
from repro_torch.models import transformer as T

ARCHS = list(jcb.ASSIGNED_ARCHS)
CELLS = list(JSH.SHAPES)
_DT = {jax.numpy.dtype("bfloat16"): torch.bfloat16,
       jax.numpy.dtype("float32"): torch.float32,
       jax.numpy.dtype("int32"): torch.int32}


def _leaves(tree, path=()):
    """{path: leaf} of a nested dict tree (jax or torch leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _hold_specs(got, want):
    """Same keys; each port leaf a ``meta`` tensor of the reference's shape
    and dtype."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k, sds in w.items():
        assert g[k].device.type == "meta", k
        assert tuple(g[k].shape) == tuple(sds.shape), k
        assert g[k].dtype == _DT[np.dtype(sds.dtype)], k


def _bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in _leaves(tree).values())


# ---------------------------------------------------------------------------
# launch/shapes.py, the shapes-only parameters, launch/dryrun.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    """Every input stand-in, the decode cache leaf by leaf; where the cell
    does not apply (long_500k under full attention) both raise."""
    jcfg, tcfg = jcb.get(arch), cb.get(arch)
    assert shapes.cell_applicable(tcfg, shape) == JSH.cell_applicable(jcfg, shape)
    if not JSH.cell_applicable(jcfg, shape):
        with pytest.raises(ValueError):
            JSH.input_specs(jcfg, shape)
        with pytest.raises(ValueError, match="does not run"):
            shapes.input_specs(tcfg, shape)
        return
    _hold_specs(shapes.input_specs(tcfg, shape), JSH.input_specs(jcfg, shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference_at_full_width(arch):
    """``param_shapes`` at the registered width: the reference's
    ``eval_shape(init_params)`` tree, leaf by leaf, and nothing allocated."""
    want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcb.get(arch)))
    _hold_specs(T.param_shapes(cb.get(arch)), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_drawn_params(arch):
    """At reduced width the shapes-only tree is the drawn tree's shapes
    and dtypes, leaf by leaf."""
    cfg = cb.get(arch).reduced()
    drawn = _leaves(T.init_params(torch.Generator().manual_seed(0), cfg))
    meta = _leaves(T.param_shapes(cfg))
    assert meta.keys() == drawn.keys()
    for k, t in drawn.items():
        assert meta[k].shape == t.shape and meta[k].dtype == t.dtype, k


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_bytes_match_reference_trees(arch):
    """``train_4k`` and ``decode_32k``: parameter bytes equal the
    reference's parameter tree, optimiser bytes its optimiser's state (the
    reference's 0-d int32 step aside: the port's step is a host int), cache
    and input bytes its ``input_specs``; ``n_params`` is the config's."""
    jcfg = jcb.get(arch)
    jparams = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    # steps.OPTIMIZER_FOR_ARCH: Adafactor for llama3_405b, AdamW (lr 3e-4,
    # weight decay 0.1) otherwise; the state's shapes do not depend on lr
    jopt = (joptim.adafactor(3e-4) if arch == "llama3_405b"
            else joptim.adamw(3e-4, weight_decay=0.1))
    jstate = jax.eval_shape(jopt.init, jparams)
    jstate_bytes = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                       for x in jax.tree.leaves(jstate) if x.shape)
    train = dryrun.run_cell(arch, "train_4k")
    m = train["memory"]
    assert train["status"] == "ok" and train["step_kind"] == "train"
    assert train["n_params"] == cb.get(arch).n_params() == jcfg.n_params()
    assert m["param_bytes"] == _bytes(jparams)
    assert m["opt_state_bytes"] == jstate_bytes
    assert m["input_bytes"] == _bytes(JSH.input_specs(jcfg, "train_4k"))
    assert m["cache_bytes"] == 0
    assert m["argument_bytes"] == m["param_bytes"] + m["opt_state_bytes"] + m["input_bytes"]
    decode = dryrun.run_cell(arch, "decode_32k")["memory"]
    jdec = JSH.input_specs(jcfg, "decode_32k")
    assert decode["cache_bytes"] == _bytes(jdec.pop("cache"))
    assert decode["input_bytes"] == _bytes(jdec)
    assert decode["opt_state_bytes"] == 0


def test_dryrun_batch_fit_against_the_card():
    """The fit is the largest batch whose cache and inputs fit beside the
    parameters: all of it on a huge card, none when the parameters alone
    overflow, and in between the floor of the room over the bytes a
    sequence holds."""
    cell = "decode_32k"
    base = dryrun.run_cell("chatglm3_6b", cell)["memory"]
    B = 128
    per_seq = (base["cache_bytes"] + base["input_bytes"]) / B
    assert dryrun.run_cell("chatglm3_6b", cell, card=10 ** 15)["memory"]["batch_fit"] == B
    none = dryrun.run_cell("chatglm3_6b", cell, card=base["param_bytes"] - 1)["memory"]
    assert none["batch_fit"] == 0 and not none["fits"]
    card = base["param_bytes"] + int(10.5 * per_seq)
    part = dryrun.run_cell("chatglm3_6b", cell, card=card)["memory"]
    assert part["batch_fit"] == 10 and part["batch_share"] == 10 / B
    assert part["not_estimated"] == dryrun.NOT_ESTIMATED


def test_dryrun_all_writes_every_artifact(tmp_path, capsys):
    """``--all``: one JSON artifact a cell, ``skipped`` exactly where the
    cell does not apply, one table row a cell, nothing allocated."""
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 2 + len(ARCHS) * len(CELLS)
    for arch in ARCHS:
        for shape in CELLS:
            r = json.loads((tmp_path / f"{arch}.{shape}.json").read_text())
            applicable = JSH.cell_applicable(jcb.get(arch), shape)
            assert r["status"] == ("ok" if applicable else "skipped"), (arch, shape)
            if applicable:
                assert r["step_kind"] == JSH.SHAPES[shape].step
                assert r["memory"]["argument_bytes"] > 0


# ---------------------------------------------------------------------------
# core/autotune.py
# ---------------------------------------------------------------------------

def _analytic(M, K, N, variant):
    """The port's analytic surface under ``variant``'s blocks."""
    return AT.analytic_cost(M, K, N, *AT.MM_VARIANTS[variant])


@pytest.mark.parametrize("arch", ARCHS)
def test_matmul_sites_match_reference(arch):
    for kw in ({}, {"batch_tokens": 4096, "tp": 4}):
        assert AT.matmul_sites(cb.get(arch), **kw) == JAT.matmul_sites(jcb.get(arch), **kw)


@pytest.fixture(scope="module")
def cost_models():
    """The reference's ``train_cost_model`` (its 3,000-row analytic
    dataset, 300 NN2 iterations) and the port's copy of it."""
    jm = JAT.train_cost_model(max_iters=300)
    return jm, convert.perfmodel_from_state(jm.to_state(), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_autotune_arch_matches_reference(arch, cost_models):
    """With the reference's model carried over and the port's analytic cost
    injected: the reference's assignment, and its predicted / default /
    oracle seconds (priced by its own ``analytic_cost``) at 1e-6."""
    jm, tm = cost_models
    want = JAT.autotune_arch(jcb.get(arch), jm)
    got = AT.autotune_arch(cb.get(arch), tm, cost_fn=_analytic)
    assert got.assignment == want.assignment
    for key in ("predicted_s", "default_s", "oracle_s"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=1e-6)
    # the reference test's bounds (tests/test_autotune_data.py:35-40)
    assert got.predicted_s <= got.default_s * 1.01, arch
    assert got.predicted_s >= got.oracle_s * 0.999, arch


def test_build_dataset_sampling_design():
    """Sites first (every distinct site of the ten configs), then distinct
    seeded log-uniform GEMMs under the FLOP cap; each row the cost source's
    seconds under the 8 variants in ``VARIANTS`` order; the same seed, the
    same rows; a zero budget stops after the sites."""
    calls = []

    def cost(M, K, N, v):
        calls.append((M, K, N, v))
        return _analytic(M, K, N, v)

    data = AT.build_dataset(cost, sample_rows=40, max_flops=1e10, seed=3)
    sites = AT.site_shapes(cb.all_assigned())
    assert data.names == list(JVARIANTS) and data.n_sites == len(sites) == 39
    assert [tuple(map(int, r)) for r in data.feats[:data.n_sites]] == sites
    sample = data.feats[data.n_sites:]
    assert len(sample) == 40 and len({tuple(r) for r in data.feats}) == len(data.feats)
    assert (2 * sample.prod(axis=1) <= 1e10).all()
    assert (sample[:, 0] >= 128).all() and (sample[:, 0] <= 2 ** 17).all()
    assert (sample[:, 1:] >= 128).all() and (sample[:, 1:] <= 2 ** 15).all()
    assert len(calls) == 8 * len(data.feats)
    want = np.array([[_analytic(*map(int, r), v) for v in data.names] for r in data.feats])
    np.testing.assert_array_equal(data.times, want)
    again = AT.build_dataset(_analytic, sample_rows=40, max_flops=1e10, seed=3)
    np.testing.assert_array_equal(again.feats, data.feats)
    only_sites = AT.build_dataset(_analytic, budget_s=0.0)
    assert len(only_sites.feats) == only_sites.n_sites == 39
    tr, va, te = data.split()
    assert sorted(np.concatenate([tr, va, te]).tolist()) == list(range(len(data.feats)))


def test_cost_model_trains_on_the_dataset():
    """``train_cost_model`` on an injected-cost dataset: an NN2 over the 8
    variants whose held-out MdRAE beats predicting every GEMM's time as the
    median's, and whose ``autotune_arch`` stays within the reference
    test's bounds."""
    data = AT.build_dataset(_analytic, sample_rows=160, seed=1)
    model = AT.train_cost_model(data, max_iters=300, device="cpu")
    assert model.kind == "nn2" and list(model.columns) == list(JVARIANTS)
    err = AT.mdrae_held_out(model, data)
    te = data.split()[2]
    chance = np.median(np.abs(np.median(data.times) - data.times[te]) / data.times[te])
    assert np.isfinite(err) and err < 0.5 * chance, (err, chance)
    res = AT.autotune_arch(cb.get("chatglm3_6b"), model, cost_fn=_analytic)
    assert res.oracle_s * 0.999 <= res.predicted_s <= res.default_s * 1.01


def test_measured_cost_needs_the_card():
    with pytest.raises(ValueError, match="times the card"):
        AT.MeasuredCost(device="cpu")
