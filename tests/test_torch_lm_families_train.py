"""The port's training path of the MLA, MoE, SSM, hybrid and
encoder-decoder families (``repro_torch.models.transformer.{forward,
loss_fn}``, ``models.{moe,ssm,components}`` under autograd,
``launch.{steps,train}``) against the JAX reference's
``jax.value_and_grad``, on the CPU.

The reduced configs, batch 2 x 24 tokens (a multiple of the reduced SSM
chunk, 8); weights cross from the reference's ``init_params(PRNGKey(0),
cfg.reduced())`` by ``convert.lm_params_from_jax``, data from both
packages' ``make_batch``. Tolerance: the reference's fp32 ``_TOL`` (1e-4)
for losses, gradients and parameters; remat and resumed runs bit for bit.
The helpers and the ``ref_launch`` fixture (the reference launcher with
stand-ins for its missing ``repro.dist``) are ``test_torch_lm_train``'s.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import dataclasses
import io
import re
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm as jlm
from repro.models import components as JC
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import lm
from repro_torch.launch import steps, train
from repro_torch.models import components as C
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from test_torch_lm_train import (_TOL, _close_trees, _equal_trees, _model, _np,
                                 _port_loss_and_grads, _port_params, _rand,
                                 ref_launch)

LATER = ("minicpm3_4b", "mixtral_8x7b", "qwen3_moe_30b_a3b", "mamba2_2_7b",
         "zamba2_2_7b", "whisper_medium")
B, SEQ = 2, 24


def _ref_loss_and_grads(jcfg, jp, jb):
    return jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True))(jp)


def _hold_loss_and_grads(jcfg, tcfg, jp, index=1):
    """The port's loss, ce, aux and every gradient leaf against the
    reference's on batch ``index``; returns the port's aux."""
    jb = jlm.make_batch(jcfg, B, SEQ, index)
    tb = lm.make_batch(tcfg, B, SEQ, index, device="cpu")
    assert ("enc_embeds" in tb) == (tcfg.kind == "encdec")
    (want, wm), wg = _ref_loss_and_grads(jcfg, jp, jb)
    loss, metrics, grads = _port_loss_and_grads(_port_params(jp), tcfg, tb)
    np.testing.assert_allclose(_np(loss), np.asarray(want), **_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(wm[k]), err_msg=k, **_TOL)
    _close_trees(grads, wg)
    return float(metrics["aux"].detach())


@pytest.mark.parametrize("arch", LATER)
def test_loss_fn_and_grads_match_reference(arch):
    """Loss, ce, aux and the gradient of every parameter: the MoE aux loss
    summed over the layers (nonzero), the SSM's A_log, D and dt_bias, MLA's
    latent projections, the hybrid's shared block summed over its uses,
    Whisper's encoder through the cross-attention."""
    jcfg, tcfg, jp = _model(arch)
    aux = _hold_loss_and_grads(jcfg, tcfg, jp)
    assert (aux != 0.0) == (tcfg.moe is not None), aux


@pytest.mark.parametrize("dispatch, factor", [("sort", 1.25), ("scatter", 8.0),
                                              ("scatter", 1.25)])
def test_moe_capacity_and_dispatch_grads_match_reference(dispatch, factor, monkeypatch):
    """Reduced qwen3-moe dropless (its reduced factor 8) and at the
    registered 1.25, where (token, k) pairs are dropped, under both
    dispatches (its reduced default, sort and dropless, is
    ``test_loss_fn_and_grads_match_reference``'s): loss and every gradient
    against the reference at the same capacity."""
    jcfg, tcfg, jp = _model("qwen3_moe_30b_a3b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=factor, dispatch=dispatch))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=factor, dispatch=dispatch))
    routes, route = [], M._route

    def recorded(params, x, cfg):
        out = route(params, x, cfg)
        routes.append(out[0])
        return out

    monkeypatch.setattr(M, "_route", recorded)
    _hold_loss_and_grads(jcfg, tcfg, jp)
    assert len(routes) == tcfg.n_layers
    dropped = 0
    for idx in routes:
        counts = torch.zeros((B, tcfg.moe.n_experts), dtype=torch.long).scatter_add_(
            1, idx.reshape(B, -1), torch.ones_like(idx.reshape(B, -1)))
        dropped += int(torch.clamp(counts - M.capacity(tcfg.moe, SEQ), min=0).sum())
    assert (dropped > 0) == (factor < 2), dropped


def test_moe_dropped_pair_passes_no_gradient_to_its_expert():
    """One batch row whose every pair picks experts 0 and 1 at capacity 1:
    each expert's weights see only its first token, so a token past it
    changes no expert gradient; the router still gets one."""
    cfg = M.MoEConfig(n_experts=4, top_k=2, d_ff=8, capacity_factor=0.25)
    g = torch.Generator().manual_seed(0)
    p = M.moe_init(g, 16, cfg, torch.float32)
    p["router"]["w"] = torch.zeros((16, 4))
    p["router"]["w"][:, :2] = 1.0                 # every token prefers 0, 1
    x = torch.rand((1, 4, 16), generator=g) + 0.5
    assert M.capacity(cfg, 4) == 1
    for dispatch in ("sort", "scatter"):
        c = dataclasses.replace(cfg, dispatch=dispatch)
        ps = {k: {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
              if isinstance(v, dict) else v.clone().requires_grad_(True)
              for k, v in p.items()}
        out, aux = M.moe_apply(ps, x, c)
        gx = torch.autograd.grad(out.sum() + aux, [ps["w_up"], ps["router"]["w"]])
        x2 = x.clone()
        x2[:, 1:] = x2[:, 1:] * 3.0                   # change only the dropped tokens
        out2, aux2 = M.moe_apply(ps, x2, c)
        gx2 = torch.autograd.grad(out2.sum() + aux2, [ps["w_up"], ps["router"]["w"]])
        assert torch.equal(gx[0], gx2[0]), dispatch
        assert not torch.equal(gx[1], gx2[1]), dispatch
        assert torch.equal(out[:, 1:], torch.zeros_like(out[:, 1:])), dispatch


REMAT = ("minicpm3_4b", "mixtral_8x7b", "mamba2_2_7b", "zamba2_2_7b", "whisper_medium")


@pytest.mark.parametrize("arch", REMAT)
def test_remat_gives_the_same_loss_and_grads(arch):
    """``cfg.remat`` recomputes each layer (the hybrid: each group; the
    encoder-decoder: each encoder and each decoder layer) in backward: the
    same loss, aux and gradients, bit for bit."""
    _, tcfg, jp = _model(arch)
    tp = _port_params(jp)
    tb = lm.make_batch(tcfg, B, SEQ, 2, device="cpu")
    plain = _port_loss_and_grads(tp, dataclasses.replace(tcfg, remat=False), tb)
    remat = _port_loss_and_grads(tp, dataclasses.replace(tcfg, remat=True), tb)
    assert torch.equal(plain[0], remat[0])
    assert torch.equal(plain[1]["aux"], remat[1]["aux"])
    _equal_trees(remat[2], plain[2])


def test_ssd_chunked_grads_with_init_state_match_reference():
    """Gradients of a weighted sum of the output and the final state wrt
    x, dt, A, B, C and the initial state, three chunks of 8: no NaN from
    the masked cells above the diagonal."""
    r = np.random.default_rng(9)
    b, s, h, p, n = 2, 24, 4, 8, 16
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    Bm, Cm = (r.standard_normal((b, s, 1, n)).astype(np.float32) * 0.5 for _ in range(2))
    st = r.standard_normal((b, h, p, n)).astype(np.float32)
    wy, ws = _rand(1, b, s, h, p), _rand(2, b, h, p, n)
    args = (x, dt, A, Bm, Cm, st)

    def ref(x_, dt_, A_, B_, C_, s_):
        y, f = JS.ssd_chunked(x_, dt_, A_, B_, C_, 8, init_state=s_)
        return jnp.sum(y * wy) + jnp.sum(f * ws)

    want = jax.jit(jax.grad(ref, argnums=tuple(range(6))))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, f = S.ssd_chunked(*ts[:5], 8, init_state=ts[5])
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(wy))
                              + torch.sum(f * torch.from_numpy(ws)), ts)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "init_state"), got, want):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name, **_TOL)


def test_ssd_chunked_fp32_grads_stay_near_fp64_at_the_full_chunk():
    """Two chunks of the registered 256: every fp32 gradient within 2e-6 of
    its max from the same computation in fp64. ``_segsum`` sums each
    segment directly; the reference's difference of two prefix sums gives
    the same values but, in backward, subtracts two large sums sharing the
    diagonal's mass, and fails this bound by several times."""
    r = np.random.default_rng(0)
    b, s, h, p, n = 1, 512, 4, 16, 32
    x = r.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)) - 2))
    A = -np.linspace(1.0, 16.0, h)
    Bm, Cm = (r.standard_normal((b, s, 1, n)) * 0.5 for _ in range(2))
    w = r.standard_normal((b, s, h, p))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (x, dt, A, Bm, Cm)]
        y, _ = S.ssd_chunked(*ts, 256)
        grads[dtype] = torch.autograd.grad(torch.sum(y * torch.tensor(w, dtype=dtype)), ts)
    for name, g32, g64 in zip(("x", "dt", "A", "B", "C"), *grads.values()):
        assert float((g32.double() - g64).abs().max()) <= 2e-6 * float(g64.abs().max()), name


def test_mla_grads_through_the_blockwise_path_match_reference():
    """MLA prefill at S = 2,112 with 64-key blocks (the online-softmax path
    a 4,096-token training step takes at 1,024): the gradient of a weighted
    sum of the layer's output wrt its input and every MLA weight."""
    dims = C.MLADims(q_lora=16, kv_lora=8, qk_nope=8, qk_rope=4, v_head=8)
    jdims = JC.MLADims(**dataclasses.asdict(dims))
    D, H, Sq = 32, 2, 2112
    jp = JC.mla_init(jax.random.PRNGKey(3), D, H, jdims, jnp.float32)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x, w = _rand(4, 1, Sq, D, scale=0.5), _rand(5, 1, Sq, D)
    pos = np.arange(Sq, dtype=np.int32)

    def ref(p, x_):
        q, ckv, kr = JC.mla_project(p, x_, H, jdims, jnp.asarray(pos), 10000.0)
        out = JC.mla_attend(p, q, ckv, kr, jnp.asarray(pos), jnp.asarray(pos), H, jdims,
                            kv_block=64)
        return jnp.sum(out * w)

    wp, wx = jax.jit(jax.grad(ref, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.requires_grad_(True) for k, v in _flat_port(tp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tpos = torch.from_numpy(pos).long()
    q, ckv, kr = C.mla_project(tp, tx, H, dims, tpos, 10000.0)
    out = C.mla_attend(tp, q, ckv, kr, tpos, tpos, H, dims, kv_block=64)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), [tx, *leaves.values()])
    np.testing.assert_allclose(_np(got[0]), np.asarray(wx), **_TOL)
    want = _flat_port(wp)
    for (k, _), g in zip(leaves.items(), got[1:]):
        np.testing.assert_allclose(_np(g), np.asarray(want[k]), err_msg=k, **_TOL)


def _flat_port(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in
                _flat_port(tree[key], f"{path}/{key}").items()}
    return {path: tree}


TRAINED = ("mixtral_8x7b", "mamba2_2_7b")


@pytest.mark.parametrize("arch", TRAINED)
def test_train_step_matches_reference(ref_launch, arch):
    """Two AdamW steps of ``make_train_step`` (batch 4 x 16): loss and
    parameters against the reference's jitted step."""
    jsteps, _ = ref_launch
    jcfg, tcfg, jp = _model(arch)
    _, jopt = jsteps.optimizer_for(jcfg)
    name, topt = steps.optimizer_for(tcfg)
    assert name == "adamw"
    jfn = jax.jit(jsteps.make_train_step(jcfg, jopt))
    tfn = steps.make_train_step(tcfg, topt)
    tp = _port_params(jp)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in (1, 2):
        jp, js, want = jfn(jp, js, jlm.make_batch(jcfg, 4, 16, i))
        tp, ts, got = tfn(tp, ts, lm.make_batch(tcfg, 4, 16, i, device="cpu"))
        np.testing.assert_allclose(_np(got), np.asarray(want), **_TOL)
    _close_trees(tp, dict(jp))
    _close_trees({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]})
    assert ts["step"] == int(js["step"]) == 2


@pytest.mark.parametrize("arch", TRAINED)
def test_launcher_resumed_loop_matches_reference_main(ref_launch, tmp_path, monkeypatch,
                                                      arch):
    """The reference's ``main`` for 5 steps (batch 4 x seq 32, weights from
    PRNGKey(0)) against the port's ``train_loop`` from the
    same weights run to step 3 and resumed from its checkpoint to 5: the
    step-1 loss the reference prints, and the parameters and AdamW state of
    the checkpoint it writes, read by the port's manager. The resumed run
    equals an uninterrupted one bit for bit."""
    _, jtrain = ref_launch
    _, tcfg, jp = _model(arch)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--steps", "5",
                                      "--batch", "4", "--seq", "32",
                                      "--ckpt-dir", str(tmp_path / "ref")])
    out = io.StringIO()
    with redirect_stdout(out):
        jtrain.main()
    printed = re.findall(r"\[train\] step\s+(\d+) loss ([0-9.]+)", out.getvalue())
    assert [int(s) for s, _ in printed] == [1]
    kw = dict(ckpt_dir=str(tmp_path / "port"), device="cpu", log=lambda _: None)
    first = train.train_loop(tcfg, 4, 32, 3, params=_port_params(jp), **kw)
    resumed = train.train_loop(tcfg, 4, 32, 5, **kw)
    assert resumed.start == 3 and resumed.steps == [4, 5]
    assert abs(first.losses[0] - float(printed[0][1])) <= 1e-4
    whole = train.train_loop(tcfg, 4, 32, 5, ckpt_dir=None, device="cpu",
                             params=_port_params(jp), log=lambda _: None)
    assert whole.losses == first.losses + resumed.losses
    _equal_trees(resumed.params, whole.params)
    _equal_trees(resumed.opt_state, whole.opt_state)
    mgr = CheckpointManager(str(tmp_path / "ref" / tcfg.name))
    params, state = mgr.restore(5, (resumed.params, resumed.opt_state), device="cpu")
    assert state["step"] == resumed.opt_state["step"] == 5
    _close_trees(resumed.params, params)
    _close_trees(resumed.opt_state, state)
