"""The port's LM training path (``repro_torch.models.components.
chunked_ce_loss``, ``transformer.loss_fn`` with remat, ``train.optim``,
``data.lm``, ``ckpt.manager``, ``launch.{steps,shapes,train}``) against the
JAX reference, on the CPU.

Inputs are made with numpy from a seed; weights cross from the reference's
``init_params(PRNGKey(0), cfg.reduced())`` by ``convert.lm_params_from_jax``.
Tolerances: the reference's fp32 ``_TOL`` (1e-4) for values, gradients and
optimiser trees, its bf16 tolerance (5e-2) for bf16 trees (XLA fuses
``momentum * m + u`` and rounds once, torch rounds after each op); data,
remat and resumed runs bit for bit.

The reference launcher imports ``repro.dist.sharding``, which the package
lacks; ``ref_launch`` puts empty stand-ins for it into ``sys.modules`` for a
test's duration (``make_train_step`` without an ``aspec`` never touches
them) and drops the reference launch modules afterwards.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import dataclasses
import functools
import io
import os
import re
import sys
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as JCheckpointManager
from repro.configs import base as jcb
from repro.data import lm as jlm
from repro.models import components as JC
from repro.models import transformer as JT
from repro.train import optim as joptim
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import base as cb
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import lm
from repro_torch.launch import shapes, steps, train
from repro_torch.models import components as C
from repro_torch.models import transformer as T
from repro_torch.train import optim

_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
DENSE = ("chatglm3_6b", "llama3_405b", "internvl2_1b", "gemma2_27b")


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flat(tree, path=()):
    """{path: leaf} of a tree of dicts (either package), ``None`` skipped."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], path + (key,)).items()}
    return {"/".join(path): tree}


def _close_trees(got, want, tol=_TOL):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for key in w:
        if isinstance(g[key], int):
            assert g[key] == int(w[key]), key
            continue
        assert tuple(g[key].shape) == tuple(np.shape(w[key])), key
        np.testing.assert_allclose(_np(g[key]), _np(w[key]), err_msg=key, **tol)


def _equal_trees(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for key in w:
        if isinstance(w[key], int):
            assert g[key] == w[key], key
        else:
            assert g[key].dtype == w[key].dtype, key
            assert torch.equal(g[key], w[key]), key


def _unrotated_bias(cfg):
    """Mask over ``bk``'s last axis: the dims RoPE leaves alone (chatglm3
    rotates half of each head). A bias there adds the same vector to every
    key, which shifts each query's scores by one constant that softmax
    removes, so its gradient is exactly zero: what either package computes
    there is rounding noise (~1e-8)."""
    hd = cfg.hd
    rot = int(hd * cfg.rope_fraction)
    return (np.arange(cfg.n_kv_heads * hd) % hd) >= rot


def _close_params(got, want, cfg, n_steps, lr=steps.DEFAULT_LR):
    """Parameters after ``n_steps`` AdamW steps, every element at 1e-4 but
    the unrotated dims of ``bk``. AdamW divides a gradient by its own RMS,
    so there each package's noise becomes a step of up to about ``lr`` in a
    direction the noise picks; those elements are held to ``2 * n_steps *
    lr``, the most two such walks can part."""
    if not cfg.qkv_bias:
        return _close_trees(got, want)
    mask = _unrotated_bias(cfg)
    g, w = (t["layers"]["attn"].pop("bk") for t in (got, want))
    try:
        _close_trees(got, want)
    finally:
        got["layers"]["attn"]["bk"], want["layers"]["attn"]["bk"] = g, w
    g, w = _np(g), _np(w)
    np.testing.assert_allclose(g[..., ~mask], w[..., ~mask], **_TOL)
    assert np.abs(g[..., mask] - w[..., mask]).max() <= 2 * n_steps * lr


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, reference params) of the reduced config,
    weights from the reference's init at PRNGKey(0)."""
    jcfg, tcfg = jcb.get(arch).reduced(), cb.get(arch).reduced()
    return jcfg, tcfg, JT.init_params(jax.random.PRNGKey(0), jcfg)


def _port_params(jp):
    return lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _port_loss_and_grads(tp, tcfg, batch):
    """(loss, metrics, grads) of the port's ``loss_fn`` through autograd."""
    ps = optim.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    loss, metrics = T.loss_fn(ps, tcfg, batch)
    grads = torch.autograd.grad(loss, optim.tree_leaves(ps))
    it = iter(grads)
    return loss, metrics, optim.tree_map(lambda _: next(it), tp)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

# (n_chunks, softcap, label mask)
CE_CASES = {"dividing": (4, None, False), "not_dividing": (5, None, False),
            "more_than_divides": (8, None, False), "softcap": (3, 5.0, False),
            "label_mask": (4, None, True), "all_at_once": (1, 2.0, True)}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_chunked_ce_loss_matches_reference(case):
    """Value and gradient wrt h and the embedding (S=12, chunks lowered until
    they divide it)."""
    n_chunks, softcap, masked = CE_CASES[case]
    B, S, D, V = 2, 12, 16, 40
    h, emb = _rand(0, B, S, D), _rand(1, V, D, scale=0.5)
    labels = np.random.default_rng(2).integers(0, V, (B, S)).astype(np.int32)
    mask = (np.random.default_rng(3).random((B, S)) < 0.6).astype(np.float32) if masked else None

    def ref(h_, e_):
        return JC.chunked_ce_loss({"emb": e_}, h_, jnp.asarray(labels), n_chunks,
                                  softcap=softcap,
                                  label_mask=None if mask is None else jnp.asarray(mask))

    want, (wgh, wge) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    got = C.chunked_ce_loss({"emb": te}, th, torch.from_numpy(labels), n_chunks,
                            softcap=softcap,
                            label_mask=None if mask is None else torch.from_numpy(mask))
    gh, ge = torch.autograd.grad(got, (th, te))
    np.testing.assert_allclose(_np(got), np.asarray(want), **_TOL)
    np.testing.assert_allclose(_np(gh), np.asarray(wgh), **_TOL)
    np.testing.assert_allclose(_np(ge), np.asarray(wge), **_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_and_grads_match_reference(arch):
    """Loss, ce, aux and the gradient of every parameter (internvl2 with its
    prefix embeddings, gemma2 local/global with softcaps)."""
    jcfg, tcfg, jp = _model(arch)
    jb = jlm.make_batch(jcfg, 2, 24, 1)
    tb = lm.make_batch(tcfg, 2, 24, 1, device="cpu")
    assert ("prefix_embeds" in tb) == bool(tcfg.prefix_tokens)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    loss, metrics, grads = _port_loss_and_grads(_port_params(jp), tcfg, tb)
    np.testing.assert_allclose(_np(loss), np.asarray(want), **_TOL)
    np.testing.assert_allclose(_np(metrics["ce"]), np.asarray(wm["ce"]), **_TOL)
    assert float(metrics["aux"]) == float(wm["aux"]) == 0.0
    _close_trees(grads, wg)
    if tcfg.qkv_bias and tcfg.rope_fraction < 1:      # see _unrotated_bias
        mask = _unrotated_bias(tcfg)
        for gk in (_np(grads["layers"]["attn"]["bk"]), np.asarray(wg["layers"]["attn"]["bk"])):
            assert np.abs(gk[..., mask]).max() < 1e-7 < np.abs(gk[..., ~mask]).max()


@pytest.mark.parametrize("arch", ["chatglm3_6b", "gemma2_27b"])
def test_remat_gives_the_same_loss_and_grads(arch):
    """``cfg.remat`` recomputes each layer in backward: the same loss and
    gradients, bit for bit; without grad it is a plain forward."""
    jcfg, tcfg, jp = _model(arch)
    tp = _port_params(jp)
    tb = lm.make_batch(tcfg, 2, 24, 2, device="cpu")
    plain = _port_loss_and_grads(tp, dataclasses.replace(tcfg, remat=False), tb)
    remat = _port_loss_and_grads(tp, dataclasses.replace(tcfg, remat=True), tb)
    assert torch.equal(plain[0], remat[0])
    _equal_trees(remat[2], plain[2])
    with torch.no_grad():
        h, _ = T.forward(tp, dataclasses.replace(tcfg, remat=True), tb["tokens"])
    assert torch.equal(h, T.forward(tp, tcfg, tb["tokens"])[0])


# (B, S, Hq, Hkv, hd, keyword arguments)
ATTENTION_GRAD = {"one_shot": (2, 24, 4, 2, 16, {}),
                  "window_softcap": (2, 24, 4, 1, 16, dict(window=5, softcap=2.0)),
                  "blockwise": (1, 2112, 2, 1, 8, dict(kv_block=64))}


@pytest.mark.parametrize("case", sorted(ATTENTION_GRAD))
def test_attention_grads_match_reference(case):
    """Gradients through the one-shot and the blockwise prefill attention
    (the path a 4,096-token training step takes) wrt q, k and v."""
    B, S, Hq, Hkv, hd, kw = ATTENTION_GRAD[case]
    q, k, v = _rand(8, B, S, Hq, hd), _rand(9, B, S, Hkv, hd), _rand(10, B, S, Hkv, hd)
    w = _rand(11, B, S, Hq, hd)
    pos = np.arange(S, dtype=np.int32)

    def ref(q_, k_, v_):
        return jnp.sum(JC.attention(q_, k_, v_, jnp.asarray(pos), jnp.asarray(pos), **kw)
                       * jnp.asarray(w))

    want = jax.grad(ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tp = torch.from_numpy(pos).long()
    out = C.attention(tq, tk, tv, tp, tp, **kw)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), (tq, tk, tv))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(wg), **_TOL)


def test_flash_route_refuses_calls_that_need_a_gradient():
    """The kernel has no backward: a call through which autograd needs a
    gradient (q, k or v requiring grad, grad enabled) is not routed; the
    same call under ``torch.no_grad()`` is."""
    S, hd = 16, 64
    k = torch.zeros((1, S, 2, hd))
    pos = torch.arange(S)

    class OnCard:                      # a CUDA operand's flag and shape, no card
        is_cuda, shape = True, (1, S, 4, hd)

        def __init__(self, requires_grad):
            self.requires_grad = requires_grad

    v = torch.zeros((1, S, 2, hd))
    kw = dict(causal=True, window=None, softcap=None)
    assert C.flash_routed(OnCard(False), k, v, pos, pos, **kw)
    assert not C.flash_routed(OnCard(True), k, v, pos, pos, **kw)
    assert not C.flash_routed(OnCard(False), v, v.clone().requires_grad_(True),
                              pos, pos, **kw)
    assert not C.flash_routed(OnCard(False), k.requires_grad_(True), v, pos, pos, **kw)
    with torch.no_grad():
        assert C.flash_routed(OnCard(True), k, v, pos, pos, **kw)


# ---------------------------------------------------------------------------
# Optimisers and schedules
# ---------------------------------------------------------------------------

OPTIMISERS = {
    "sgd": ("sgd", {}),
    "sgd_momentum": ("sgd", dict(momentum=0.9)),
    "adam": ("adam", {}),
    "adamw_clip": ("adamw", dict(weight_decay=0.1, clip_norm=0.5)),
    "adafactor": ("adafactor", {}),
    "adafactor_momentum_bf16": ("adafactor", dict(momentum=0.9)),
    "adafactor_small_factor": ("adafactor", dict(min_dim_size_to_factor=32)),
}
SCHEDULES = {
    "warmup_cosine": lambda mod: mod.warmup_cosine_schedule(1e-2, 2, 5, floor=1e-3),
    "step_decay": lambda mod: mod.step_decay_schedule(1e-2, 0.5, 2),
}


def _opt_tree(seed):
    """A stacked (2, 128, 160) leaf (factored at the default 128), a
    (128, 64) matrix (factored only from 32), a vector."""
    return {"layers": {"w": _rand(seed, 2, 128, 160, scale=0.1)},
            "u": {"w": _rand(seed + 1, 128, 64, scale=0.1)},
            "b": _rand(seed + 2, 160, scale=0.1)}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("case", sorted(OPTIMISERS))
def test_optimiser_updates_match_reference(case, sched):
    """Five updates from the same gradients: parameters and state (bf16
    momentum at the bf16 tolerance)."""
    name, kw = OPTIMISERS[case]
    jo = joptim.make_optimizer(name, SCHEDULES[sched](joptim), **kw)
    to = optim.make_optimizer(name, SCHEDULES[sched](optim), **kw)
    p0 = _opt_tree(0)
    jp, tp = jax.tree.map(jnp.asarray, p0), lm_params_from_jax(p0, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for i in range(5):
        g = _opt_tree(10 + 3 * i)
        jp, js = jo.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = to.update(tp, lm_params_from_jax(g, "cpu"), ts)
    _close_trees(tp, jp)
    assert ts["step"] == int(js["step"]) == 5
    if name == "adafactor" and "m" in js:          # bf16 momentum
        _close_trees(ts.pop("m"), js.pop("m"), BF16_TOL)
    _close_trees(ts, js)


def test_adafactor_factors_the_stacked_leaf_whole():
    """The factored statistics of a stacked (n_layers, d, d_ff) leaf span the
    layer axis (one row and one column vector a layer), as the reference's."""
    to = optim.adafactor(1e-2)
    st = to.init(lm_params_from_jax(_opt_tree(0), "cpu"))
    v = st["v"]["layers"]["w"]
    assert v["v"] is None and tuple(v["vr"].shape) == (2, 128) and tuple(v["vc"].shape) == (2, 160)
    assert st["v"]["u"]["w"]["vr"] is None and tuple(st["v"]["u"]["w"]["v"].shape) == (128, 64)
    assert tuple(st["v"]["b"]["v"].shape) == (160,)


def test_schedules_match_reference():
    cases = [(lambda m: m.warmup_cosine_schedule(3e-4, 10, 110, floor=1e-5), 125),
             (lambda m: m.warmup_cosine_schedule(1.0, 0, 50), 60),
             (lambda m: m.step_decay_schedule(0.1, 0.5, 7), 40),
             (lambda m: m.constant_schedule(0.3), 3)]
    for make, n in cases:
        js, ts = make(joptim), make(optim)
        for step in range(n):
            want = float(js(jnp.asarray(step, jnp.int32)))
            np.testing.assert_allclose(ts(step), want, rtol=1e-6, atol=0)
            assert isinstance(ts(step), float)


def test_make_optimizer_names_and_unknown():
    assert sorted(optim.OPTIMIZERS) == sorted(joptim.OPTIMIZERS)
    for name in optim.OPTIMIZERS:
        assert isinstance(optim.make_optimizer(name, 0.1), optim.Optimizer)
    with pytest.raises(ValueError) as got:
        optim.make_optimizer("lion", 0.1)
    with pytest.raises(ValueError) as want:
        joptim.make_optimizer("lion", 0.1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "adafactor"])
def test_optimizers_descend_quadratic(name):
    """The reference's own check, on the port."""
    opt = optim.make_optimizer(name, 0.1 if name != "adafactor" else 0.5)
    params = {"x": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(60):
        params, state = opt.update(params, {"x": 2 * params["x"]}, state)
    assert float(torch.sum(params["x"] ** 2)) < 0.5


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["chatglm3_6b", "internvl2_1b", "whisper_medium"])
def test_make_batch_matches_reference(arch):
    """Tokens, labels, prefix and encoder embeddings, bit for bit and in the
    reference's dtypes, for several (seed, index, host)."""
    jcfg, tcfg = jcb.get(arch).reduced(), cb.get(arch).reduced()
    for seed, index, host in [(0, 0, 0), (0, 7, 0), (3, 1, 2), (11, 250, 1)]:
        want = jlm.make_batch(jcfg, 3, 20, index, seed=seed, host=host)
        got = lm.make_batch(tcfg, 3, 20, index, seed=seed, host=host, device="cpu")
        assert sorted(got) == sorted(want)
        for key in want:
            assert str(got[key].dtype).split(".")[-1] == np.dtype(want[key].dtype).name
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    stream = lm.synthetic_batches(tcfg, 2, 8, seed=5, device="cpu")
    for i in range(3):
        b = next(stream)
        assert torch.equal(b["tokens"], lm.make_batch(tcfg, 2, 8, i, seed=5, device="cpu")["tokens"])


def test_shape_cells_match_reference():
    from repro.launch import shapes as jshapes
    assert shapes.SHAPES == {k: shapes.ShapeCell(**dataclasses.asdict(v))
                             for k, v in jshapes.SHAPES.items()}
    for arch in jcb.ASSIGNED_ARCHS:
        for s in shapes.SHAPES:
            assert shapes.cell_applicable(cb.get(arch), s) == \
                jshapes.cell_applicable(jcb.get(arch), s)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn((4, 8), generator=g), "b": torch.zeros((8,))},
            "step_arr": torch.tensor(3, dtype=torch.int32), "step": 7,
            "none": None}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(10, t, extra={"loss": 1.5})
    step, restored = mgr.restore_latest(_tree(1), device="cpu")
    assert step == 10 and restored["none"] is None
    _equal_trees(restored, t)
    assert mgr.manifest(10)["extra"]["loss"] == 1.5
    assert mgr.manifest(10)["names"] == ["layers/b", "layers/w", "step", "step_arr"]


def test_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [3, 4]
    stale = tmp_path / "tmp.9.123"
    stale.mkdir()
    os.utime(stale, (0, 0))
    mgr.save(5, _tree(5))
    assert not stale.exists() and mgr.steps() == [4, 5]


def test_corrupt_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    # corrupt step 2's arrays: manifest checksum no longer matches
    with open(os.path.join(str(tmp_path), "step_2", "arrays.npz"), "ab") as f:
        f.write(b"garbage")
    assert mgr.steps() == [1]
    step, _ = mgr.restore_latest(_tree(), device="cpu")
    assert step == 1
    with pytest.raises(FileNotFoundError):
        mgr.restore(2, _tree(), device="cpu")


def _trained_state(dtype):
    """(params, AdamW state) of reduced chatglm3_6b after one reference
    update, in the reference's types and in the port's."""
    jcfg, _, jp = _model("chatglm3_6b")
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    opt = joptim.adamw(1e-3, weight_decay=0.1)
    grads = jax.tree.map(lambda a: jnp.asarray(_rand(a.size, *a.shape, scale=0.1), a.dtype), jp)
    jp, js = opt.update(jp, grads, opt.init(jp))
    host = jax.tree.map(np.asarray, (jp, js))
    port = (lm_params_from_jax(host[0], "cpu"),
            {"step": int(host[1]["step"]), "m": lm_params_from_jax(host[1]["m"], "cpu"),
             "v": lm_params_from_jax(host[1]["v"], "cpu")})
    return (jp, js), port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, dtype):
    """The port restores, bit for bit, what the reference wrote, and writes
    the same names, dtypes, shapes and bits. The reference restores the
    port's fp32 checkpoint bit for bit; it restores no bf16 checkpoint at
    all, its own included (``astype`` of numpy's 2-byte void to bfloat16
    raises), so there the port's bits are held to the reference's file."""
    ref, port = _trained_state(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jmgr = JCheckpointManager(str(tmp_path / "ref"))
    tmgr = CheckpointManager(str(tmp_path / "port"))
    jmgr.save(3, ref)
    tmgr.save(3, port)
    got = tmgr.restore(3, port, device="cpu")
    back = jax.tree.map(np.asarray, ref)
    _equal_trees(got[0], lm_params_from_jax(back[0], "cpu"))
    assert got[1]["step"] == 1 and isinstance(got[1]["step"], int)
    _equal_trees({"m": got[1]["m"], "v": got[1]["v"]},
                 {k: lm_params_from_jax(back[1][k], "cpu") for k in ("m", "v")})
    jm, tm = jmgr.manifest(3), tmgr.manifest(3)
    for key in ("names", "dtypes", "shapes", "layout"):
        assert tm[key] == jm[key], key
    with np.load(tmp_path / "ref" / "step_3" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_3" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    like = jax.eval_shape(lambda: ref)
    if dtype == "float32":
        step, restored = JCheckpointManager(str(tmp_path / "port")).restore_latest(like)
        assert step == 3
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        for d in ("ref", "port"):
            with pytest.raises(ValueError, match="No cast function"):
                JCheckpointManager(str(tmp_path / d)).restore(3, like)


# ---------------------------------------------------------------------------
# Train step and launcher, against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture
def ref_launch(monkeypatch):
    """The reference's ``launch.steps`` and ``launch.train``, imported with
    stand-ins for the missing ``repro.dist`` (see the module docstring)."""
    dist = types.ModuleType("repro.dist")
    dist.sharding = types.ModuleType("repro.dist.sharding")
    monkeypatch.setitem(sys.modules, "repro.dist", dist)
    monkeypatch.setitem(sys.modules, "repro.dist.sharding", dist.sharding)
    import repro.launch
    from repro.launch import steps as jsteps, train as jtrain
    yield jsteps, jtrain
    for name in ("steps", "train"):
        sys.modules.pop(f"repro.launch.{name}", None)
        repro.launch.__dict__.pop(name, None)


@pytest.mark.parametrize("grad_accum, grad_dtype", [(1, None), (2, "bfloat16"), (2, None)])
def test_train_step_matches_reference(ref_launch, grad_accum, grad_dtype):
    """Three AdamW steps of reduced chatglm3_6b (batch 4): loss and
    parameters, microbatches summed in fp32, gradients optionally cast to
    bf16 before the update."""
    jsteps, _ = ref_launch
    jcfg, tcfg, jp = _model("chatglm3_6b")
    assert steps.OPTIMIZER_FOR_ARCH == jsteps.OPTIMIZER_FOR_ARCH
    assert steps.DEFAULT_LR == jsteps.DEFAULT_LR
    jname, jopt = jsteps.optimizer_for(jcfg)
    tname, topt = steps.optimizer_for(tcfg)
    assert tname == jname == "adamw"
    jfn = jax.jit(jsteps.make_train_step(
        jcfg, jopt, grad_accum=grad_accum,
        grad_dtype=None if grad_dtype is None else jnp.bfloat16))
    tfn = steps.make_train_step(tcfg, topt, grad_accum=grad_accum,
                                grad_dtype=None if grad_dtype is None else torch.bfloat16)
    tp = _port_params(jp)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(1, 4):
        jp, js, want = jfn(jp, js, jlm.make_batch(jcfg, 4, 16, i))
        tp, ts, got = tfn(tp, ts, lm.make_batch(tcfg, 4, 16, i, device="cpu"))
        np.testing.assert_allclose(_np(got), np.asarray(want), **_TOL)
    _close_params(tp, dict(jp), tcfg, 3)
    assert ts["step"] == 3
    assert steps.optimizer_for(cb.get("llama3_405b"))[0] == "adafactor"


def test_prefill_and_serve_steps_match_reference(ref_launch):
    jsteps, _ = ref_launch
    jcfg, tcfg, jp = _model("llama3_405b")
    jb = jlm.make_batch(jcfg, 2, 12, 0)
    want, wcache = jsteps.make_prefill_step(jcfg)(jp, jb)
    tp = _port_params(jp)
    got, cache = steps.make_prefill_step(tcfg)(tp, lm.make_batch(tcfg, 2, 12, 0, device="cpu"))
    np.testing.assert_allclose(_np(got), np.asarray(want), **_TOL)
    wcache = {k: jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]) for k, a in wcache.items()}
    cache = {k: torch.cat([a, a.new_zeros((*a.shape[:2], 1, *a.shape[3:]))], dim=2)
             for k, a in cache.items()}
    tok = np.array([[3], [5]], np.int32)
    want, _ = jsteps.make_serve_step(jcfg)(jp, wcache, jnp.asarray(tok), jnp.asarray(12, jnp.int32))
    got, _ = steps.make_serve_step(tcfg)(tp, cache, torch.from_numpy(tok), 12)
    np.testing.assert_allclose(_np(got), np.asarray(want), **_TOL)


def test_launcher_loop_matches_reference_main(ref_launch, tmp_path, monkeypatch):
    """Five steps of reduced chatglm3_6b: the reference's ``main`` (its
    default batch 8 x seq 64, weights from PRNGKey(0)) against the port's
    loop from the same weights. The step-1 loss the reference prints, and
    the parameters and AdamW state of the checkpoint it writes, read by the
    port's manager."""
    _, jtrain = ref_launch
    jcfg, tcfg, jp = _model("chatglm3_6b")
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "chatglm3_6b", "--steps", "5",
                                      "--ckpt-dir", str(tmp_path / "ref")])
    out = io.StringIO()
    with redirect_stdout(out):
        jtrain.main()
    printed = re.findall(r"\[train\] step\s+(\d+) loss ([0-9.]+)", out.getvalue())
    assert [int(s) for s, _ in printed] == [1]
    lines = []
    run = train.train_loop(tcfg, 8, 64, 5, ckpt_dir=str(tmp_path / "port"),
                           device="cpu", params=_port_params(jp), log=lines.append)
    assert run.steps == [1, 2, 3, 4, 5] and run.start == 0
    assert abs(run.losses[0] - float(printed[0][1])) <= 1e-4
    assert lines[0].startswith("[train] step     1 loss ") and lines[-1] == "[train] done"
    mgr = CheckpointManager(str(tmp_path / "ref" / tcfg.name))
    assert mgr.steps() == [5]
    params, state = mgr.restore(5, (run.params, run.opt_state), device="cpu")
    assert state["step"] == run.opt_state["step"] == 5
    _close_params(run.params, params, tcfg, 5)
    _close_trees(run.opt_state, state)
    mine = CheckpointManager(str(tmp_path / "port" / tcfg.name))
    assert mine.steps() == [5] and mine.manifest(5)["extra"]["loss"] == run.losses[-1]


def test_launcher_resumes_bit_for_bit(tmp_path, capsys):
    """``main`` for 4 steps (checkpoints at 2 and 4), then for 6: it resumes
    from 4, and steps 5 and 6 equal an uninterrupted 6-step run's, losses
    and parameters bit for bit."""
    args = ["--arch", "chatglm3_6b", "--ckpt-every", "2", "--device", "cpu",
            "--batch", "4", "--seq", "16"]
    first = train.main(args + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    assert first.steps == [1, 2, 3, 4]
    resumed = train.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert resumed.start == 4 and resumed.steps == [5, 6]
    whole = train.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b")])
    assert whole.losses[:4] == first.losses
    assert whole.losses[4:] == resumed.losses
    _equal_trees(resumed.params, whole.params)
    _equal_trees(resumed.opt_state, whole.opt_state)
    assert CheckpointManager(str(tmp_path / "a" / "chatglm3_6b-smoke")).steps() == [2, 4, 6]


def test_launcher_defaults_to_the_card():
    """No fallback: without a card the default device fails."""
    cfg = cb.get("chatglm3_6b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            train.train_loop(cfg, 2, 8, 1, ckpt_dir=None)
    else:
        assert train.train_loop(cfg, 2, 8, 1, ckpt_dir=None).params["embed"]["emb"].is_cuda


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["none", "no step", "step reversed", "step 2% short",
                                   "gradient 1e-3 off"])
def test_card_check_of_a_train_step_catches_a_wrong_step(fault):
    """``chip_smoke.py`` phase 11 (a)'s comparison of the card with the
    CPU port, both sides here on the CPU at the reduced chatglm3_6b, one
    AdamW step from the same gradients: a right step passes; a missing,
    reversed or 2% short parameter step, or gradients 1e-3 off, fails its
    tolerance."""
    smoke = _chip_smoke()
    _, tcfg, jp = _model("chatglm3_6b")
    params = _port_params(jp)
    _, grads = steps.value_and_grad(params, tcfg, lm.make_batch(tcfg, 2, 16, 0, device="cpu"))
    _, opt = steps.optimizer_for(tcfg)
    want, _ = opt.update(params, grads, opt.init(params))
    got, got_grads = want, grads
    if fault == "no step":
        got = params
    elif fault == "step reversed":
        got = optim.tree_map(lambda p, w: 2 * p - w, params, want)
    elif fault == "step 2% short":
        got = optim.tree_map(lambda p, w: p + 0.98 * (w - p), params, want)
    elif fault == "gradient 1e-3 off":
        got_grads = optim.tree_map(lambda g: g * (1 + 1e-3), grads)
    g_err = smoke.train_grad_err(got_grads, grads)
    step_err = smoke.train_step_err(params, got, params, want, steps.DEFAULT_LR)
    ok = g_err <= smoke.TRAIN_GRAD_RTOL and step_err <= smoke.TRAIN_STEP_TOL
    assert ok == (fault == "none"), (g_err, step_err)
