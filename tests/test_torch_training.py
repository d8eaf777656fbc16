"""The port's training of the performance models against the reference on
identical numpy inputs: the AdamW/Adam update, the masked MSE and its
gradient, the ``train_mlp`` trajectory from a common initialisation (cold
and fine-tuned), ``fit_perf_model`` for lin / nn2 / nn1, and the platform
verbs that train (cold ``pretrain``, ``calibrate`` in finetune / scratch /
auto mode, a cold ``optimise``) with their stores read across the two
packages.

Tolerances: the optimizer update is float32 arithmetic in the same order,
held at 1e-6 relative; a trajectory from the same parameters at 1e-4
relative (measured ~2e-6 over 100 nn1 steps and 40 nn2 steps: only the
GEMMs' summation order differs, and Adam amplifies that over longer runs). Cold fits cannot equal JAX's
(``jax.random`` draws its initial parameters), so they are held to the
reference test's thresholds and to a band around JAX's MdRAE on the same
split. ``lin`` is numpy in both packages: fingerprints equal. No test
writes under ``artifacts/``: every store is in ``tmp_path``.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perfmodel as JM
from repro.service import artifacts as JA
from repro.service import pipeline as JPL
from repro.service import platforms as JPF
from repro.train import optim as JO
from repro_torch import convert
from repro_torch.core import perfmodel as TM
from repro_torch.service import artifacts as TA
from repro_torch.service import pipeline as TPL
from repro_torch.service import platforms as TPF
from repro_torch.train import optim as TO

OPT_RTOL = 1e-6
TRAJ_RTOL = 1e-4
NN2_SIZES = (5,) + TM.NN2_HIDDEN + (3,)


def _synthetic(rng, n=400, noise=0.0):
    """The reference test's monomial runtime surfaces
    (``tests/test_perfmodel.py``): t_j = c_j * prod feats^a, 10% NaN."""
    feats = np.exp(rng.uniform(0, 3, (n, 5)))
    coef = rng.uniform(0.5, 2.0, (5, 3))
    times = np.exp(np.log(feats) @ coef) * 1e-6
    if noise:
        times *= np.exp(rng.normal(0, noise, times.shape))
    times[rng.random((n, 3)) < 0.1] = np.nan
    return feats, times


def _normalised(seed=1):
    """(x_train, y_train, x_val, y_val) of the synthetic surface in the
    reference's normalised space, as ``fit_perf_model`` feeds ``train_mlp``."""
    f, t = _synthetic(np.random.default_rng(seed), noise=0.02)
    in_n, out_n, xt, yt = JM._prep(f[:300], t[:300])
    return xt, yt, in_n.transform(f[300:350]), out_n.transform(t[300:350])


def _to_np(tree):
    return [{k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
             for k, v in layer.items()} for layer in tree]


def _hold_tree(got, want, rtol, atol):
    for g, w in zip(_to_np(got), _to_np(want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# train/optim.py
# ---------------------------------------------------------------------------

def _opt_pair(kind):
    lr = lambda step: 1e-2 / (1.0 + 0.1 * step)
    if kind == "adamw":
        kw = dict(weight_decay=1e-2, clip_norm=0.5)
        return JO.adamw(lr, **kw), TO.adamw(lr, **kw)
    if kind == "adam":
        return JO.adam(3e-3), TO.adam(3e-3)
    return (JO.adamw(JO.constant_schedule(1e-3), weight_decay=1e-5),
            TO.adamw(TO.constant_schedule(1e-3), weight_decay=1e-5))


@pytest.mark.parametrize("steps", [1, 50])
@pytest.mark.parametrize("kind", ["adamw", "adam", "constant"])
def test_optimizer_matches_reference(kind, steps):
    """Params, m and v after ``steps`` updates from the same params and
    the same gradient sequence: within 1e-6 relative of the reference."""
    rng = np.random.default_rng(7)
    shapes = [(5, 8), (8,), (8, 3), (3,)]
    p0 = [{"w": rng.standard_normal(shapes[0]).astype(np.float32),
           "b": rng.standard_normal(shapes[1]).astype(np.float32)},
          {"w": rng.standard_normal(shapes[2]).astype(np.float32),
           "b": rng.standard_normal(shapes[3]).astype(np.float32)}]
    grads = [[{k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
               for k, v in layer.items()} for layer in p0] for _ in range(steps)]
    jopt, topt = _opt_pair(kind)
    jp = [{k: jnp.asarray(v) for k, v in l.items()} for l in p0]
    tp = convert.mlp_params_from_jax(p0, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jp, [{k: jnp.asarray(v) for k, v in l.items()} for l in g], js)
        tp, ts = topt.update(tp, convert.mlp_params_from_jax(g, device="cpu"), ts)
    assert ts["step"] == int(js["step"]) == steps
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        _hold_tree(got, want, rtol=OPT_RTOL, atol=1e-7)
    assert all(t.dtype == torch.float32 for t in TO.tree_leaves(ts["m"]))


def test_update_leaves_its_inputs_alone():
    """``update`` returns new tensors; the caller's params are not written."""
    p = [{"w": torch.ones(3, 2), "b": torch.zeros(2)}]
    opt = TO.adamw(0.1, weight_decay=0.1)
    new, _ = opt.update(p, [{"w": torch.ones(3, 2), "b": torch.ones(2)}], opt.init(p))
    assert torch.equal(p[0]["w"], torch.ones(3, 2)) and not torch.equal(new[0]["w"], p[0]["w"])


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    tree = [{"w": rng.standard_normal((4, 6)).astype(np.float32),
             "b": rng.standard_normal(6).astype(np.float32)}]
    jt = [{k: jnp.asarray(v) for k, v in l.items()} for l in tree]
    tt = convert.mlp_params_from_jax(tree, device="cpu")
    np.testing.assert_allclose(float(TO.global_norm(tt)), float(JO.global_norm(jt)),
                               rtol=OPT_RTOL)
    for max_norm in (0.5, 100.0):
        _hold_tree(TO.clip_by_global_norm(tt, max_norm),
                   JO.clip_by_global_norm(jt, max_norm), rtol=OPT_RTOL, atol=0)


# ---------------------------------------------------------------------------
# masked MSE, init
# ---------------------------------------------------------------------------

def test_masked_mse_value_and_grad_match_reference():
    """Value and gradient against ``jax.value_and_grad`` within 1e-6; a
    column masked everywhere gets exactly zero gradient in its head, and
    the gradient at every masked label is exactly zero."""
    rng = np.random.default_rng(11)
    sizes = (5, 16, 3)
    jp = JM.init_mlp(jax.random.PRNGKey(2), sizes)
    x = rng.standard_normal((40, 5)).astype(np.float32)
    y = rng.standard_normal((40, 3)).astype(np.float32)
    y[rng.random(y.shape) < 0.3] = np.nan
    y[:, 2] = np.nan
    mask = np.isfinite(y).astype(np.float32)
    y0 = np.nan_to_num(y, nan=0.0)
    jv, jg = jax.value_and_grad(JM.masked_mse)(jp, x, y0, mask)
    tp = convert.mlp_params_from_jax([{k: np.asarray(v) for k, v in l.items()} for l in jp],
                                     device="cpu")
    for t in TO.tree_leaves(tp):
        t.requires_grad_(True)
    ty = torch.from_numpy(y0).requires_grad_(True)
    tv = TM.masked_mse(tp, torch.from_numpy(x), ty, torch.from_numpy(mask))
    grads = torch.autograd.grad(tv, TO.tree_leaves(tp) + [ty])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    it = iter(grads)
    tg = TO.tree_map(lambda _: next(it), tp)
    _hold_tree(tg, jg, rtol=1e-6, atol=1e-7)
    assert torch.all(tg[-1]["w"][:, 2] == 0) and tg[-1]["b"][2] == 0
    assert torch.all(grads[-1][mask == 0] == 0)
    assert torch.any(grads[-1][mask == 1] != 0)


def test_init_mlp_he_normal_from_a_cpu_generator():
    """He normal, zero bias, (fan_in, fan_out); the same generator seed
    draws the same parameters, and each nn1 column has its own stream."""
    sizes = (5, 128, 512, 3)
    a = TM.init_mlp(sizes, generator=TM.generator_for(4), device="cpu")
    b = TM.init_mlp(sizes, generator=TM.generator_for(4), device="cpu")
    for la, lb, (fi, fo) in zip(a, b, zip(sizes[:-1], sizes[1:])):
        assert la["w"].shape == (fi, fo) and la["w"].dtype == torch.float32
        assert torch.equal(la["w"], lb["w"]) and not la["b"].any()
    std = float(a[1]["w"].std())
    assert abs(std - np.sqrt(2.0 / 128)) < 0.05 * np.sqrt(2.0 / 128)
    cols = [TM.init_mlp((5, 4), generator=TM.generator_for(0, j), device="cpu")[0]["w"]
            for j in range(3)]
    assert not torch.equal(cols[0], cols[1]) and not torch.equal(cols[1], cols[2])
    assert not torch.equal(TM.generator_for(0, 0).initial_seed() * torch.ones(1),
                           TM.generator_for(1, 0).initial_seed() * torch.ones(1))


def test_mlp_params_from_jax_round_trip():
    jp = JM.init_mlp(jax.random.PRNGKey(5), (5, 8, 2))
    tp = convert.mlp_params_from_jax(jp, device="cpu")
    back = _to_np(tp)
    for g, w in zip(back, jp):
        for k in ("w", "b"):
            assert np.array_equal(g[k], np.asarray(w[k]))
    nested = convert.mlp_params_from_jax([jp, jp], device="cpu")
    assert len(nested) == 2 and torch.equal(nested[1][0]["w"], tp[0]["w"])
    again = convert.mlp_params_from_jax(back, device="cpu")
    assert all(torch.equal(a[k], b[k]) for a, b in zip(again, tp) for k in "wb")


# ---------------------------------------------------------------------------
# train_mlp: the trajectory from a common initialisation
# ---------------------------------------------------------------------------

def _hold_trajectory(got, want):
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.train_losses, want.train_losses, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(got.best_val, want.best_val, rtol=TRAJ_RTOL)
    _hold_tree(got.params, want.params, rtol=TRAJ_RTOL, atol=TRAJ_RTOL)


@pytest.mark.parametrize("arch", ["nn1", "nn2"])
def test_train_mlp_trajectory_matches_reference(arch):
    """From JAX's ``init_mlp`` carried over through numpy, eval every 20:
    losses, iterations and best parameters. nn1 widths (lr 3e-3) run 100
    steps; nn2 widths (lr 1e-3) run 40, inside the horizon where the
    reference's own trajectory is stable: JAX against JAX with x_train
    moved by one ulp differs by ~4e-5 at step 40 and 3-7e-4 from step 70
    (full batch), so no port could be held to 1e-4 past it."""
    xt, yt, xv, yv = _normalised()
    if arch == "nn1":
        sizes, kw, steps = (5,) + TM.NN1_HIDDEN + (3,), dict(lr=3e-3, weight_decay=0.0), 100
    else:
        sizes, kw, steps = NN2_SIZES, dict(lr=1e-3, weight_decay=1e-5), 40
    init = JM.init_mlp(jax.random.PRNGKey(3), sizes)
    want = JM.train_mlp(jax.random.PRNGKey(0), sizes, xt, yt, xv, yv,
                        max_iters=steps, init_params=init, **kw)
    got = TM.train_mlp(sizes, xt, yt, xv, yv, max_iters=steps, device="cpu",
                       init_params=convert.mlp_params_from_jax(init, device="cpu"),
                       **kw)
    assert len(got.val_losses) == 1 + steps // 20
    _hold_trajectory(got, want)


def test_finetune_trajectory_matches_reference():
    """A JAX-trained NN2 carried over by ``convert.perfmodel_from_state``
    and fine-tuned in both packages (10x lower lr): the same trajectory,
    the caller's base left untouched, and through ``fit_perf_model(base=)``
    the same model."""
    f, t = _synthetic(np.random.default_rng(1), noise=0.02)
    jbase = JM.fit_perf_model("nn2", f[:300], t[:300], f[300:350], t[300:350],
                              max_iters=60, patience=40)
    tbase = convert.perfmodel_from_state(jbase.to_state(), device="cpu")
    before = [l["w"].clone() for l in tbase.params]
    target = t[:120] * np.array([2.0, 0.5, 3.0])          # a "new platform"
    _, _, xt, yt = JM._prep(f[:120], target, jbase.in_norm, jbase.out_norm)
    xv, yv = jbase.in_norm.transform(f[300:350]), jbase.out_norm.transform(t[300:350] * [2.0, 0.5, 3.0])
    want = JM.train_mlp(None, NN2_SIZES, xt, yt, xv, yv, lr=1e-4,
                        max_iters=100, init_params=jbase.params)
    got = TM.train_mlp(NN2_SIZES, xt, yt, xv, yv, lr=1e-4, max_iters=100,
                       init_params=tbase.params, device="cpu")
    _hold_trajectory(got, want)
    assert all(torch.equal(a, l["w"]) for a, l in zip(before, tbase.params))
    jft = JM.fit_perf_model("nn2", f[:120], target, f[300:350], t[300:350] * [2.0, 0.5, 3.0],
                            base=jbase, max_iters=100)
    tft = TM.fit_perf_model("nn2", f[:120], target, f[300:350], t[300:350] * [2.0, 0.5, 3.0],
                            base=tbase, max_iters=100, device="cpu")
    np.testing.assert_allclose(tft.predict(f[350:]), jft.predict(f[350:]), rtol=TRAJ_RTOL)


def test_train_mlp_returns_the_best_not_the_last_parameters():
    """With a learning rate that makes the validation loss climb after its
    best, the returned parameters score the best validation loss, not the
    last one (the best parameters are cloned, not aliased)."""
    xt, yt, xv, yv = _normalised()
    sizes = (5,) + TM.NN1_HIDDEN + (3,)
    res = TM.train_mlp(sizes, xt, yt, xv, yv, lr=0.05, max_iters=400,
                       patience=1000, eval_every=5, device="cpu")
    assert res.val_losses[-1] > res.best_val * 1.01
    mv = torch.from_numpy(np.isfinite(yv).astype(np.float32))
    with torch.no_grad():
        got = float(TM.masked_mse(res.params, torch.from_numpy(xv),
                                  torch.from_numpy(np.nan_to_num(yv)), mv))
    np.testing.assert_allclose(got, res.best_val, rtol=1e-6)


# ---------------------------------------------------------------------------
# fit_perf_model
# ---------------------------------------------------------------------------

def test_lin_fingerprint_matches_reference():
    for seed in (0, 3):
        f, t = _synthetic(np.random.default_rng(seed))
        want = JM.fit_perf_model("lin", f[:300], t[:300], f[300:], t[300:])
        got = TM.fit_perf_model("lin", f[:300], t[:300], f[300:], t[300:], device="cpu")
        assert got.fingerprint() == want.fingerprint()
        assert got.mdrae(f[300:], t[300:]) < 0.01


def test_nn2_cold_fit_within_band_of_reference():
    """The reference test's setting (``test_nn2_fits_and_beats_chance``):
    MdRAE < 0.2, and within 1.5x + 0.02 of JAX's on the same split."""
    f, t = _synthetic(np.random.default_rng(1), noise=0.02)
    args = (f[:300], t[:300], f[300:350], t[300:350])
    got = TM.fit_perf_model("nn2", *args, max_iters=1500, patience=150, device="cpu")
    want = JM.fit_perf_model("nn2", *args, max_iters=1500, patience=150)
    err, ref = got.mdrae(f[350:], t[350:]), want.mdrae(f[350:], t[350:])
    assert err < 0.2, err
    assert err <= 1.5 * ref + 0.02, (err, ref)
    assert got.device.type == "cpu" and got.n_outputs == 3


def test_nn1_cold_fit_within_band_of_reference():
    """nn1 on the same surface, seeds 0-2 in both packages: the mean MdRAE
    within 1.5x + 0.02 of JAX's. A single nn1 fit is ruled by its
    initialisation (three 5-16-64-64-16-1 nets; JAX's seeds 0-5 span
    0.12-0.20 on this surface), so the band holds the mean over seeds; from
    one common initialisation the trajectories agree to 1e-6."""
    f, t = _synthetic(np.random.default_rng(1), noise=0.02)
    args = (f[:300], t[:300], f[300:350], t[300:350])
    errs = {"port": [], "ref": []}
    for seed in range(3):
        got = TM.fit_perf_model("nn1", *args, seed=seed, max_iters=300,
                                patience=150, device="cpu")
        want = JM.fit_perf_model("nn1", *args, seed=seed, max_iters=300, patience=150)
        errs["port"].append(got.mdrae(f[350:], t[350:]))
        errs["ref"].append(want.mdrae(f[350:], t[350:]))
    assert len(got.params) == 3
    assert np.mean(errs["port"]) <= 1.5 * np.mean(errs["ref"]) + 0.02, errs


def test_nn1_sparse_column_keeps_its_init():
    """The reference's quirk: a column with fewer than 8 defined rows keeps
    an untrained ``init_mlp`` (from the port's generator for that column),
    while the other columns train."""
    f, t = _synthetic(np.random.default_rng(2))
    t[:, 1] = np.nan
    t[:5, 1] = 1e-4 * np.arange(1, 6)
    m = TM.fit_perf_model("nn1", f[:200], t[:200], f[200:], t[200:], seed=4,
                          max_iters=40, device="cpu")
    sizes = (5,) + TM.NN1_HIDDEN + (1,)
    init = lambda j: TM.init_mlp(sizes, generator=TM.generator_for(4, j), device="cpu")
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m.params[1], init(1)) for k in "wb")
    assert not torch.equal(m.params[0][0]["w"], init(0)[0]["w"])


def test_unknown_kind_raises():
    f, t = _synthetic(np.random.default_rng(0), n=40)
    with pytest.raises(ValueError, match="unknown perf model kind"):
        TM.fit_perf_model("nn3", f, t, f, t, device="cpu")


# ---------------------------------------------------------------------------
# Platform verbs that train, and the store across the packages
# ---------------------------------------------------------------------------

SMALL = dict(max_triplets=4)


def test_cold_pretrain_stores_and_warm_loads(tmp_path):
    store = TA.ArtifactStore(str(tmp_path), device="cpu")
    arm = TPF.get_platform("arm", **SMALL)
    cold = arm.pretrain("nn2", store=store, max_iters=40)
    assert not cold.warm and cold.mode == "native"
    assert cold.prim.kind == "nn2" and cold.dlt.kind == "lin"
    assert cold.prim.device.type == "cpu"
    warm = TPF.get_platform("arm", **SMALL).pretrain("nn2", store=store, max_iters=40)
    assert warm.warm and warm.fingerprint() == cold.fingerprint()
    assert len(store.entries("models")) == 2
    # no store: trains on the explicit device; with one, on the store's
    bare = TPF.get_platform("arm", **SMALL).pretrain("lin", device="cpu")
    assert not bare.warm and bare.prim.device.type == "cpu"
    other = arm.pretrain("lin", store=store, device="meta")
    assert not other.warm and other.prim.device.type == "cpu"


def test_store_interchange_with_reference(tmp_path):
    """A model the reference trained and stored warm-loads in the port at
    the same address, and one the port trained warm-loads in the
    reference."""
    jplat, tplat = JPF.get_platform("amd", **SMALL), TPF.get_platform("amd", **SMALL)
    ref = jplat.pretrain("nn2", store=JA.ArtifactStore(str(tmp_path / "a")), max_iters=30)
    port = tplat.pretrain("nn2", store=TA.ArtifactStore(str(tmp_path / "a"), device="cpu"),
                          max_iters=30)
    assert port.warm and port.fingerprint() == ref.fingerprint()
    port = tplat.pretrain("nn2", seed=1, store=TA.ArtifactStore(str(tmp_path / "b"),
                                                                device="cpu"), max_iters=30)
    ref = jplat.pretrain("nn2", seed=1, store=JA.ArtifactStore(str(tmp_path / "b")),
                         max_iters=30)
    assert not port.warm and ref.warm and ref.fingerprint() == port.fingerprint()


@pytest.fixture(scope="module")
def intel_base():
    """An intel NN2 base trained by the reference, and the port's copy."""
    j = JPF.get_platform("intel", **SMALL).pretrain("nn2", max_iters=60)
    return j, TPF.PlatformModels(convert.perfmodel_from_state(j.prim.to_state(), "cpu"),
                                 convert.perfmodel_from_state(j.dlt.to_state(), "cpu"),
                                 j.platform, "native")


@pytest.mark.parametrize("mode,budget,resolved", [
    ("finetune", 24, "finetune"), ("scratch", 24, "scratch"),
    ("auto", 24, "finetune"), ("auto", 16, "factor")])
def test_calibrate_modes(mode, budget, resolved, intel_base, tmp_path):
    """intel -> arm in every mode; ``auto`` resolves to finetune at 24 rows
    or more, as in the reference. A fine-tune starts from the base and
    follows the reference's (the same sample, normalizers and minibatches);
    scratch trains a new net on the sample alone."""
    jbase, tbase = intel_base
    store = TA.ArtifactStore(str(tmp_path), device="cpu")
    arm = TPF.get_platform("arm", **SMALL)
    got = arm.calibrate(tbase, budget, mode=mode, store=store, max_iters=60)
    want = JPF.get_platform("arm", **SMALL).calibrate(jbase, budget, mode=mode, max_iters=60)
    assert got.mode == want.mode == resolved and got.budget == want.budget
    assert got.prim.device.type == "cpu" and not got.warm
    feats = arm.primitive_dataset().feats
    if resolved == "scratch":
        assert got.prim.kind == "nn2" and got.prim.out_norm is not tbase.prim.out_norm
    else:
        np.testing.assert_allclose(got.prim.predict(feats), want.prim.predict(feats),
                                   rtol=TRAJ_RTOL)
    again = arm.calibrate(tbase, budget, mode=mode, store=store, max_iters=60)
    assert again.warm and again.fingerprint() == got.fingerprint()


def test_cold_optimise_trains_and_selects(tmp_path):
    """A cold ``optimise`` trains its models into the store and returns a
    runnable assignment; the reference then warm-loads the port's models
    and selection from the same store and agrees."""
    store = TA.ArtifactStore(str(tmp_path), device="cpu")
    opt = TPL.optimise("edge_cnn", "arm", store=store, max_iters=40,
                       executable=True, **SMALL)
    assert not opt.warm_models and not opt.warm_selection
    convs = [i for i, n in enumerate(opt.spec.nodes) if hasattr(n, "k")]
    assert set(convs) <= set(opt.assignment)
    ref = JPL.optimise("edge_cnn", "arm", store=JA.ArtifactStore(str(tmp_path)),
                       max_iters=40, executable=True, **SMALL)
    assert ref.warm_models and ref.warm_selection and ref.assignment == opt.assignment
