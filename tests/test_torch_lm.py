"""The port's LM decode path (``repro_torch.models.{components,transformer}``,
``configs``, ``launch.lm_decode``) against the JAX reference, on the CPU.

Inputs are made with numpy from a seed; weights cross from the reference's
``init_params(PRNGKey(0), cfg.reduced())`` by ``convert.lm_params_from_jax``
(the two packages' generators differ, so a seed cannot carry them).
Tolerance: the reference's fp32 ``_TOL`` (1e-4) for every function held to
JAX, and its own 3e-3 for the teacher-forced decode against a full prefill.
On the CPU ``attention`` runs the torch port of the reference's ``jnp`` code;
the glue that puts prefill attention on the flash kernel on the card is
held here through the kernel's plain version.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import components as JC
from repro.models import transformer as JT
from repro_torch.configs import base as cb
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import lm_decode
from repro_torch.models import components as C
from repro_torch.models import transformer as T

_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=3e-3, atol=3e-3)     # tests/test_models.py's own bound
DENSE = ("chatglm3_6b", "llama3_405b", "internvl2_1b", "gemma2_27b")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=_TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "param_dtype":
            v = str(v).split(".")[-1] if isinstance(v, torch.dtype) else np.dtype(v).name
        elif dataclasses.is_dataclass(v):
            v = (type(v).__name__, dataclasses.asdict(v))
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", jcb.ASSIGNED_ARCHS)
def test_config_equals_reference(arch):
    """Field for field at full size and reduced, with the same parameter
    counts (and the SSM config's derived sizes)."""
    assert cb.ASSIGNED_ARCHS == jcb.ASSIGNED_ARCHS
    want, got = jcb.get(arch), cb.get(arch)
    assert got is cb.get(arch.replace("_", "-"))
    assert _fields(got) == _fields(want)
    assert _fields(got.reduced()) == _fields(want.reduced())
    assert got.param_dtype == torch.bfloat16 and got.reduced().param_dtype == torch.float32
    assert got.hd == want.hd
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    assert got.reduced().n_params() == want.reduced().n_params()
    if want.ssm is not None:
        assert got.ssm.d_inner(want.d_model) == want.ssm.d_inner(want.d_model)
        assert got.ssm.n_heads(want.d_model) == want.ssm.n_heads(want.d_model)
    assert [c.name for c in cb.all_assigned()] == [c.name for c in jcb.all_assigned()]


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "rmsnorm1p", "layernorm"])
def test_norms_match_reference(kind):
    x, s, b = _rand(0, 2, 5, 64, scale=3.0), _rand(1, 64), _rand(2, 64)
    (jx, tx), (js, ts), (jb, tb) = _both(x), _both(s), _both(b)
    if kind == "layernorm":
        want = JC.layernorm({"scale": js, "bias": jb}, jx + 1.5)
        got = C.layernorm({"scale": ts, "bias": tb}, tx + 1.5)
    else:
        want = JC.rmsnorm({"scale": js}, jx, 1e-6, plus_one=kind == "rmsnorm1p")
        got = C.rmsnorm({"scale": ts}, tx, 1e-6, plus_one=kind == "rmsnorm1p")
    _close(got, want)


@pytest.mark.parametrize("rot_dim", [None, 8, 4])
def test_apply_rope_matches_reference(rot_dim):
    """Interleaved pairs of the first ``rot_dim`` dims, positions offset."""
    (jx, tx) = _both(_rand(3, 2, 7, 3, 16))
    pos = np.arange(7, dtype=np.int32) + 5
    want = JC.apply_rope(jx, jnp.asarray(pos), 10000.0, rot_dim)
    got = C.apply_rope(tx, torch.from_numpy(pos).long(), 10000.0, rot_dim)
    _close(got, want)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act, gated):
    p = {"w_up": {"w": _rand(4, 32, 48, scale=0.2)},
         "w_down": {"w": _rand(5, 48, 32, scale=0.2)}}
    if gated:
        p["w_gate"] = {"w": _rand(6, 32, 48, scale=0.2)}
    jp = jax.tree.map(jnp.asarray, p)
    tp = lm_params_from_jax(p, "cpu")
    jx, tx = _both(_rand(7, 2, 3, 32))
    _close(C.mlp(tp, tx, act), JC.mlp(jp, jx, act))


# (B, Sq, Sk, Hq, Hkv, hd, q_pos offset, keyword arguments)
ATTENTION = {
    "one_shot": (2, 24, 24, 4, 2, 16, 0, {}),
    "blockwise": (1, 2112, 2112, 2, 1, 8, 0, dict(kv_block=64)),
    "decode": (2, 1, 20, 4, 2, 16, 13, {}),
    "decode_softcap_window": (2, 1, 20, 4, 1, 16, 17, dict(softcap=2.0, window=6)),
    "softcap": (2, 24, 24, 4, 2, 16, 0, dict(softcap=2.0)),
    "window": (2, 24, 24, 4, 2, 16, 0, dict(window=5)),
    "non_causal": (2, 6, 10, 4, 4, 16, 0, dict(causal=False)),
}


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_attention_matches_reference(case):
    B, Sq, Sk, Hq, Hkv, hd, off, kw = ATTENTION[case]
    q, k, v = _rand(8, B, Sq, Hq, hd, scale=2.0), _rand(9, B, Sk, Hkv, hd), _rand(10, B, Sk, Hkv, hd)
    qp = np.arange(Sq, dtype=np.int32) + off
    kp = np.arange(Sk, dtype=np.int32)
    want = JC.attention(*map(jnp.asarray, (q, k, v, qp, kp)), **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tqp = torch.from_numpy(qp).long()
    tkp = tqp if Sq == Sk else torch.from_numpy(kp).long()
    got = C.attention(tq, tk, tv, tqp, tkp, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_route_matches_reference_attention(hd):
    """The kernel route's glue (q scaled then upcast, K/V repeated to the
    query heads, heads folded into the batch dim, the kernel at scale 1,
    unfolded) at a ragged length, through the kernel's plain version on the
    CPU; the route takes exactly the calls the kernel computes, causal or
    not (an encoder's self-attention), never cross-attention."""
    B, S, Hq, Hkv = 2, 37, 8, 2
    q, k, v = _rand(11, B, S, Hq, hd), _rand(12, B, S, Hkv, hd), _rand(13, B, S, Hkv, hd)
    pos = np.arange(S, dtype=np.int32)
    want = JC.attention(*map(jnp.asarray, (q, k, v, pos, pos)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = C._flash_route(tq, tk, tv, hd ** -0.5)
    _close(got, want)
    tp = torch.from_numpy(pos).long()

    class OnCard:                      # a CUDA operand's flags and shape, no card
        is_cuda, shape, requires_grad = True, tq.shape, False

    def routed(kp, v=tv, **kw):
        kw = {**dict(causal=True, window=None, softcap=None), **kw}
        return C.flash_routed(OnCard, tk, v, tp, kp, **kw)

    assert not C.flash_routed(tq, tk, tv, tp, tp, causal=True, window=None,
                              softcap=None)                 # CPU tensors
    assert routed(tp) and routed(tp, window=S) and routed(tp, causal=False)
    for kp, kw in [(tp.clone(), {}), (tp.clone(), dict(causal=False)),
                   (tp, dict(window=S - 1)), (tp, dict(softcap=50.0)),
                   (tp, dict(v=tv[..., :hd // 2]))]:
        assert not routed(kp, **kw)


# ---------------------------------------------------------------------------
# The model: init, forward, prefill, decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch, window=None):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced config, weights from the reference's init at PRNGKey(0)."""
    jcfg, tcfg = jcb.get(arch).reduced(), cb.get(arch).reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, window=window)
        tcfg = dataclasses.replace(tcfg, window=window)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, B=2, S=24, seed=20):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    prefix = _rand(seed + 1, B, 8, cfg.d_model, scale=0.1) if cfg.prefix_tokens else None
    return tokens, prefix


def _t(a):
    return None if a is None else torch.from_numpy(a).long() if a.dtype == np.int32 \
        else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_layout_matches_reference(arch):
    """The port's own init: the reference's keys, stacked shapes and dtypes;
    and the reference's bfloat16 arrays cross bit for bit."""
    jcfg, tcfg, jp, _ = _model(arch)
    mine = T.init_params(torch.Generator().manual_seed(0), tcfg)
    flat = lambda tree: {jax.tree_util.keystr(p): a for p, a in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    want, got = flat(jp), flat(mine)
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        assert tuple(got[key].shape) == a.shape, key
        assert str(got[key].dtype).split(".")[-1] == np.dtype(a.dtype).name, key
    bf = JT.init_params(jax.random.PRNGKey(1),
                        dataclasses.replace(jcfg, param_dtype=jnp.bfloat16))
    crossed = lm_params_from_jax(jax.tree.map(np.asarray, bf), "cpu")
    w = crossed["layers"]["attn"]["wq"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(bf["layers"]["attn"]["wq"]["w"], np.float32))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch):
    """Last-position logits and the whole K/V cache."""
    jcfg, tcfg, jp, tp = _model(arch)
    tokens, prefix = _inputs(jcfg)
    want, wcache = jax.jit(lambda p: JT.prefill(p, jcfg, _j(tokens), prefix_embeds=_j(prefix)))(jp)
    got, cache = T.prefill(tp, tcfg, _t(tokens), prefix_embeds=_t(prefix))
    assert got.dtype == torch.float32 and got.shape == (2, tcfg.vocab)
    _close(got, want)
    assert sorted(cache) == sorted(wcache) == ["k", "v"]
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == wcache[name].shape
        _close(cache[name], wcache[name])


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    tokens, prefix = _inputs(jcfg, seed=30)
    want, waux = jax.jit(lambda p: JT.forward(p, jcfg, _j(tokens), prefix_embeds=_j(prefix)))(jp)
    got, aux = T.forward(tp, tcfg, _t(tokens), prefix_embeds=_t(prefix))
    _close(got, want)
    assert float(aux) == float(waux) == 0.0


def _grow_ref(cache, extra):
    pad = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
    return {k: pad(a) for k, a in cache.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(arch):
    """Prefill, grow the cache by 4, then 4 teacher-forced decode steps:
    logits at every step and the cache after the last."""
    jcfg, tcfg, jp, tp = _model(arch)
    tokens, prefix = _inputs(jcfg, S=28, seed=40)
    _, wcache = jax.jit(lambda p: JT.prefill(p, jcfg, _j(tokens[:, :24]),
                                             prefix_embeds=_j(prefix)))(jp)
    _, cache = T.prefill(tp, tcfg, _t(tokens[:, :24]), prefix_embeds=_t(prefix))
    S = cache["k"].shape[2]
    wcache, cache = _grow_ref(wcache, 4), lm_decode.grow_cache(cache, 4)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    for i in range(4):
        tok = tokens[:, 24 + i:25 + i]
        want, wcache = step(jp, wcache, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        got, cache = T.decode_step(tp, tcfg, cache, _t(tok), S + i)
        _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], wcache[name])


def test_ring_cache_matches_reference():
    """chatglm3_6b reduced with window 16 and a 16-slot cache: a ring,
    decoded from empty past its length (wrap, never-written sentinels)."""
    jcfg, tcfg, jp, tp = _model("chatglm3_6b", window=16)
    wcache = JT.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    cache = T.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    assert tuple(cache["k"].shape) == wcache["k"].shape == (4, 2, 16, 2, 16)
    tokens, _ = _inputs(jcfg, S=21, seed=50)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    for pos in range(21):
        tok = tokens[:, pos:pos + 1]
        want, wcache = step(jp, wcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        got, cache = T.decode_step(tp, tcfg, cache, _t(tok), pos)
        _close(got, want)
    _close(cache["k"], wcache["k"])


@pytest.mark.parametrize("arch", DENSE)
def test_teacher_forced_decode_matches_full_prefill(arch):
    """The port on its own, as tests/test_models.py holds the reference:
    prefill 4 tokens, step tokens 4..7, the last logits against a full
    prefill of all 8 (weights from PRNGKey(1))."""
    tcfg = cb.get(arch).reduced()
    jp = JT.init_params(jax.random.PRNGKey(1), jcb.get(arch).reduced())
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = (torch.arange(16).reshape(2, 8) * 7 + 3) % tcfg.vocab
    full, _ = T.prefill(tp, tcfg, tokens)
    _, cache = T.prefill(tp, tcfg, tokens[:, :4])
    cache = lm_decode.grow_cache(cache, 4)
    for i in range(4, 8):
        logits, cache = T.decode_step(tp, tcfg, cache, tokens[:, i:i + 1], i)
    _close(logits, full, DECODE_TOL)


# ---------------------------------------------------------------------------
# launch.lm_decode
# ---------------------------------------------------------------------------

def _reference_greedy(arch, B, P, N):
    """The reference's ``lm_decode.main`` loop, returning its tokens."""
    cfg = jcb.get(arch).reduced()
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    prompt = (jnp.arange(B * P).reshape(B, P) * 11 + 1) % cfg.vocab
    logits, cache = jax.jit(lambda p: JT.prefill(p, cfg, prompt))(params)
    cache = _grow_ref(cache, N)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(N - 1):
        logits, cache = step(params, cache, tok, jnp.asarray(P + i, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1)), params


@pytest.mark.parametrize("arch", ["chatglm3_6b", "llama3_405b", "gemma2_27b"])
def test_lm_decode_run_matches_reference_tokens(arch):
    want, jp = _reference_greedy(arch, 2, 16, 16)
    r = lm_decode.run(cb.get(arch).reduced(), 2, 16, 16, device="cpu",
                      params=lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    np.testing.assert_array_equal(r.tokens.numpy(), want)
    assert r.prefill_ms > 0 and r.decode_tok_s > 0


def test_lm_decode_run_with_a_prefix_matches_full_prefills():
    """internvl2: decode steps after the prefix and the prompt, each greedy
    token equal to the argmax of a full prefill of everything before it."""
    cfg = cb.get("internvl2_1b").reduced()
    r = lm_decode.run(cfg, 2, 6, 5, device="cpu", seed=3)
    params = T.init_params(torch.Generator().manual_seed(3), cfg)
    seq = (torch.arange(12).reshape(2, 6) * 11 + 1) % cfg.vocab
    prefix = torch.zeros((2, lm_decode.PREFIX_LEN, cfg.d_model))
    for i in range(5):
        logits, _ = T.prefill(params, cfg, seq, prefix_embeds=prefix)
        assert torch.equal(torch.argmax(logits, -1), r.tokens[:, i])
        seq = torch.cat([seq, r.tokens[:, i:i + 1]], dim=1)


def test_lm_decode_main_cli(capsys):
    lm_decode.main(["--device", "cpu", "--tokens", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] prefill 8 tokens:")
    assert out[1].startswith("[serve] decoded 3 x 2 tokens in") and "tok/s" in out[1]
    assert out[2].startswith("[serve] sample: [")


def test_lm_decode_run_defaults_to_the_card():
    """No fallback: without a card the default device fails; with one the
    tokens lie on it."""
    cfg = cb.get("chatglm3_6b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            lm_decode.run(cfg, 1, 4, 2)
    else:
        assert lm_decode.run(cfg, 1, 4, 2).tokens.is_cuda
