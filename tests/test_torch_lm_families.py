"""The port's serving path of the MLA, MoE, SSM, hybrid and encoder-decoder
families (``repro_torch.models.{components,moe,ssm,transformer}``,
``launch.lm_decode``) against the JAX reference, on the CPU.

Inputs are made with numpy from a seed; weights cross from the reference's
``init_params(PRNGKey(0), cfg.reduced())`` by ``convert.lm_params_from_jax``
(the two packages' generators differ, so a seed cannot carry them).
Tolerance: the reference's fp32 ``_TOL`` (1e-4) for every function held to
JAX, its bf16 5e-2 where a function runs in bf16 (the reference's casts),
and its own 3e-3 for a teacher-forced decode against a full prefill. On the
CPU ``attention`` runs the torch port of the reference's ``jnp`` code; the
glue that puts non-causal prefill attention (Whisper's encoder) on the flash
kernel on the card is held here through the kernel's plain version.
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
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import base as cb
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import lm_decode
from repro_torch.models import components as C
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)       # tests/test_kernels.py's bf16 bound
DECODE_TOL = dict(rtol=3e-3, atol=3e-3)     # tests/test_models.py's own bound
FAMILIES = ("minicpm3_4b", "mixtral_8x7b", "qwen3_moe_30b_a3b", "mamba2_2_7b",
            "zamba2_2_7b", "whisper_medium")
ENC_LEN = 12                                # encoder frames in the encdec tests


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=_TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype=None):
    """The numpy array as a JAX array and a torch tensor, each cast to
    ``dtype`` ("bfloat16") on its own side when given."""
    j, t = jnp.asarray(a), torch.from_numpy(a)
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _tree(p, dtype=None):
    """A numpy parameter tree on both sides, matrices cast to ``dtype``."""
    cast = (lambda a: a.astype(jnp.bfloat16)) if dtype == "bfloat16" else (lambda a: a)
    jp = jax.tree.map(lambda a: cast(jnp.asarray(a)) if a.ndim > 1 else jnp.asarray(a), p)
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _t(a):
    return None if a is None else torch.from_numpy(a).long() if a.dtype == np.int32 \
        else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_DIMS = C.MLADims(q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16)


@functools.lru_cache(maxsize=None)
def _mla_params():
    jp = JC.mla_init(jax.random.PRNGKey(3), 64, 4, JC.MLADims(**dataclasses.asdict(MLA_DIMS)),
                     jnp.float32)
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_mla_project_matches_reference():
    """q with its rope dims rotated, the latent and the rotated key rope,
    at positions offset from 0."""
    jp, tp = _mla_params()
    jx, tx = _both(_rand(0, 2, 7, 64))
    pos = np.arange(7, dtype=np.int32) + 3
    want = JC.mla_project(jp, jx, 4, JC.MLADims(**dataclasses.asdict(MLA_DIMS)),
                          jnp.asarray(pos), 10000.0)
    got = C.mla_project(tp, tx, 4, MLA_DIMS, _t(pos), 10000.0)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("path", ["prefill", "absorbed_decode"])
def test_mla_attend_matches_reference(path):
    """Prefill expands the latent (qk 24 against v 16, plain attention);
    decode (Sq = 1) attends in the latent space over a cache whose slots
    past the query are masked."""
    jp, tp = _mla_params()
    Sq, Sk = (9, 9) if path == "prefill" else (1, 12)
    q, ckv, kr = _rand(1, 2, Sq, 4, 24), _rand(2, 2, Sk, 16), _rand(3, 2, Sk, 8)
    qp = np.arange(Sq, dtype=np.int32) + (0 if Sq > 1 else 7)
    kp = np.arange(Sk, dtype=np.int32)
    dims = JC.MLADims(**dataclasses.asdict(MLA_DIMS))
    want = JC.mla_attend(jp, *map(jnp.asarray, (q, ckv, kr, qp, kp)), 4, dims)
    tqp = _t(qp)
    got = C.mla_attend(tp, *map(torch.from_numpy, (q, ckv, kr)), tqp,
                       tqp if Sq == Sk else _t(kp), 4, MLA_DIMS)
    assert tuple(got.shape) == want.shape == (2, Sq, 64)
    _close(got, want)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe(E, K, cf, dispatch, seed=4):
    jcfg = JM.MoEConfig(n_experts=E, top_k=K, d_ff=24, capacity_factor=cf, dispatch=dispatch)
    tcfg = M.MoEConfig(n_experts=E, top_k=K, d_ff=24, capacity_factor=cf, dispatch=dispatch)
    jp = JM.moe_init(jax.random.PRNGKey(seed), 32, jcfg, jnp.float32)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["sort", "scatter"])
def test_moe_apply_matches_reference(dispatch, dtype):
    """Dropless (capacity E / K): output and aux loss; in bf16 the experts
    and the combine run in bf16, the router in fp32."""
    jcfg, tcfg, jp, _ = _moe(4, 2, 2.0, dispatch)
    jp, tp = _tree(jax.tree.map(np.asarray, jp), dtype)
    jx, tx = _both(_rand(5, 2, 10, 32), dtype)
    want, waux = JM.moe_apply(jp, jx, jcfg)
    got, aux = M.moe_apply(tp, tx, tcfg)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    _close(got, want, _TOL if dtype == "float32" else BF16_TOL)
    _close(aux, waux)


def _reference_keep(gate_idx, E, C_):
    """The reference's drop rule in numpy: each row's (token, k) pairs in
    order, a pair kept while its expert has had fewer than C before it."""
    B, S_, K = gate_idx.shape
    keep = np.zeros((B, S_ * K), bool)
    for b in range(B):
        seen = np.zeros(E, int)
        for i, e in enumerate(gate_idx[b].reshape(-1)):
            keep[b, i] = seen[e] < C_
            seen[e] += 1
    return keep.reshape(B, S_, K)


@pytest.mark.parametrize("E,K", [(4, 2), (8, 4)])
def test_moe_drops_match_reference(E, K):
    """At a capacity factor of 0.5 (C = S K / 2E, most pairs past it): the
    same top-k, drop set, output and aux loss as the reference, and the
    sort dispatch equal to the scatter."""
    jcfg, tcfg, jp, tp = _moe(E, K, 0.5, "sort", seed=E)
    jx, tx = _both(_rand(6, 3, 16, 32))
    C_ = M.capacity(tcfg, 16)
    assert C_ == max(1, int(0.5 * 16 * K / E))
    jidx, _, _ = JM._route(jp, jx, jcfg)
    tidx, _, _ = M._route(tp, tx, tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    want_keep = _reference_keep(np.asarray(jidx), E, C_)
    assert 0 < (~want_keep).sum() < want_keep.size           # some dropped, not all
    pos_tok = M.sort_positions(tidx.reshape(3, 16 * K))[2].reshape(3, 16, K)
    np.testing.assert_array_equal((pos_tok < C_).numpy(), want_keep)
    want, waux = JM.moe_apply(jp, jx, jcfg)
    got, aux = M.moe_apply(tp, tx, tcfg)
    _close(got, want)
    _close(aux, waux)
    scat, saux = M.moe_apply(tp, tx, dataclasses.replace(tcfg, dispatch="scatter"))
    _close(scat, got, dict(rtol=0, atol=0))
    assert float(saux) == float(aux)


def test_moe_top_k_breaks_ties_toward_the_lower_expert():
    """A router with tied probabilities: ``jax.lax.top_k``'s order (the
    lower expert first), which ``torch.topk`` does not promise."""
    jcfg, tcfg, jp, tp = _moe(8, 4, 2.0, "sort")
    w = np.zeros((32, 8), np.float32)
    w[:, 5] = w[:, 6] = 1.0                    # experts 5 and 6 tie, the rest tie
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    tp = {**tp, "router": {"w": torch.from_numpy(w)}}
    jx, tx = _both(np.abs(_rand(7, 2, 5, 32)))
    jidx, jvals, _ = JM._route(jp, jx, jcfg)
    tidx, tvals, _ = M._route(tp, tx, tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (tidx[..., :2].numpy() == [5, 6]).all() and (tidx[..., 2:].numpy() == [0, 1]).all()
    _close(tvals, jvals)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

SSM_CFG = dict(d_state=16, headdim=16, expand=2, chunk=8, n_groups=1, d_conv=4)


def test_segsum_matches_reference():
    jx, tx = _both(_rand(8, 2, 3, 8))
    want, got = JS._segsum(jx), S._segsum(tx)
    assert np.array_equal(np.isinf(np.asarray(want)), torch.isinf(got).numpy())
    fin = np.isfinite(np.asarray(want))
    _close(got.numpy()[fin], np.asarray(want)[fin])


def _ssd_inputs(seed, b=2, s=24, h=4, p=8, g=1, n=16):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    B = r.standard_normal((b, s, g, n)).astype(np.float32) * 0.5
    Cm = r.standard_normal((b, s, g, n)).astype(np.float32) * 0.5
    st = r.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, Cm, st


@pytest.mark.parametrize("init_state", [False, True])
def test_ssd_chunked_matches_reference(init_state):
    """Three chunks of 8: the output and the final state, from zero or
    from a given state."""
    x, dt, A, B, Cm, st = _ssd_inputs(9)
    kw = dict(init_state=st) if init_state else {}
    want_y, want_s = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, Cm)), 8,
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
    got_y, got_s = S.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, Cm)), 8,
                                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got_y, want_y)
    _close(got_s, want_s)


@pytest.mark.parametrize("state", [False, True])
def test_causal_conv_matches_reference(state):
    u, w, b = _rand(10, 2, 6, 12), _rand(11, 4, 12), _rand(12, 12)
    st = _rand(13, 2, 3, 12) if state else None
    want = JS._causal_conv(*map(jnp.asarray, (u, w, b)), _j(st))
    got = S._causal_conv(*map(torch.from_numpy, (u, w, b)), _t(st))
    for g, wn in zip(got, want):
        assert tuple(g.shape) == wn.shape
        _close(g, wn)


@functools.lru_cache(maxsize=None)
def _ssm_params(dtype="float32"):
    jcfg = JS.SSMConfig(**SSM_CFG)
    jp = JS.ssm_init(jax.random.PRNGKey(5), 64, jcfg, jnp.float32)
    return _tree(jax.tree.map(np.asarray, jp), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_return_state_matches_reference(dtype):
    """The block over 24 tokens with its decode states: in bf16 the
    reference's casts (bf16 decay matrix, dt-promoted fp32 input, fp32
    read-out), the output in x's dtype."""
    jp, tp = _ssm_params(dtype)
    jx, tx = _both(_rand(14, 2, 24, 64), dtype)
    want = JS.ssm_block(jp, jx, JS.SSMConfig(**SSM_CFG), 64, return_state=True)
    got = S.ssm_block(tp, tx, S.SSMConfig(**SSM_CFG), 64, return_state=True)
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, _TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step_matches_reference(dtype):
    jp, tp = _ssm_params(dtype)
    x = _rand(15, 2, 1, 64)
    st, cs = _rand(16, 2, 8, 16, 16), _rand(17, 2, 3, 160)
    (jx, tx), (jst, tst), (jcs, tcs) = _both(x, dtype), _both(st), _both(cs, dtype)
    want = JS.ssm_decode_step(jp, jx, JS.SSMConfig(**SSM_CFG), 64, jst, jcs)
    got = S.ssm_decode_step(tp, tx, S.SSMConfig(**SSM_CFG), 64, tst, tcs)
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w, _TOL if dtype == "float32" else BF16_TOL)


def test_ssm_length_off_the_chunk_raises():
    """A sequence longer than the chunk and not a multiple of it: a
    ValueError (the reference asserts); one shorter runs as one chunk."""
    _, tp = _ssm_params()
    cfg = S.SSMConfig(**SSM_CFG)
    with pytest.raises(ValueError, match="not a multiple of the chunk 8"):
        S.ssm_block(tp, torch.zeros((1, 12, 64)), cfg, 64)
    with pytest.raises(AssertionError):
        JS.ssm_block(_ssm_params()[0], jnp.zeros((1, 12, 64)), JS.SSMConfig(**SSM_CFG), 64)
    assert S.ssm_block(tp, torch.zeros((1, 5, 64)), cfg, 64).shape == (1, 5, 64)


# ---------------------------------------------------------------------------
# Non-causal prefill attention on the flash route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_route_non_causal_matches_reference_attention(hd):
    """The encoder's attention (non-causal, Sq = Sk, shared positions) on
    the kernel route's glue, through the kernel's plain version on the CPU,
    against the reference's ``attention``; the route takes it, and still
    refuses cross-attention (other key positions) and decode."""
    B, Sq, H = 2, 23, 4
    q, k, v = _rand(18, B, Sq, H, hd), _rand(19, B, Sq, H, hd), _rand(20, B, Sq, H, hd)
    pos = np.arange(Sq, dtype=np.int32)
    want = JC.attention(*map(jnp.asarray, (q, k, v, pos, pos)), causal=False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(C._flash_route(tq, tk, tv, hd ** -0.5, causal=False), want)
    tp = _t(pos)

    class OnCard:                      # a CUDA operand's flags and shape, no card
        is_cuda, shape, requires_grad = True, tq.shape, False

    kw = dict(causal=False, window=None, softcap=None)
    assert C.flash_routed(OnCard, tk, tv, tp, tp, **kw)
    assert not C.flash_routed(OnCard, tk, tv, tp, tp.clone(), **kw)     # cross
    OnCard.shape = (B, 1, H, hd)
    assert not C.flash_routed(OnCard, tk, tv, tp[:1], tp, **kw)         # decode


# ---------------------------------------------------------------------------
# The families: init, prefill, cache, decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch, **replace):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced config, weights from the reference's init at PRNGKey(0)."""
    jcfg, tcfg = jcb.get(arch).reduced(), cb.get(arch).reduced()
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        tcfg = dataclasses.replace(tcfg, **{k: (M.MoEConfig(**dataclasses.asdict(v))
                                                if k == "moe" else v)
                                            for k, v in replace.items()})
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, B=2, S_=24, seed=20):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S_)).astype(np.int32)
    enc = _rand(seed + 1, B, ENC_LEN, cfg.d_model, scale=0.5) if cfg.kind == "encdec" else None
    return tokens, enc


def _flat(tree):
    return {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_layout_matches_reference(arch):
    """The port's own init: the reference's keys, stacked shapes (the
    hybrid's (groups, per group, ...)) and dtypes; and the reference's
    bfloat16 arrays cross bit for bit (MoE's (L, E, d, f) experts among
    them)."""
    jcfg, tcfg, jp, _ = _model(arch)
    mine = T.init_params(torch.Generator().manual_seed(0), tcfg)
    want, got = _flat(jp), _flat(mine)
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        assert tuple(got[key].shape) == a.shape, key
        assert str(got[key].dtype).split(".")[-1] == np.dtype(a.dtype).name, key
    bf = JT.init_params(jax.random.PRNGKey(1),
                        dataclasses.replace(jcfg, param_dtype=jnp.bfloat16))
    crossed = _flat(lm_params_from_jax(jax.tree.map(np.asarray, bf), "cpu"))
    for key, a in _flat(bf).items():
        assert str(crossed[key].dtype).split(".")[-1] == np.dtype(a.dtype).name, key
        np.testing.assert_array_equal(crossed[key].float().numpy(),
                                      np.asarray(a, np.float32), err_msg=key)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_reference(arch):
    """Last-position logits and every cache leaf, in the reference's
    layout."""
    jcfg, tcfg, jp, tp = _model(arch)
    tokens, enc = _inputs(jcfg)
    want, wcache = jax.jit(lambda p: JT.prefill(p, jcfg, _j(tokens), enc_embeds=_j(enc)))(jp)
    got, cache = T.prefill(tp, tcfg, _t(tokens), enc_embeds=_t(enc))
    assert got.dtype == torch.float32 and got.shape == (2, tcfg.vocab)
    _close(got, want)
    assert sorted(cache) == sorted(wcache)
    for name in cache:
        assert tuple(cache[name].shape) == wcache[name].shape, name
        assert str(cache[name].dtype).split(".")[-1] == np.dtype(wcache[name].dtype).name
        _close(cache[name], wcache[name])


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_cache_matches_reference(arch):
    jcfg, tcfg, _, _ = _model(arch)
    want = JT.init_cache(jcfg, 2, 20, enc_len=ENC_LEN, dtype=jnp.bfloat16)
    got = T.init_cache(tcfg, 2, 20, enc_len=ENC_LEN, device="cpu")
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert tuple(got[name].shape) == a.shape, name
        assert str(got[name].dtype).split(".")[-1] == np.dtype(a.dtype).name, name
        assert not got[name].any()


def _grow_ref(cache, extra):
    """The reference's ``lm_decode`` ``grow``: the self-attention leaves
    along axis 2."""
    def grow(path, a):
        if path[-1].key in ("k", "v", "ckv", "kr"):
            pad = [(0, 0)] * a.ndim
            pad[2] = (0, extra)
            return jnp.pad(a, pad)
        return a
    return jax.tree_util.tree_map_with_path(grow, cache)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps_match_reference(arch):
    """Prefill 24 tokens, grow the cache by 3, then 3 teacher-forced
    decode steps: logits at every step and every cache leaf after the
    last (SSM states and cross-attention keys kept, not grown)."""
    jcfg, tcfg, jp, tp = _model(arch)
    tokens, enc = _inputs(jcfg, S_=27, seed=40)
    _, wcache = jax.jit(lambda p: JT.prefill(p, jcfg, _j(tokens[:, :24]),
                                             enc_embeds=_j(enc)))(jp)
    _, cache = T.prefill(tp, tcfg, _t(tokens[:, :24]), enc_embeds=_t(enc))
    wcache, cache = _grow_ref(wcache, 3), lm_decode.grow_cache(cache, 3)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    for i in range(3):
        tok = tokens[:, 24 + i:25 + i]
        want, wcache = step(jp, wcache, jnp.asarray(tok), jnp.asarray(24 + i, jnp.int32))
        got, cache = T.decode_step(tp, tcfg, cache, _t(tok), 24 + i)
        _close(got, want)
    for name in cache:
        assert tuple(cache[name].shape) == wcache[name].shape, name
        _close(cache[name], wcache[name])


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "zamba2_2_7b"])
def test_ring_cache_matches_reference(arch):
    """The reduced window of 16 and a 16-slot cache: mixtral's K/V and
    zamba2's shared block decode from an empty ring past its length."""
    jcfg, tcfg, jp, tp = _model(arch)
    wcache = JT.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    cache = T.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    assert cache["k"].shape[2] == wcache["k"].shape[2] == 16
    tokens, _ = _inputs(jcfg, S_=21, seed=50)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    for pos in range(21):
        tok = tokens[:, pos:pos + 1]
        want, wcache = step(jp, wcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        got, cache = T.decode_step(tp, tcfg, cache, _t(tok), pos)
        _close(got, want)
    for name in cache:
        _close(cache[name], wcache[name])


@pytest.mark.parametrize("arch", FAMILIES)
def test_teacher_forced_decode_matches_full_prefill(arch):
    """The port on its own, as tests/test_models.py holds the reference:
    prefill 4 tokens, step tokens 4..7, the last logits against a full
    prefill of all 8 (weights from PRNGKey(1); Whisper over 12 frames).
    MoE here is the reduced config's dropless one."""
    tcfg = cb.get(arch).reduced()
    jp = JT.init_params(jax.random.PRNGKey(1), jcb.get(arch).reduced())
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = (torch.arange(16).reshape(2, 8) * 7 + 3) % tcfg.vocab
    enc = _t(_inputs(tcfg)[1])
    full, _ = T.prefill(tp, tcfg, tokens, enc_embeds=enc)
    _, cache = T.prefill(tp, tcfg, tokens[:, :4], enc_embeds=enc)
    cache = lm_decode.grow_cache(cache, 4)
    for i in range(4, 8):
        logits, cache = T.decode_step(tp, tcfg, cache, tokens[:, i:i + 1], i)
    _close(logits, full, DECODE_TOL)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "qwen3_moe_30b_a3b"])
def test_moe_registered_capacity_decode_departs_from_prefill(arch):
    """At the registered capacity factor 1.25 a full prefill drops tokens
    and a decode step (one slot an expert) never does, so teacher-forced
    decode parts from the full prefill, in both packages alike: each
    package's logits equal the other's, and both miss the 3e-3 bound."""
    jcfg, tcfg, jp, tp = _model(arch, moe=dataclasses.replace(
        jcb.get(arch).reduced().moe, capacity_factor=1.25))
    tokens = (np.arange(32).reshape(2, 16) * 7 + 3).astype(np.int32) % jcfg.vocab
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    jfull, _ = JT.prefill(jp, jcfg, jnp.asarray(tokens))
    _, jc = JT.prefill(jp, jcfg, jnp.asarray(tokens[:, :8]))
    jc = _grow_ref(jc, 8)
    tfull, _ = T.prefill(tp, tcfg, _t(tokens))
    _, tc = T.prefill(tp, tcfg, _t(tokens[:, :8]))
    tc = lm_decode.grow_cache(tc, 8)
    for i in range(8, 16):
        jl, jc = step(jp, jc, jnp.asarray(tokens[:, i:i + 1]), jnp.asarray(i, jnp.int32))
        tl, tc = T.decode_step(tp, tcfg, tc, _t(tokens[:, i:i + 1]), i)
    _close(tfull, jfull)
    _close(tl, jl)
    for full, last in ((jfull, jl), (tfull, tl)):
        assert np.abs(_np(full) - _np(last)).max() > DECODE_TOL["atol"]


# ---------------------------------------------------------------------------
# launch.lm_decode
# ---------------------------------------------------------------------------

def _reference_greedy(arch, B, P, N):
    """The reference's ``lm_decode.main`` loop, returning its tokens."""
    cfg = jcb.get(arch).reduced()
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    prompt = (jnp.arange(B * P).reshape(B, P) * 11 + 1) % cfg.vocab
    kw = {}
    if cfg.kind == "encdec":
        kw["enc_embeds"] = jnp.zeros((B, P, cfg.d_model), jnp.float32)
    logits, cache = jax.jit(lambda p: JT.prefill(p, cfg, prompt, **kw))(params)
    cache = _grow_ref(cache, N)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(N - 1):
        logits, cache = step(params, cache, tok, jnp.asarray(P + i, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1)), params


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_decode_run_matches_reference_tokens(arch):
    want, jp = _reference_greedy(arch, 2, 16, 12)
    r = lm_decode.run(cb.get(arch).reduced(), 2, 16, 12, device="cpu",
                      params=lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    np.testing.assert_array_equal(r.tokens.numpy(), want)
    assert r.prefill_ms > 0 and r.decode_tok_s > 0


def test_grow_cache_grows_only_the_self_attention_leaves():
    """K/V and the MLA latent gain slots on axis 2; SSM states (axis 2 is
    their head axis) and the cross-attention's keys do not."""
    cache = {"k": torch.ones(2, 1, 3, 4, 5), "v": torch.ones(2, 1, 3, 4, 5),
             "ckv": torch.ones(2, 1, 3, 6), "kr": torch.ones(2, 1, 3, 2),
             "ssm": torch.ones(2, 1, 3, 4, 5), "conv": torch.ones(2, 1, 3, 7),
             "ck": torch.ones(2, 1, 3, 4, 5), "cv": torch.ones(2, 1, 3, 4, 5)}
    grown = lm_decode.grow_cache(cache, 2)
    for name, a in grown.items():
        want = 5 if name in lm_decode.GROWN else 3
        assert a.shape[2] == want, name
        assert torch.equal(a[:, :, :3], cache[name])
        assert not a[:, :, 3:].any()


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_decode_main_takes_the_family(arch, capsys):
    lm_decode.main(["--arch", arch, "--device", "cpu", "--tokens", "3",
                    "--prompt-len", "8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] prefill 8 tokens:")
    assert out[1].startswith("[serve] decoded 2 x 2 tokens in") and "tok/s" in out[1]
