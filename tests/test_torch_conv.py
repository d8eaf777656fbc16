"""The port's primitive registry and its 21 runnable torch impls against the
reference's (``repro.primitives.conv``), on the same numpy inputs, single
image and batched, at fp32 rtol=atol=1e-4 (1e-3 for the Winograd family,
as the reference's own Winograd tests)."""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.primitives import conv as J
from repro.primitives import layouts as JL
from repro_torch.primitives import conv as T
from repro_torch.primitives import layouts as TL


def _tol(name):
    fam = J.REGISTRY[name].family
    return dict(rtol=1e-3, atol=1e-3) if fam.startswith("wino") else dict(rtol=1e-4, atol=1e-4)


def _case(name, rng, batch):
    """(x chw, w, stride) fitting the primitive: f=1 for 1x1, f=5 for wino5."""
    p = J.REGISTRY[name]
    f = {"c1x1": 1, "wino5": 5}.get(p.family, 3)
    s = 2 if p.family in ("im2", "c1x1", "mec", "direct") else 1
    c, k, im = 5, 6, 13
    shape = ((batch,) if batch else ()) + (c, im, im)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, c, f, f)) / (f * np.sqrt(c))).astype(np.float32)
    return x, w, s


def test_registry_metadata_matches_reference():
    assert T.PRIMITIVE_NAMES == J.PRIMITIVE_NAMES
    assert T.RUNNABLE == J.RUNNABLE and len(T.RUNNABLE) == 21
    assert T.FAMILIES == J.FAMILIES
    for name, p in J.REGISTRY.items():
        q = T.REGISTRY[name]
        assert (q.family, q.in_layout, q.out_layout, q.traits) == \
               (p.family, p.in_layout, p.out_layout, p.traits), name
        assert (q.impl is None) == (p.impl is None), name
        for cfg in ((64, 32, 14, 1, 3), (64, 32, 4, 1, 3), (8, 8, 7, 2, 5),
                    (16, 8, 9, 1, 1), (16, 8, 9, 2, 3)):
            assert q.applicable(*cfg) == p.applicable(*cfg), (name, cfg)
    for key, mats in J._WINO_SETS.items():
        for a, b in zip(mats, T._WINO_SETS[key]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


def test_tile_column_rules_match_reference():
    from repro.kernels.im2col_gemm.ops import VARIANTS as CV
    from repro.kernels.matmul.ops import VARIANTS as MV
    from repro.kernels.winograd.ops import VARIANTS as WV
    variants = [None, "bogus-tile"] + list(MV) + list(CV) + list(WV)
    for base in J.PRIMITIVE_NAMES:
        for v in variants:
            assert T.variant_compatible(base, v) == J.variant_compatible(base, v), (base, v)
            col = base if v is None else f"{base}@{v}"
            assert T.is_runnable(col) == J.is_runnable(col), col
            assert T.supports_epilogue(col) == J.supports_epilogue(col), col
            assert T.split_tile(col) == J.split_tile(col)
            assert T.resolve(col).name == J.resolve(col).name
    all_v = list(MV) + list(CV) + list(WV)
    assert T.tile_columns(J.PRIMITIVE_NAMES, all_v) == J.tile_columns(J.PRIMITIVE_NAMES, all_v)


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("name", J.RUNNABLE)
def test_runnable_impl_matches_reference(name, batch, rng):
    """Each impl in its native layouts, then through run_primitive(_batch)."""
    x, w, s = _case(name, rng, batch)
    p = J.REGISTRY[name]
    xin = np.asarray(JL.from_chw(jnp.asarray(x), p.in_layout))
    want = np.asarray(p.impl(jnp.asarray(xin), jnp.asarray(w), s))
    got = T.REGISTRY[name].impl(torch.from_numpy(np.array(xin)),
                                torch.from_numpy(w), s)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **_tol(name))
    run_t = T.run_primitive_batch if batch else T.run_primitive
    got_chw = run_t(name, torch.from_numpy(x), torch.from_numpy(w), s)
    ref = np.asarray((J.reference_conv_batch if batch else J.reference_conv)(
        jnp.asarray(x), jnp.asarray(w), s))
    np.testing.assert_allclose(got_chw.numpy(), ref, **_tol(name))


def test_layouts_match_reference(rng):
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    for src in JL.LAYOUTS:
        for dst in JL.LAYOUTS:
            assert TL.perm(src, dst) == JL.perm(src, dst)
            want = np.asarray(JL.transform(jnp.asarray(x), src, dst))
            np.testing.assert_array_equal(
                TL.transform(torch.from_numpy(x), src, dst).numpy(), want)
        np.testing.assert_array_equal(
            TL.to_chw(TL.from_chw(torch.from_numpy(x), src), src).numpy(), x)


def test_reference_conv_oracle(rng):
    x = rng.standard_normal((2, 4, 11, 11)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    want = np.asarray(J.reference_conv_batch(jnp.asarray(x), jnp.asarray(w), 2))
    got = T.reference_conv_batch(torch.from_numpy(x), torch.from_numpy(w), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(T.reference_conv(torch.from_numpy(x[0]),
                                                torch.from_numpy(w), 2).numpy(),
                               want[0], rtol=1e-4, atol=1e-4)
