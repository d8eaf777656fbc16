"""The port's three kernels against the reference's Pallas kernels.

On the CPU each wrapper computes its plain PyTorch version (its tensors lie
on the CPU), so these tests hold the plain versions — and the wrappers'
shape/tile/epilogue plumbing — to the Pallas kernels run in interpret mode,
on the same numpy inputs. Tolerances are the reference's own: fp32
rtol=atol=1e-4 for the GEMM kernels (``tests/test_kernels.py::_TOL``) and
1e-3 for the full Winograd conv.

``tests/test_torch_gpu.py`` holds each hand-written CUDA kernel to its plain
version on the card.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.im2col_gemm.im2col_gemm import conv_im2col_batch as jax_conv_batch
from repro.kernels.matmul.matmul import matmul as jax_matmul
from repro.kernels.matmul.ops import VARIANTS as JAX_MM_VARIANTS
from repro.kernels.matmul.ops import matmul_op as jax_matmul_op
from repro.kernels.winograd.ops import winograd_conv_batch as jax_wino_conv
from repro.kernels.winograd.winograd import winograd_point_gemm_batch as jax_point_gemm
from repro.primitives.conv import reference_conv_batch as jax_conv_ref
from repro_torch.kernels.im2col_gemm.im2col_gemm import conv_im2col_batch
from repro_torch.kernels.im2col_gemm.ops import CTA_TILES as CONV_TILES
from repro_torch.kernels.im2col_gemm.ops import VARIANTS as CONV_VARIANTS
from repro_torch.kernels.im2col_gemm.ops import conv_im2col_batch_op
from repro_torch.kernels.matmul.matmul import matmul
from repro_torch.kernels.matmul.ops import CTA_TILES as MM_TILES
from repro_torch.kernels.matmul.ops import VARIANTS as MM_VARIANTS
from repro_torch.kernels.matmul.ops import matmul_op
from repro_torch.kernels.winograd.ops import CTA_TILES as WINO_TILES
from repro_torch.kernels.winograd.ops import VARIANTS as WINO_VARIANTS
from repro_torch.kernels.winograd.ops import winograd_conv_batch
from repro_torch.kernels.winograd.winograd import winograd_point_gemm_batch

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
WINO_TOL = dict(rtol=1e-3, atol=1e-3)
EPILOGUES = list(itertools.product((False, True), repeat=3))   # bias, res, relu


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# matmul (reference: kernels/matmul/matmul.py:140)
# ---------------------------------------------------------------------------

def test_variant_keys_match_reference():
    assert MM_VARIANTS == JAX_MM_VARIANTS
    from repro.kernels.im2col_gemm.ops import VARIANTS as JAX_CONV
    from repro.kernels.winograd.ops import VARIANTS as JAX_WINO
    assert CONV_VARIANTS == JAX_CONV and WINO_VARIANTS == JAX_WINO
    # every key maps to a tile the CUDA launchers instantiate
    legal = {(bm, bk, bn) for bm in (64, 128) for bk in (8, 16) for bn in (64, 128)}
    for table, keys in ((MM_TILES, MM_VARIANTS), (CONV_TILES, CONV_VARIANTS),
                        (WINO_TILES, WINO_VARIANTS)):
        assert set(table) == set(keys) and set(table.values()) <= legal


@pytest.mark.parametrize("variant", sorted(JAX_MM_VARIANTS))
def test_matmul_every_variant_ragged(variant, rng):
    """Every mm-* key, ragged M/N/K (not multiples of any tile)."""
    x, y = _np(rng, 150, 70), _np(rng, 70, 90)
    want = jax_matmul_op(jnp.asarray(x), jnp.asarray(y), variant=variant,
                         interpret=True)
    got = matmul_op(_t(x), _t(y), variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


@pytest.mark.parametrize("bias,res,relu", EPILOGUES)
def test_matmul_epilogues_vs_fused_store(bias, res, relu, rng):
    """Every epilogue combination against the reference's in-kernel
    epilogue (``fuse_store=True``), bias -> residual -> ReLU."""
    M, K, N = 100, 77, 33
    x, y = _np(rng, M, K), _np(rng, K, N)
    b = _np(rng, M) if bias else None
    r = _np(rng, M, N) if res else None
    want = jax_matmul(jnp.asarray(x), jnp.asarray(y), bm=32, bk=32, bn=32,
                      bias=_j(b), residual=_j(r), relu=relu, interpret=True,
                      fuse_store=True)
    got = matmul(_t(x), _t(y), bias=_t(b), residual=_t(r), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


def test_matmul_rejects_what_the_kernel_cannot_take():
    x, y = torch.zeros(4, 3), torch.zeros(3, 5)
    with pytest.raises(TypeError):
        matmul(x.double(), y.double())
    with pytest.raises(ValueError):
        matmul(torch.zeros(3, 4).T, y)              # non-contiguous
    with pytest.raises(ValueError):
        matmul(x, y, bias=torch.zeros(5))
    with pytest.raises(ValueError):
        matmul(x, y.to("meta"))                     # mixed devices


# ---------------------------------------------------------------------------
# conv_im2col_batch (reference: kernels/im2col_gemm/im2col_gemm.py:155)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [(2, 4, 16, 8, 3, 1), (3, 4, 19, 8, 3, 2),
                                 (2, 3, 14, 32, 5, 1), (2, 8, 9, 8, 1, 1),
                                 (2, 6, 11, 12, 1, 2)])
def test_conv_im2col_batch_shapes(cfg, rng):
    """f in {1, 3, 5}, stride 1 and 2, against the Pallas kernel."""
    N, C, H, K, f, s = cfg
    x, w = _np(rng, N, C, H, H), _np(rng, K, C, f, f)
    want = jax_conv_batch(jnp.asarray(x), jnp.asarray(w), s, bk=16,
                          interpret=True)
    got = conv_im2col_batch(_t(x), _t(w), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("variant,bias,res,relu", [
    (v, *e) for v, e in zip(itertools.cycle(sorted(CONV_VARIANTS)), EPILOGUES)])
def test_conv_im2col_batch_variants_epilogues(variant, bias, res, relu, rng):
    """Every epilogue combination, cycling through every conv-bk* key,
    against the reference's in-kernel epilogue (``fuse_store=True``)."""
    N, C, H, K, f, s = 2, 5, 9, 12, 3, 2
    oh = (H - f) // s + 1
    x, w = _np(rng, N, C, H, H), _np(rng, K, C, f, f, scale=0.3)
    b = _np(rng, K) if bias else None
    r = _np(rng, N, K, oh, oh) if res else None
    want = jax_conv_batch(jnp.asarray(x), jnp.asarray(w), s, bk=8,
                          bias=_j(b), residual=_j(r), relu=relu,
                          interpret=True, fuse_store=True)
    got = conv_im2col_batch_op(_t(x), _t(w), s, variant=variant, bias=_t(b),
                               residual=_t(r), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


# ---------------------------------------------------------------------------
# winograd_point_gemm_batch (reference: kernels/winograd/winograd.py:77)
# ---------------------------------------------------------------------------

def test_winograd_point_gemm_batch(rng):
    u, v = _np(rng, 16, 60, 48), _np(rng, 2, 16, 48, 75)
    want = jax_point_gemm(jnp.asarray(u), jnp.asarray(v), bk=32, bt=32, bc=32,
                          interpret=True)
    got = winograd_point_gemm_batch(_t(u), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


@pytest.mark.parametrize("m,variant", [(2, "wino-128x128"), (2, "wino-256x128"),
                                       (4, "wino-128x256"), (4, "mm-256x128x128")])
def test_winograd_conv_batch(m, variant, rng):
    """The full Winograd conv at m=2 and m=4 (transforms + point-GEMM +
    epilogue) against the reference's, and against the plain conv."""
    x, w = _np(rng, 2, 4, 15, 15), _np(rng, 8, 4, 3, 3)
    b, r = _np(rng, 8), _np(rng, 2, 8, 13, 13)
    want = jax_wino_conv(jnp.asarray(x), jnp.asarray(w), m=m, bias=jnp.asarray(b),
                         residual=jnp.asarray(r), relu=True, interpret=True)
    got = winograd_conv_batch(_t(x), _t(w), m=m, variant=variant, bias=_t(b),
                              residual=_t(r), relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WINO_TOL)
    plain = np.maximum(np.asarray(jax_conv_ref(jnp.asarray(x), jnp.asarray(w), 1))
                       + b[:, None, None] + r, 0.0)
    np.testing.assert_allclose(got.numpy(), plain, **WINO_TOL)
