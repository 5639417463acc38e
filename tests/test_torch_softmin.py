"""K5 and K6 (edt_tpu_torch.ops.softmin) on the CPU: the plain versions
against the JAX package's Pallas kernels in interpret mode and against the
exact logsumexp and its ``jax.vjp``, and the wrappers' dispatch. The CUDA
kernels themselves are tested in test_torch_cuda.py.

Tolerances, the JAX package's own for its kernels against the exact form
(tests/test_pallas_kernels.py): forward rtol=1e-5, atol=1e-4 (the kernels
drop the terms below exp(-30) and sum in another order); df rtol=1e-4,
atol=1e-4 * max|df| (the JAX package's weights are recomputed from d and
carry its round-off divided by t; the port's are normalised to sum 1);
sum(g * e) against the gradient w.r.t. w2, rtol=1e-3 (a sum over every
weight of the row).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edt_tpu.ops import pallas_kernels as pk
from edt_tpu_torch.ops import softmin


def _case(kind):
    """(f, w2, t) rows of the regimes K5 has, R <= 16, n <= 200.

    d / t stays below about 1000: the weights exp((d - cost) / t) carry
    the f32 round-off of d and cost divided by t, so larger ratios leave
    every f32 form (the Pallas kernel's too) percents from the exact AD.
    """
    rng = np.random.default_rng({"random": 0, "barrier": 1, "mixed": 2}[kind])
    if kind == "random":
        f = (rng.random((9, 200)) * 50).astype(np.float32)
        f[rng.random((9, 200)) > 0.6] = 0.0
        return f, 36.0, 0.3
    if kind == "barrier":  # two-valued heights: the first pass of a volume
        f = (rng.random((7, 160)) > 0.5).astype(np.float32) * 2000.0
        return f, 900.0, 1.0
    # long radii (about 30) beside short ones: a plateau over sparse sources
    f = (rng.random((12, 180)) * 50).astype(np.float32)
    f[:6, 40:150] = 1000.0
    f[:6, ::60] = 0.0
    return f, 1.0, 1.0


def _exact(f, w2, t):
    n = f.shape[1]
    i = jnp.arange(n, dtype=jnp.float32)
    cost = f[:, None, :] + w2 * (i[:, None] - i[None, :]) ** 2
    return -t * jax.nn.logsumexp(-cost / t, axis=-1)


def _grad_inputs(f, w2, t):
    g = np.random.default_rng(42).uniform(-1, 1, f.shape).astype(np.float32)
    d = softmin.softmin_plain(torch.from_numpy(f), w2, t)
    return d, g


@pytest.mark.parametrize("kind", ["random", "barrier", "mixed"])
def test_softmin_plain_matches_jax(kind):
    f, w2, t = _case(kind)
    got = softmin.softmin_plain(torch.from_numpy(f), w2, t).numpy()
    exact = np.asarray(_exact(jnp.asarray(f), w2, t))
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)
    kern = np.asarray(pk.softmin_pallas(jnp.asarray(f), jnp.float32(w2),
                                        jnp.float32(t), interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["random", "barrier", "mixed"])
def test_softmin_grad_plain_matches_jax(kind):
    f, w2, t = _case(kind)
    d, g = _grad_inputs(f, w2, t)
    df, e = softmin.softmin_grad_plain(torch.from_numpy(f), d,
                                       torch.from_numpy(g), w2, t)
    df, dw2 = df.numpy(), float((torch.from_numpy(g) * e).sum())
    ref_df, ref_dw2 = jax.vjp(_exact, jnp.asarray(f), jnp.float32(w2),
                              t)[1](jnp.asarray(g))[:2]
    kdf, ke = pk.softmin_grad_pallas(jnp.asarray(f), jnp.asarray(d.numpy()),
                                     jnp.asarray(g), jnp.float32(w2),
                                     jnp.float32(t), interpret=True)
    for rdf, rdw2 in ((ref_df, ref_dw2), (kdf, jnp.sum(jnp.asarray(g) * ke))):
        rdf = np.asarray(rdf)
        np.testing.assert_allclose(df, rdf, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(rdf).max()))
        np.testing.assert_allclose(dw2, float(rdw2), rtol=1e-3)


def test_all_inf_rows_stay_inf():
    f = np.random.default_rng(3).random((4, 50)).astype(np.float32) * 9
    f[1] = np.inf
    d = softmin.softmin_plain(torch.from_numpy(f), 36.0, 0.3).numpy()
    assert np.isinf(d[1]).all() and np.isfinite(d[[0, 2, 3]]).all()
    # one finite height: d = f_j + w2 k^2 exactly where the sum is one term
    g = np.full((1, 50), np.inf, np.float32)
    g[0, 7] = 0.0
    d = softmin.softmin_plain(torch.from_numpy(g), 36.0, 0.3).numpy()[0]
    np.testing.assert_allclose(d, 36.0 * (np.arange(50) - 7.0) ** 2,
                               rtol=1e-6)


def test_wrappers_dispatch():
    """CPU tensors take the plain versions and launch nothing; other
    devices raise."""
    f, w2, t = _case("random")
    ft = torch.from_numpy(f)
    before = (softmin.launches, softmin.grad_launches)
    d = softmin.softmin(ft, w2, t)
    assert torch.equal(d, softmin.softmin_plain(ft, w2, t))
    g = torch.ones_like(ft)
    df, e = softmin.softmin_grad(ft, d, g, w2, t)
    rdf, re = softmin.softmin_grad_plain(ft, d, g, w2, t)
    assert torch.equal(df, rdf) and torch.equal(e, re)
    assert (softmin.launches, softmin.grad_launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        softmin.softmin(ft.to("meta"), w2, t)
    with pytest.raises(ValueError, match="unsupported device"):
        softmin.softmin_grad(ft.to("meta"), d.to("meta"), g.to("meta"), w2, t)
    assert softmin.MAX_AXIS == 58048 and softmin.GRAD_MAX_AXIS == 19349
