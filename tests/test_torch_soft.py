"""edt_tpu_torch.models.soft against edt_tpu.models.soft on the CPU.

Each case feeds the same NumPy inputs (made from a seed) to both, with a
random cotangent. At temperature 0 it compares the forward bit-exact and
the gradient w.r.t. the occupancy (or heights) with rtol=1e-5,
atol=1e-5 * max|grad|: the backward sums the same cotangents in another
order (the JAX oracle segments the binary pass with ``associative_scan``,
the port with shift-and-add steps), and the gradients carry the barrier's
scale. At temperature > 0 (the softmin passes, exact logsumexp on both
sides) the forward is held to rtol=1e-5, atol=1e-5 * max|ref| and the
gradient to rtol=1e-4, atol=1e-4 * max|grad|: the logsumexps and the
logaddexp wall blends round differently in the two frameworks, and the
backward divides that round-off of d by t. The JAX side is jitted: one
compile a case instead of one an operation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import edt_tpu_torch
from edt_tpu.models import soft as jsoft
from edt_tpu_torch.models import soft

SHAPE = (10, 12, 14)


def _labels(seed=0, nl=4):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, nl, size=(3, 3, 4))
    lab = np.kron(base, np.ones((4, 4, 4), np.uint8))[:10, :12, :14]
    noise = rng.random(SHAPE) < 0.1  # single voxels break up the blocks
    return np.where(noise, rng.integers(0, nl, size=SHAPE), lab).astype(np.uint32)


def _occupancy(labels, kind, seed=1):
    occ = (labels != 0).astype(np.float32)
    if kind == "soft":
        occ *= np.random.default_rng(seed).random(SHAPE).astype(np.float32)
    return occ


def _jax_value_and_grad(fn, x, w):
    """The JAX package's forward and d(sum(out * w))/dx, jitted."""
    def loss(x):
        out = fn(x)
        return jnp.sum(out * w), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


def _port_value_and_grad(fn, x, w):
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt)
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xt)
    return out.detach().numpy(), g.numpy()


def _check(port, ref):
    (out, g), (rout, rg) = port, ref
    assert out.shape == rout.shape and out.dtype == rout.dtype
    assert np.array_equal(out, rout)
    np.testing.assert_allclose(g, rg, rtol=1e-5,
                               atol=1e-5 * float(np.abs(rg).max() or 1.0))


def _check_soft(port, ref):
    (out, g), (rout, rg) = port, ref
    assert out.shape == rout.shape and out.dtype == rout.dtype
    np.testing.assert_allclose(out, rout, rtol=1e-5,
                               atol=1e-5 * float(np.abs(rout).max()))
    np.testing.assert_allclose(g, rg, rtol=1e-4,
                               atol=1e-4 * float(np.abs(rg).max() or 1.0))


# every value of each of the four options at least once, the bench.py
# flags first; mask occupancy with binary_occupancy=False is the general path
@pytest.mark.parametrize("aniso,bb,occ_kind,binocc", [
    ((6.0, 6.0, 30.0), True, "mask", True),
    ((6.0, 6.0, 30.0), True, "mask", False),
    ((6.0, 6.0, 30.0), False, "soft", False),
    ((1.0, 1.0, 1.0), False, "mask", True),
    ((1.0, 1.0, 1.0), True, "soft", False),
    ((1.0, 1.0, 1.0), False, "mask", False),
])
def test_multilabel_edtsq_matches_jax(aniso, bb, occ_kind, binocc):
    labels = _labels()
    occ = _occupancy(labels, occ_kind)
    w = np.random.default_rng(2).random(SHAPE).astype(np.float32)
    ref = _jax_value_and_grad(
        lambda o: jsoft.multilabel_edtsq(jnp.asarray(labels), o, aniso, bb,
                                         binary_occupancy=binocc), occ, w)
    port = _port_value_and_grad(
        lambda o: soft.multilabel_edtsq(labels, o, aniso, bb,
                                        binary_occupancy=binocc, device="cpu"),
        occ, w)
    _check(port, ref)


@pytest.mark.parametrize("aniso,bb,occ_kind,binocc", [
    ((6.0, 6.0, 30.0), True, "mask", True),
    ((1.3, 1.0, 2.0), False, "soft", False),
])
def test_soft_edtsq_matches_jax(aniso, bb, occ_kind, binocc):
    occ = _occupancy(_labels(3), occ_kind)
    w = np.random.default_rng(4).random(SHAPE).astype(np.float32)
    ref = _jax_value_and_grad(
        lambda o: jsoft.soft_edtsq(o, aniso, bb, binary_occupancy=binocc),
        occ, w)
    port = _port_value_and_grad(
        lambda o: soft.soft_edtsq(o, aniso, bb, binary_occupancy=binocc),
        occ, w)
    _check(port, ref)


def test_edtsq_from_heights_and_soft_sdfsq_match_jax():
    rng = np.random.default_rng(5)
    h = (rng.random(SHAPE) * 300).astype(np.float32)
    h[rng.random(SHAPE) < 0.2] = 0.0
    w = rng.random(SHAPE).astype(np.float32)
    aniso = (2.0, 1.3, 1.0)
    ref = _jax_value_and_grad(
        lambda x: jsoft.edtsq_from_heights(x, aniso, True), h, w)
    port = _port_value_and_grad(
        lambda x: soft.edtsq_from_heights(x, aniso, True), h, w)
    _check(port, ref)
    occ = _occupancy(_labels(6), "soft")
    ref = _jax_value_and_grad(
        lambda o: jsoft.soft_sdfsq(o, (6.0, 6.0, 30.0), False), occ, w)
    port = _port_value_and_grad(
        lambda o: soft.soft_sdfsq(o, (6.0, 6.0, 30.0), False), occ, w)
    _check(port, ref)


# temperature > 0: both temperatures, black_border on and off, mask and
# soft occupancy; binary_occupancy=True has no effect there
@pytest.mark.parametrize("t,aniso,bb,occ_kind", [
    (0.5, (6.0, 6.0, 30.0), True, "mask"),
    (0.3, (1.0, 1.0, 1.0), False, "soft"),
])
def test_multilabel_edtsq_softmin_matches_jax(t, aniso, bb, occ_kind):
    labels = _labels(11)
    occ = _occupancy(labels, occ_kind)
    w = np.random.default_rng(12).random(SHAPE).astype(np.float32)
    ref = _jax_value_and_grad(
        lambda o: jsoft.multilabel_edtsq(jnp.asarray(labels), o, aniso, bb,
                                         temperature=t), occ, w)
    port = _port_value_and_grad(
        lambda o: soft.multilabel_edtsq(labels, o, aniso, bb, temperature=t,
                                        binary_occupancy=True, device="cpu"),
        occ, w)
    _check_soft(port, ref)


@pytest.mark.parametrize("t,aniso,bb,occ_kind", [
    (0.3, (1.3, 1.0, 2.0), True, "soft"),
    (0.5, (6.0, 6.0, 30.0), False, "mask"),
])
def test_soft_edtsq_softmin_matches_jax(t, aniso, bb, occ_kind):
    occ = _occupancy(_labels(13), occ_kind)
    w = np.random.default_rng(14).random(SHAPE).astype(np.float32)
    ref = _jax_value_and_grad(
        lambda o: jsoft.soft_edtsq(o, aniso, bb, temperature=t), occ, w)
    port = _port_value_and_grad(
        lambda o: soft.soft_edtsq(o, aniso, bb, temperature=t,
                                  binary_occupancy=True), occ, w)
    _check_soft(port, ref)


def test_edtsq_from_heights_and_soft_sdfsq_softmin_match_jax():
    rng = np.random.default_rng(15)
    h = (rng.random(SHAPE) * 300).astype(np.float32)
    h[rng.random(SHAPE) < 0.2] = 0.0
    w = rng.random(SHAPE).astype(np.float32)
    aniso = (2.0, 1.3, 1.0)
    ref = _jax_value_and_grad(
        lambda x: jsoft.edtsq_from_heights(x, aniso, False, 0.5), h, w)
    port = _port_value_and_grad(
        lambda x: soft.edtsq_from_heights(x, aniso, False, 0.5), h, w)
    _check_soft(port, ref)
    occ = _occupancy(_labels(16), "soft")
    ref = _jax_value_and_grad(
        lambda o: jsoft.soft_sdfsq(o, (1.0, 1.0, 1.0), True, temperature=0.3),
        occ, w)
    port = _port_value_and_grad(
        lambda o: soft.soft_sdfsq(o, (1.0, 1.0, 1.0), True, temperature=0.3),
        occ, w)
    _check_soft(port, ref)


def test_soft_edtsq_batch_matches_one_by_one():
    """The trainers' batched transform equals soft_edtsq of each volume."""
    occ = torch.from_numpy(np.stack([_occupancy(_labels(s), "soft")
                                     for s in (17, 18)]))
    got = soft._soft_edtsq_batch(occ, (1.0, 1.0, 1.0), True, 50.0, 0.3)
    for b in range(2):
        ref = soft.soft_edtsq(occ[b], (1.0, 1.0, 1.0), True, 50.0, 0.3)
        torch.testing.assert_close(got[b], ref, rtol=1e-6, atol=1e-6)
    got = soft._soft_edtsq_batch(occ, (1.0, 2.0, 1.0), False, None, 0.5)
    ref = soft.soft_edtsq(occ[1], (1.0, 2.0, 1.0), False, None, 0.5)
    torch.testing.assert_close(got[1], ref, rtol=1e-6, atol=1e-6)


def test_wall_counts_and_carried_state():
    """wall_counts_for is bit-exact, and JAX's tuple, handed over as NumPy,
    gives the port the same transform."""
    labels = _labels(7)
    counts = jax.jit(jsoft.wall_counts_for, static_argnums=1)
    for bb in (False, True):
        ref = counts(jnp.asarray(labels), bb)
        got = soft.wall_counts_for(labels, bb, device="cpu")
        for r, c in zip(ref, got):
            r = np.asarray(r)
            assert c.dtype == torch.int16 and np.array_equal(c.numpy(), r)
    ref = tuple(np.asarray(c) for c in counts(jnp.asarray(labels), True))
    occ = torch.from_numpy(_occupancy(labels, "mask"))
    a = soft.multilabel_edtsq(labels, occ, (6.0, 6.0, 30.0), True,
                              binary_occupancy=True, wall_counts=ref)
    b = soft.multilabel_edtsq(labels, occ, (6.0, 6.0, 30.0), True,
                              binary_occupancy=True)
    assert torch.equal(a, b)


def test_mask_forward_equals_hard_edtsq():
    labels = _labels(8)
    for aniso in ((6.0, 6.0, 30.0), (1.0, 2.0, 3.0)):
        got = soft.multilabel_edtsq(labels, None, aniso, True, device="cpu")
        ref = edt_tpu_torch.edtsq(labels, aniso, True, device="cpu")
        assert np.array_equal(got.numpy(), ref)


def test_temperature_and_devices():
    labels = _labels(9)
    occ = torch.from_numpy(_occupancy(labels, "mask"))
    # every entry point takes t > 0 and keeps a tensor on its device
    for out in (
            soft.multilabel_edtsq(labels, occ, (1.0, 1.0, 1.0), temperature=0.5),
            soft.soft_edtsq(occ, (1.0, 1.0, 1.0), temperature=0.5),
            soft.soft_sdfsq(occ, (1.0, 1.0, 1.0), temperature=0.5),
            soft.edtsq_from_heights(occ, (1.0, 1.0, 1.0), temperature=0.5)):
        assert out.device.type == "cpu" and out.shape == SHAPE
        assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="more than one device"):
        soft.multilabel_edtsq(torch.from_numpy(labels.view(np.int32)),
                              occ.to("meta"))
    with pytest.raises(ValueError, match="inputs lie on"):
        soft.soft_edtsq(occ, (1.0, 1.0, 1.0), device="meta")
    # a tensor stays on its device; NumPy inputs go to device=
    assert soft.soft_edtsq(occ, (1.0, 1.0, 1.0)).device.type == "cpu"


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soft.multilabel_edtsq(_labels(10))
