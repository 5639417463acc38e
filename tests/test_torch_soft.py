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

torch.set_num_threads(1)

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


def test_positional_arguments_bind_as_in_jax():
    """Every differentiable transform takes ``axis_name`` at the JAX
    package's position, so the same positional call gives the same
    forward, bit for bit; an axis_name there that is not a process group
    raises TypeError."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, (8, 9, 10)).astype(np.int32)
    occ = (labels != 0).astype(np.float32)
    h = (50 * rng.random((6, 7, 8))).astype(np.float32)
    hb = np.where(h > 25, np.float32(50), np.float32(0))
    an = (1.0, 2.0, 3.0)
    lab_j, lab_t = jnp.asarray(labels), torch.from_numpy(labels)
    cases = [  # (JAX function, port function, array, positional tail)
        (lambda o, *a: jsoft.multilabel_edtsq(lab_j, o, *a),
         lambda o, *a, **k: soft.multilabel_edtsq(lab_t, o, *a, **k),
         occ, (an, True, None, 0.0, None, True)),
        (jsoft.soft_edtsq, soft.soft_edtsq, occ,
         (an, True, None, 0.0, None, True)),
        (jsoft.soft_sdfsq, soft.soft_sdfsq, occ, (an, True, None, 0.0, None)),
        (jsoft.edtsq_from_heights, soft.edtsq_from_heights, h,
         (an, False, 0.0, None, False)),
        (jsoft.edtsq_from_heights, soft.edtsq_from_heights, hb,
         (an, False, 0.0, None, True)),
    ]
    for jfn, tfn, x, args in cases:
        ref = np.asarray(jax.jit(lambda v: jfn(v, *args))(jnp.asarray(x)))  # noqa: B023
        got = tfn(torch.from_numpy(x), *args).numpy()
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        # axis_name is the argument after temperature
        k = 4 if jfn is jsoft.edtsq_from_heights else 5
        with pytest.raises(TypeError, match="ProcessGroup"):
            tfn(torch.from_numpy(x), *args[:k - 1], "x")
        with pytest.raises(TypeError, match="ProcessGroup"):
            tfn(torch.from_numpy(x), *args[:2], axis_name="x")


# ---------------- the JAX package's path knobs ----------------
#
# Under EDT_TPU_DISABLE_PALLAS the JAX package's passes take jnp, and under
# EDT_TPU_BINARY_GRAD_SCAN=0 its closed-form binary pass's backward takes
# the gather (K3) instead of the segmented scan (K4). The port reads
# neither: its passes keep their kernels and their one backward, and their
# results equal the JAX package's under either setting.

KNOB = "EDT_TPU_DISABLE_PALLAS"
SCAN_KNOB = "EDT_TPU_BINARY_GRAD_SCAN"
BENCH_ANISO = (6.0, 6.0, 30.0)
N16 = 16


def _count_wrappers(monkeypatch):
    """Names of the kernels' wrappers as they are called. The custom ops
    of ``soft.KERNELS`` call them by their module names; ``soft.PLAIN``
    calls the plain versions and never them."""
    from edt_tpu_torch.ops import argmin, grad
    from edt_tpu_torch.ops import softmin as soft_ops

    calls = []
    for mod, name in ((argmin, "minplus_argmin"), (grad, "minplus_grad"),
                      (grad, "binary_grad_scan"), (soft_ops, "softmin"),
                      (soft_ops, "softmin_grad")):
        def counted(*a, _real=getattr(mod, name), _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _bench_inputs():
    """bench.py's make_labels at 16^3 (blocks of one voxel, labels 0..5),
    its mask occupancy and a cotangent."""
    rng = np.random.default_rng(42)
    labels = rng.integers(0, 6, size=(N16,) * 3).astype(np.uint32)
    occ = (labels != 0).astype(np.float32)
    return labels, occ, rng.random(labels.shape).astype(np.float32)


def _jax_bench(labels, occ, w):
    return _jax_value_and_grad(
        lambda o: jsoft.multilabel_edtsq(jnp.asarray(labels), o, BENCH_ANISO,
                                         True, binary_occupancy=True), occ, w)


def _port_bench(labels, occ, w):
    return _port_value_and_grad(
        lambda o: soft.multilabel_edtsq(labels, o, BENCH_ANISO, True,
                                        binary_occupancy=True), occ, w)


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX package's bench-flag fwd+bwd at 16^3 under each value of
    EDT_TPU_BINARY_GRAD_SCAN, one jitted call each."""
    labels, occ, w = _bench_inputs()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for scan in ("1", "0"):
            mp.setenv(SCAN_KNOB, scan)
            out[scan] = _jax_bench(labels, occ, w)
    return out


def test_default_kernels_ignore_disable_pallas(monkeypatch, jax_bench):
    """With a card (patched), every pass with no kernels= runs the
    kernels' wrappers (K2 to K6) whether EDT_TPU_DISABLE_PALLAS is set or
    not, in the transforms and both trainers; the bench-flag
    multilabel_edtsq equals the JAX package's. ``kernels=soft.PLAIN`` is
    the one way to the plain versions."""
    from edt_tpu_torch.models import distance_net, unet3d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = _count_wrappers(monkeypatch)
    labels, occ, w = _bench_inputs()
    small = torch.from_numpy(occ[:6, :7, :8].copy()).requires_grad_()
    net = distance_net.DistanceFieldNet(2, 4)
    unet = unet3d.UNet3D(2, 2, 1)
    feats = torch.from_numpy(np.random.default_rng(3).random(
        (1, 4, 4, 4, 2)).astype(np.float32))
    t0 = {"minplus_argmin", "minplus_grad", "binary_grad_scan"}
    t_soft = {"softmin", "softmin_grad"}
    cases = {
        "multilabel_edtsq": (lambda: _port_bench(labels, occ, w), t0),
        "soft_edtsq t=0.3": (lambda: soft.soft_edtsq(
            small, (1.0, 2.0, 3.0), temperature=0.3).sum().backward(),
            t_soft),
        "soft_sdfsq": (lambda: soft.soft_sdfsq(small, (1.0, 1.0, 1.0)),
                       {"minplus_argmin"}),
        "DistanceFieldNet": (lambda: distance_net.loss_fn(
            net, feats, torch.zeros(1, 4, 4, 4)).backward(), t_soft),
        "UNet3D": (lambda: unet3d.loss_fn(
            unet, feats, torch.zeros(1, 4, 4, 4)).backward(), t_soft),
    }
    for knob in ("1", None):
        if knob is None:
            monkeypatch.delenv(KNOB)
        else:
            monkeypatch.setenv(KNOB, knob)
        for case, (call, want) in cases.items():
            calls.clear()
            got = call()
            assert want <= set(calls), (knob, case, calls)
            if case == "multilabel_edtsq":
                _check(got, jax_bench["1"])
    calls.clear()
    soft.multilabel_edtsq(labels, torch.from_numpy(occ), BENCH_ANISO, True,
                          kernels=soft.PLAIN)
    assert calls == []


def _binary_rows(rng, n=96, B=400.0):
    """The rows of the JAX package's test_binary_scan_grad_matches_gather:
    random two-valued heights, all solid, all zero, zeros only at the
    ends, adjacent zeros."""
    f = (rng.random((8, n)) > 0.4).astype(np.float32) * B
    f[3] = B
    f[4] = 0.0
    f[5, 0] = f[5, -1] = 0.0
    f[5, 1:-1] = B
    f[6, 10:14] = 0.0
    return f


@pytest.mark.parametrize("walled", [False, True], ids=["plain", "walled"])
def test_binary_grad_matches_jax_under_either_scan_knob(monkeypatch, walled):
    """The closed-form binary pass (plain and walled) on the JAX package's
    test rows: under EDT_TPU_BINARY_GRAD_SCAN "0" (JAX's gather on the
    links) and "1" (JAX's scan), the port's backward is K4's scan and
    never K3's gather, its forward bit-equal to JAX's and its gradient
    within rtol=1e-5, atol=1e-5 of it, the same bits under both."""
    from edt_tpu_torch.ops import core

    calls = _count_wrappers(monkeypatch)
    rng = np.random.default_rng(7)
    n = 96
    f = _binary_rows(rng, n)
    cot = rng.standard_normal((8, n)).astype(np.float32)
    if walled:
        base = rng.integers(0, 4, size=(8, n // 8))
        lab = np.kron(base, np.ones((1, 8), np.int64)).astype(np.uint32)
        occ = (lab != 0).astype(np.float32)
        occ[rng.random((8, n)) > 0.7] = 0.0  # occupancy holes: zero sites
        f = occ * np.float32(400.0)
        cnt_j = jsoft._wall_counts(jnp.asarray(lab), 1, True)
        cnt_t = soft._wall_counts(torch.from_numpy(lab.view(np.int32)), 1,
                                  True)

        def jfn(ff):
            return jsoft._multilabel_pass(ff, cnt_j, 1.1, 0.0,
                                          binary_heights=True)

        def tfn(ff):
            return soft._multilabel_pass(ff, cnt_t, 1.1, 0.0, True,
                                         soft.KERNELS)
    else:
        def jfn(ff):
            return jsoft._minplus_hard(ff, jnp.float32(1.3),
                                       binary_heights=True)

        def tfn(ff):
            return soft._MinplusHard.apply(ff, core.f32(1.3), True,
                                           soft.KERNELS)

    got = {}
    for scan in ("0", "1"):
        monkeypatch.setenv(SCAN_KNOB, scan)
        calls.clear()
        port = _port_value_and_grad(tfn, f, cot)
        assert "binary_grad_scan" in calls and "minplus_grad" not in calls, (
            scan, calls)
        ref = _jax_value_and_grad(jfn, f, cot)
        assert np.array_equal(port[0], ref[0])
        np.testing.assert_allclose(port[1], ref[1], rtol=1e-5, atol=1e-5)
        got[scan] = port
    assert np.array_equal(got["0"][0], got["1"][0])
    assert np.array_equal(got["0"][1], got["1"][1])


def test_bench_slice_matches_jax_under_scan_knob(monkeypatch, jax_bench):
    """bench.py's fwd+bwd (multilabel_edtsq at bench flags) on a 16^3
    make_labels volume under EDT_TPU_BINARY_GRAD_SCAN=0: the port's
    backward is K4 on the binary pass and K3 on the other two, as without
    the knob; the forward bit-equal to the JAX package's under the knob
    and the gradient within tolerance of it."""
    labels, occ, w = _bench_inputs()
    monkeypatch.setenv(SCAN_KNOB, "0")
    calls = _count_wrappers(monkeypatch)
    port = _port_bench(labels, occ, w)
    assert calls.count("minplus_grad") == 2, calls
    assert calls.count("binary_grad_scan") == 1, calls
    _check(port, jax_bench["0"])
    assert np.array_equal(port[0], jax_bench["1"][0])
