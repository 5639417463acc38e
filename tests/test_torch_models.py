"""edt_tpu_torch.models.distance_net and .unet3d against the JAX package's
models on the CPU, at small sizes.

The same parameters (the JAX package's ``init_params``, handed over as
NumPy through ``params_from_jax``) and the same NumPy features and
targets go through both. Tolerances: logits rtol=1e-5 for the MLP
(f32 matmuls on both sides) and rtol=1e-4, atol=1e-5 for the U-Net (the
convolutions sum in another order); losses and parameters after Adam
steps rtol=1e-4, atol=1e-5 (the softmin transform agrees to f32 round-off,
and Adam's first steps move each parameter by about lr whatever the size
of its gradient).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from edt_tpu.models import distance_net as jdn
from edt_tpu.models import unet3d as jun
from edt_tpu.ops import compose as jcompose
from edt_tpu_torch.models import distance_net, unet3d

SHAPE = (8, 8, 8)


def _batch(batch, c_in, seed=0):
    """NumPy (feats, target) of the toy task, from the port's generator."""
    feats, target = distance_net.synthetic_batch(
        np.random.default_rng(seed), batch, SHAPE, c_in, device="cpu")
    return feats.numpy(), target.numpy()


def _init(init_params, seed, **kw):
    """The JAX package's parameters, jitted: one compile, not one for each
    random draw."""
    return jax.jit(functools.partial(init_params, **kw))(
        jax.random.PRNGKey(seed))


def _assert_params_close(model, jparams, flat):
    ref = flat(jparams)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _train_both(model, jparams, jstep, step, feats, target, n):
    opt_state = optax.adam(3e-3).init(jparams)
    for _ in range(n):
        jparams, opt_state, jloss = jstep(jparams, opt_state,
                                          jnp.asarray(feats),
                                          jnp.asarray(target))
        loss = step(torch.from_numpy(feats), torch.from_numpy(target))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    return jparams


def test_distance_net_logits_match_jax():
    jparams = _init(jdn.init_params, 0, c_in=4, hidden=8)
    model = distance_net.DistanceFieldNet(4, 8)
    model.load_state_dict(distance_net.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    feats, _ = _batch(2, 4)
    ref = np.asarray(jax.jit(jdn.apply)(jparams, jnp.asarray(feats)))
    got = model(torch.from_numpy(feats)).detach().numpy()
    assert got.shape == (2, *SHAPE)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_distance_net_adam_steps_match_jax():
    jparams = _init(jdn.init_params, 1, c_in=4, hidden=8)
    model = distance_net.DistanceFieldNet(4, 8)
    model.load_state_dict(distance_net.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    opt = torch.optim.Adam(model.parameters(), lr=3e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    step = distance_net.make_train_step(model, opt, temperature=0.3,
                                        barrier=16.0)
    jstep = jdn.make_train_step(optax.adam(3e-3), temperature=0.3,
                                barrier=16.0)
    feats, target = _batch(2, 4, seed=1)
    jparams = _train_both(model, jparams, jstep, step, feats, target, 3)
    _assert_params_close(
        model, jparams,
        lambda p: distance_net.params_from_jax(jax.tree.map(np.asarray, p)))


def test_synthetic_batch_target_is_edtsq_of_its_boxes():
    feats, target = distance_net.synthetic_batch(
        np.random.default_rng(5), 2, SHAPE, 3, device="cpu")
    labels = distance_net._box_labels(np.random.default_rng(5), 2, SHAPE)
    assert feats.shape == (2, *SHAPE, 3) and target.shape == (2, *SHAPE)
    assert labels.any(axis=(1, 2, 3)).all()
    for b in range(2):
        ref = np.asarray(jcompose.edtsq(jnp.asarray(labels[b]),
                                        jnp.ones(3, jnp.float32), True))
        assert np.array_equal(target[b].numpy(), ref)
    # the noise is small beside the unit step between background and box
    assert np.abs(feats.numpy() - labels[..., None]).max() < 1.0


def _unet_pair(levels, seed):
    jparams = _init(jun.init_params, seed, c_in=4, c0=4, levels=levels)
    model = unet3d.UNet3D(4, 4, levels)
    model.load_state_dict(unet3d.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jparams, model


def test_unet3d_apply_matches_jax():
    jparams, model = _unet_pair(2, 2)
    assert unet3d.num_levels(model) == jun.num_levels(jparams) == 2
    feats, _ = _batch(1, 4, seed=2)
    ref = np.asarray(jax.jit(jun.apply)(jparams, jnp.asarray(feats)))
    got = model(torch.from_numpy(feats)).detach().numpy()
    assert got.shape == (1, *SHAPE)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_unet3d_train_step_matches_jax():
    jparams, model = _unet_pair(1, 3)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    step = unet3d.make_train_step(model, opt, temperature=0.3, barrier=16.0)
    jstep = jun.make_train_step(optax.adam(3e-3), temperature=0.3,
                                barrier=16.0)
    feats, target = _batch(1, 4, seed=3)
    jparams = _train_both(model, jparams, jstep, step, feats, target, 1)
    _assert_params_close(
        model, jparams,
        lambda p: unet3d.params_from_jax(jax.tree.map(np.asarray, p)))


@pytest.mark.parametrize("n,stride,pads", [
    (8, 1, [1, 1]), (8, 2, [0, 1]), (7, 2, [1, 1]), (8, 1, None)])
def test_unet3d_same_padding(n, stride, pads):
    """XLA's "SAME": (1, 1) for k = 3 at stride 1, (0, 1) at stride 2 on an
    even extent, (1, 1) on an odd one; none for k = 1."""
    k = 1 if pads is None else 3
    got = unet3d._same_pads((n, n, n), k, stride)
    assert got == (pads or [0, 0]) * 3
