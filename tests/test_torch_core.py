"""edt_tpu_torch.ops.core against edt_tpu.ops.core on the CPU, bit-exact.

The same numpy inputs, made from a seed, go through the JAX function and
its torch counterpart (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edt_tpu.ops import core as jcore
from edt_tpu_torch.ops import core

torch.set_num_threads(1)

SHAPES = {1: (37,), 2: (9, 41), 3: (5, 6, 33)}


def _case(nd, seed=0, nl=3):
    rng = np.random.default_rng(seed + nd)
    labels = rng.integers(0, nl, size=SHAPES[nd]).astype(np.int32)
    f = rng.random(SHAPES[nd]).astype(np.float32) * 40
    f[labels == 0] = 0
    # an open run: rows whose first pass left INF
    f[..., :3] = np.where(labels[..., :3] != 0, np.inf, 0).astype(np.float32)
    return f, labels


def assert_same(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[fin], ref[fin])


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_segment_bounds(nd):
    _, labels = _case(nd)
    start, end = core.segment_bounds(torch.from_numpy(labels))
    jstart, jend = jcore.segment_bounds(jnp.asarray(labels))
    assert_same(start.numpy(), np.asarray(jstart))
    assert_same(end.numpy(), np.asarray(jend))


@pytest.mark.parametrize("black_border", [False, True])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_rp_pass_sq(nd, black_border):
    _, labels = _case(nd)
    for w in (1.3, 6.0):
        got = core.rp_pass_sq(torch.from_numpy(labels), w, black_border)
        ref = jcore.rp_pass_sq(jnp.asarray(labels), jnp.float32(w),
                               black_border)
        assert_same(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("black_border", [False, True])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_parabolic_pass_sq(nd, black_border, binary):
    f, labels = _case(nd)
    if binary:
        labels = (labels != 0).astype(np.int32)
    for w in (1.3, 6.0):
        got = core.parabolic_pass_sq(torch.from_numpy(f),
                                     torch.from_numpy(labels), w,
                                     black_border, binary=binary)
        ref = jcore.parabolic_pass_sq(jnp.asarray(f), jnp.asarray(labels),
                                      jnp.float32(w), black_border,
                                      binary=binary)
        assert_same(got.numpy(), np.asarray(ref))


def test_parabolic_pass_sq_positional_row_chunk():
    """The fifth positional argument is JAX's ``row_chunk``: the
    multi-label pass, bit-equal to the JAX package (it once landed in
    ``binary`` and ran the binary pass, 37.85 off)."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, (8, 9, 10)).astype(np.int32)
    f = (50 * rng.random((8, 9, 10))).astype(np.float32)
    got = core.parabolic_pass_sq(torch.from_numpy(f), torch.from_numpy(labels),
                                 2.0, True, 256)
    ref = jcore.parabolic_pass_sq(jnp.asarray(f), jnp.asarray(labels),
                                  jnp.float32(2.0), True, 256)
    assert_same(got.numpy(), np.asarray(ref))


def test_minplus_masked_segment_mask():
    """The segment-masked brute force (the oracle of the wall lemma)."""
    f, labels = _case(2, seed=5)
    f[~np.isfinite(f)] = 3.0
    start, _ = core.segment_bounds(torch.from_numpy(labels))
    jstart, _ = jcore.segment_bounds(jnp.asarray(labels))
    w2 = core.f32(1.69)
    for seg, jseg in ((start, jstart), (None, None)):
        got = core.minplus_masked(torch.from_numpy(f), seg, w2, row_chunk=4)
        ref = jcore.minplus_masked(jnp.asarray(f), jseg, jnp.float32(w2),
                                   row_chunk=4)
        assert_same(got.numpy(), np.asarray(ref))
