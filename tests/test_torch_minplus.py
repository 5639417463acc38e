"""K1 (edt_tpu_torch.ops.minplus) on the CPU: the plain version against
the JAX reference, the wrapper's dispatch and checks, and the build's
failure mode. The CUDA kernel itself is tested in test_torch_cuda.py.

Tolerances: bit-exact everywhere except the plain version against the
JAX Pallas kernel in interpret mode on the binary pass, where the JAX
package allows rtol=1e-6, atol=1e-5 between its own kernel and its jnp
path (tests/test_pallas_kernels.py); against that jnp path the plain
version is bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edt_tpu.ops import core as jcore
from edt_tpu.ops import pallas_kernels as pk
from edt_tpu_torch.ops import _build, core, minplus

PLAIN = minplus.make_parabolic_fn(minplus.minplus_walls_plain)


def _field(kind, seed=0):
    """(f, labels) rows of the regimes K1 has."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        labels = rng.integers(0, 3, size=(13, 200)).astype(np.int32)
        f = rng.random((13, 200)).astype(np.float32) * 25
    elif kind == "mixed":  # a long run: large radii beside small ones
        labels = rng.integers(0, 3, size=(10, 300)).astype(np.int32)
        f = rng.random((10, 300)).astype(np.float32) * 25
        f[:, 100:260] = 500.0
        labels[:, 100:260] = 1
    elif kind == "constant":  # radius 0
        i = np.arange(30, dtype=np.float32)
        f = np.repeat((i ** 2)[:, None], 40, axis=1)
        labels = np.ones((30, 40), np.int32)
        labels[0] = 0
    elif kind == "inf-rows":  # all-INF rows beside finite ones
        f = rng.random((8, 50)).astype(np.float32) * 50
        f[::2] = np.inf
        labels = np.ones((8, 50), np.int32)
    f[labels == 0] = 0
    return f, labels


def assert_same(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[fin], ref[fin])


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("black_border", [False, True])
@pytest.mark.parametrize("kind", ["random", "mixed", "constant", "inf-rows"])
def test_plain_matches_jax_core(kind, black_border, binary):
    f, labels = _field(kind)
    if binary:
        labels = (labels != 0).astype(np.int32)
        f[labels == 0] = 0
    for w in (1.3, 6.0):
        got = core.parabolic_pass_sq(torch.from_numpy(f),
                                     torch.from_numpy(labels), w,
                                     black_border, binary=binary,
                                     parabolic_fn=PLAIN)
        ref = jcore.parabolic_pass_sq(jnp.asarray(f), jnp.asarray(labels),
                                      jnp.float32(w), black_border,
                                      binary=binary)
        assert_same(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("binary", [False, True])
def test_plain_matches_jax_kernel(binary):
    """Against JAX's own K1 (Pallas, interpret mode), black_border on."""
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 3, size=(6, 150)).astype(np.int32)
    if binary:
        labels = (labels != 0).astype(np.int32)
    f = rng.random((6, 150)).astype(np.float32) * 25
    f[labels == 0] = 0
    w = 1.3
    got = core.parabolic_pass_sq(torch.from_numpy(f), torch.from_numpy(labels),
                                 w, True, binary=binary,
                                 parabolic_fn=PLAIN).numpy()
    ref = np.asarray(jcore.parabolic_pass_sq(
        jnp.asarray(f), jnp.asarray(labels), jnp.float32(w), True,
        binary=binary, parabolic_fn=pk.make_parabolic_fn(interpret=True)))
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    if binary:
        assert np.allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-5)
    else:
        assert np.array_equal(got[fin], ref[fin])


def test_wrapper_takes_plain_only_on_cpu():
    f, labels = _field("random")
    ft = torch.from_numpy(f)
    ss, se = core.segment_bounds(torch.from_numpy(labels))
    before = minplus.launches
    got = minplus.minplus_walls(ft, ss, se, 1.69, False, True)
    assert minplus.launches == before  # the plain version launches nothing
    assert_same(got.numpy(),
                minplus.minplus_walls_plain(ft, ss, se, 1.69, False,
                                            True).numpy())
    with pytest.raises(ValueError, match="unsupported device"):
        minplus.minplus_walls(torch.empty(2, 3, device="meta"), None, None,
                              1.0, False, False)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
