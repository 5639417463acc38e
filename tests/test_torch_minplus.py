"""K1 (edt_tpu_torch.ops.minplus) on the CPU: the plain version against
the JAX reference, the wrapper's dispatch and checks, and the build's
failure mode. The CUDA kernel itself is tested in test_torch_cuda.py.

Tolerances: bit-exact everywhere except the plain version against the
JAX Pallas kernel in interpret mode on the binary pass, where the JAX
package allows rtol=1e-6, atol=1e-5 between its own kernel and its jnp
path (tests/test_pallas_kernels.py); against that jnp path the plain
version is bit-exact.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edt_tpu.ops import core as jcore
from edt_tpu.ops import pallas_kernels as pk
from edt_tpu_torch.ops import _build, core, minplus

torch.set_num_threads(1)

PLAIN = minplus.make_parabolic_fn(minplus.minplus_walls_plain)
ROOT = pathlib.Path(__file__).resolve().parent.parent


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


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _search_rows(kind, rng):
    """(f, labels) rows that stress the kernel's exact stop."""
    if kind == "near-3e7":  # ulp 2: neighbouring costs round together
        f = (3e7 + rng.random((8, 120)) * 200).astype(np.float32)
        f[4:, ::17] = 2.99999e7
        labels = rng.integers(1, 3, size=(8, 120)).astype(np.int32)
    elif kind == "partly-inf":  # INF heights, one wholly INF row
        f = (rng.random((8, 120)) * 900).astype(np.float32)
        f[rng.random((8, 120)) < 0.3] = np.inf
        f[1] = np.inf
        labels = np.repeat(rng.integers(0, 3, size=(8, 4)), 30, axis=1)
    elif kind == "one-voxel-segments":
        f = (rng.random((8, 120)) * 90).astype(np.float32)
        labels = np.broadcast_to(np.arange(120) % 3 + 1, (8, 120)).copy()
    else:  # sparse sources: long searches, capped by the row radius
        f = np.full((8, 120), 1e4, np.float32)
        f[:, ::37] = rng.random((8, 4)) * 50
        f[2] = np.inf
        f[2, 100] = 0.0
        labels = np.ones((8, 120), np.int32)
    f[labels == 0] = 0
    return f, labels.astype(np.int32)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("kind", ["near-3e7", "partly-inf",
                                  "one-voxel-segments", "sparse-sources"])
def test_search_emulation_matches_plain_and_jax(kind, binary):
    """The kernel's outward search with its exact stop (under the row
    radius, stopping before step k once min f + w2 k^2 > min(best, wall)),
    emulated in torch by ``chip_smoke.k1_search``: bit-exact to the plain
    version and to the JAX package, w2 integer and not."""
    search = _chip_smoke().k1_search
    emulated = minplus.make_parabolic_fn(
        lambda *args, **kw: search(*args, **kw)[0])
    f, labels = _search_rows(kind, np.random.default_rng(4))
    if binary:
        labels = (labels != 0).astype(np.int32)
        f[labels == 0] = 0
    ft, lt = torch.from_numpy(f), torch.from_numpy(labels)
    for w in (0.7, 1.0, 6.0, 30.0):
        for bb in (False, True):
            got = core.parabolic_pass_sq(ft, lt, w, bb, binary=binary,
                                         parabolic_fn=emulated).numpy()
            assert_same(got, core.parabolic_pass_sq(
                ft, lt, w, bb, binary=binary, parabolic_fn=PLAIN).numpy())
            ref = jcore.parabolic_pass_sq(jnp.asarray(f), jnp.asarray(labels),
                                          jnp.float32(w), bb, binary=binary)
            assert_same(got, np.asarray(ref))
