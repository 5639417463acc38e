"""edt_tpu_torch's NumPy API against edt_tpu.api on the CPU, and the
port's import hygiene.

Each case feeds the same numpy volume (made from a seed) to the JAX API
and to the port with ``device="cpu"``. The squared forms are bit-exact;
so are the sqrt forms, since both sides take np.sqrt of equal f32 values.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import edt_tpu
import edt_tpu_torch
from edt_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _labels(shape, seed=0, nl=4, dtype=np.uint32):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, nl, size=tuple(-(-s // 4) for s in shape))
    lab = np.kron(base, np.ones((4,) * len(shape), dtype=np.uint8))
    lab = lab[tuple(slice(0, s) for s in shape)]
    noise = rng.random(shape) < 0.1  # single voxels break up the blocks
    lab = np.where(noise, rng.integers(0, nl, size=shape), lab)
    return lab.astype(dtype)


def assert_same(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[fin], ref[fin])


@pytest.mark.parametrize("name,shape,aniso,bb", [
    ("edtsq", (24, 31, 40), (6.0, 6.0, 30.0), True),
    ("edtsq", (24, 31, 40), (1.3, 1.0, 2.0), False),
    ("sdfsq", (20, 17, 26), (6.0, 6.0, 30.0), False),
    ("sdf", (20, 17, 26), (6.0, 6.0, 30.0), True),
    ("edt", (33, 48), (1.3, 1.3), True),
    ("binary_edtsq", (19, 23, 12), (1.0, 1.0, 1.0), False),
    ("binary_edt", (19, 23, 12), (6.0, 6.0, 30.0), True),
])
def test_api_matches_jax(name, shape, aniso, bb):
    data = _labels(shape, seed=len(name))
    got = getattr(edt_tpu_torch, name)(data, aniso, bb, device="cpu")
    ref = getattr(edt_tpu, name)(data, aniso, bb)
    assert_same(got, ref)


def test_fixed_dimension_entry_points():
    d1, d2, d3 = _labels((45,), 1), _labels((21, 30), 2), _labels((9, 10, 11), 3)
    assert_same(edt_tpu_torch.edt1d(d1, 1.3, True, device="cpu"),
                edt_tpu.edt1d(d1, 1.3, True))
    assert_same(edt_tpu_torch.edt1dsq(d1, device="cpu"), edt_tpu.edt1dsq(d1))
    assert_same(edt_tpu_torch.edt2d(d2, (1.0, 2.0), device="cpu"),
                edt_tpu.edt2d(d2, (1.0, 2.0)))
    assert_same(edt_tpu_torch.edt3d(d3, (2.0, 1.0, 1.0), True, device="cpu"),
                edt_tpu.edt3d(d3, (2.0, 1.0, 1.0), True))


@pytest.mark.parametrize("dtype", ["uint32", "int64-factorized", "float32",
                                   "bool", "uint16", "int8"])
def test_dtypes(dtype):
    data = _labels((14, 15, 16), seed=5)
    if dtype == "int64-factorized":  # ids beyond int32 need the factorization
        data = np.where(data == 0, 0, data.astype(np.int64) * (2 ** 40) + 7)
    elif dtype == "bool":
        data = data != 0
    else:
        data = data.astype(dtype)
    got = edt_tpu_torch.edtsq(data, (1.0, 2.0, 3.0), device="cpu")
    assert_same(got, edt_tpu.edtsq(data, (1.0, 2.0, 3.0)))


def test_orders_lists_and_empty():
    data = _labels((12, 13, 14), seed=7)
    fdata = np.asfortranarray(data)
    got = edt_tpu_torch.edtsq(fdata, device="cpu")
    assert got.flags.f_contiguous
    assert_same(got, edt_tpu.edtsq(fdata))
    strided = data[:, ::2, ::-1]  # neither C nor F: made contiguous first
    assert_same(edt_tpu_torch.edtsq(strided, device="cpu"),
                edt_tpu.edtsq(strided))
    lst = [[0, 1, 1, 2], [1, 1, 0, 2]]
    assert_same(edt_tpu_torch.edtsq(lst, device="cpu"), edt_tpu.edtsq(lst))
    for shape in ((0,), (3, 0), (0, 2, 2)):
        out = edt_tpu_torch.edtsq(np.zeros(shape, np.uint32), device="cpu")
        assert out.shape == shape and out.dtype == np.float32


def test_dims_errors():
    with pytest.raises(TypeError, match="up to 3 dimensions"):
        edt_tpu_torch.edtsq(np.ones((2, 2, 2, 2), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="anisotropy"):
        edt_tpu_torch.edtsq(np.ones((2, 2), np.uint8), (1.0, 2.0, 3.0),
                            device="cpu")
    with pytest.raises(TypeError, match="only supported for 2D and 3D"):
        edt_tpu_torch.edtsq(np.ones(4, np.uint8), voxel_graph=np.ones(4),
                            device="cpu")
    with pytest.raises(ValueError, match="must match data shape"):
        edt_tpu_torch.edtsq(np.ones((2, 2), np.uint8),
                            voxel_graph=np.ones((2, 3), np.uint8),
                            device="cpu")


def test_long_axis_takes_host_fallback():
    data = _labels((3, 150), seed=9)
    before = counters.host_fallbacks
    got = edt_tpu_torch.edtsq(data, (2.0, 1.0), True, device="cpu")
    assert counters.host_fallbacks == before + 1
    assert_same(got, edt_tpu.edtsq(data, (2.0, 1.0), True))


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edt_tpu_torch.edtsq(np.ones((3, 3), np.uint8))


def test_default_minplus_and_parabolic_fn():
    """``default_minplus_fn`` and ``default_parabolic_fn`` keep the JAX
    package's meaning: None where the plain path runs (use_pallas False,
    or None without CUDA), else the kernel-backed function, which on CPU
    tensors takes K1's plain version; either gives the JAX package's
    transform bit for bit."""
    import jax
    import jax.numpy as jnp

    from edt_tpu.ops import compose as jcompose
    import edt_tpu_torch.torch_api as tapi

    assert {"default_minplus_fn", "default_parabolic_fn"} <= set(tapi.__all__)
    for name in ("default_minplus_fn", "default_parabolic_fn"):
        fn = getattr(tapi, name)
        assert fn(use_pallas=False) is None
        assert (fn() is None) == (not torch.cuda.is_available())
    lab = _labels((10, 11, 12), seed=4)
    an = (1.0, 2.0, 3.0)
    for bb in (True, False):
        ref = jax.jit(lambda v: jcompose.edtsq(v, an, bb))(  # noqa: B023
            jnp.asarray(lab))
        lt = torch.from_numpy(lab.view(np.int32))
        for kw in ({"minplus_fn": tapi.default_minplus_fn(True)},
                   {"parabolic_fn": tapi.default_parabolic_fn(True)}):
            assert_same(tapi.edtsq(lt, an, bb, **kw).numpy(), np.asarray(ref))
        m = torch.from_numpy((lab != 0).astype(np.uint8))
        ref = jax.jit(lambda v: jcompose.edtsq(v, an, bb, None, True))(  # noqa: B023
            jnp.asarray(m.numpy()))
        assert_same(tapi.edtsq(m, an, bb, tapi.default_minplus_fn(True),
                               True).numpy(), np.asarray(ref))


KNOB = "EDT_TPU_DISABLE_PALLAS"


def _set_knob(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _count_k1(monkeypatch):
    """Calls of K1's wrapper, which its custom op (the kernel-backed
    pass) calls by its module name; the plain pass never does."""
    from edt_tpu_torch.ops import minplus

    calls = []
    real = minplus.minplus_walls

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(minplus, "minplus_walls", counted)
    return calls


def test_use_pallas_default_is_the_card(monkeypatch):
    """``compose.use_pallas_default()`` is "a card", read at each call, and
    ``default_minplus_fn(None)``/``default_parabolic_fn(None)`` follow it.
    EDT_TPU_DISABLE_PALLAS (unset, empty, "1", "0") changes neither it nor
    the API's device ceiling (58048 on a card, 128 on the CPU), though the
    JAX package's ``use_pallas_default`` is False while it is set: the
    port reads no variable that would send the card to the plain
    versions."""
    from edt_tpu.ops import compose as jcompose
    from edt_tpu_torch import api
    from edt_tpu_torch.ops import compose

    for card in (True, False):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: card)  # noqa: B023
        for knob in (None, "", "1", "0"):
            _set_knob(monkeypatch, KNOB, knob)
            assert compose.use_pallas_default() is card
            if knob:
                assert jcompose.use_pallas_default() is False
            for fn in (compose.default_minplus_fn,
                       compose.default_parabolic_fn):
                assert (fn() is None) is (not card)
            assert api._device_max_axis(torch.device("cpu")) == 128
            assert api._device_max_axis(torch.device("cuda")) == 58048


def test_api_keeps_k1_under_disable_pallas(monkeypatch):
    """With a card (patched) and ``device="cpu"``, the API's single-device
    transform and voxel graph run K1's pass whether EDT_TPU_DISABLE_PALLAS
    is set or not, bit-equal to the JAX API, which runs its plain path
    under the knob. Without a card and without ``device=`` the call
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    k1 = _count_k1(monkeypatch)
    data = _labels((12, 13, 14), seed=11)
    graph = np.random.default_rng(12).integers(0, 64, data.shape).astype(
        np.uint8)
    an = (6.0, 6.0, 30.0)
    for knob in ("1", None):
        _set_knob(monkeypatch, KNOB, knob)
        for kw in ({}, {"voxel_graph": graph}):
            k1.clear()
            got = edt_tpu_torch.edtsq(data, an, True, device="cpu", **kw)
            assert len(k1) > 0, (knob, kw.keys())
            assert_same(got, edt_tpu.edtsq(data, an, True, **kw))
    monkeypatch.setenv(KNOB, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edt_tpu_torch.edtsq(data)


def test_auto_shard_keeps_k1_under_the_knob(monkeypatch):
    """The API's auto-shard path keeps its kernels under
    EDT_TPU_DISABLE_PALLAS, as the JAX package's ``edtsq_sharded_auto``
    does: K1's pass on every slab (four ``cpu`` slabs here), bit-equal to
    one device."""
    from edt_tpu_torch import api

    data = _labels((16, 12, 8), seed=13)
    want = edt_tpu_torch.edtsq(data, (4.0, 1.0, 2.0), True, device="cpu")
    monkeypatch.setenv(KNOB, "1")
    monkeypatch.setenv("EDT_TPU_SHARD_MIN_VOXELS", "1")
    monkeypatch.setattr(api, "_shard_devices",
                        lambda device: [torch.device("cpu")] * 4)
    k1 = _count_k1(monkeypatch)
    before = counters.sharded_dispatches
    got = edt_tpu_torch.edtsq(data, (4.0, 1.0, 2.0), True, device="cpu")
    assert counters.sharded_dispatches == before + 1
    assert len(k1) > 0
    assert_same(got, want)


def test_import_hygiene():
    """edt_tpu_torch imports neither jax nor anything of edt_tpu: every
    module of the package, found by walking it, imported in a fresh
    interpreter, and every source (and chip_smoke.py) read."""
    code = ("import importlib, pkgutil, sys, edt_tpu_torch; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "edt_tpu_torch.__path__, 'edt_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert len(mods) >= 25, mods; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'edt_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|edt_tpu)\b", re.M)
    sources = list((ROOT / "edt_tpu_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 5
    for src in sources:
        assert not pat.search(src.read_text()), src
