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
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        edt_tpu_torch.edtsq(np.ones((2, 2), np.uint8),
                            voxel_graph=np.ones((2, 2), np.uint8),
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


def test_import_hygiene():
    """edt_tpu_torch imports neither jax nor anything of edt_tpu."""
    code = ("import sys, edt_tpu_torch, edt_tpu_torch.ops.compose, "
            "edt_tpu_torch.ops.argmin, edt_tpu_torch.ops.grad, "
            "edt_tpu_torch.ops.softmin, edt_tpu_torch.models, "
            "edt_tpu_torch.models.distance_net, edt_tpu_torch.models.unet3d; "
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
