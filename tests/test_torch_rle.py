"""edt_tpu_torch's run-length kit and device-side per-label extraction
against edt_tpu's, on the CPU.

The kit runs on both of its backends: the native C++ kit (built with g++
into edt_tpu_torch/_build/) and the NumPy path, which the tests select by
reporting the kit unavailable. Inputs are made from a seed with numpy.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import edt_tpu
import edt_tpu.jax_api as edtj
import edt_tpu_torch
from edt_tpu_torch import rle, torch_api
from edt_tpu_torch.native import build, rle_native

torch.set_num_threads(1)


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    if request.param == "native":
        build.build()
    else:
        monkeypatch.setattr(rle_native, "available", lambda: False)
    assert rle.backend() == request.param
    return request.param


def _labels(shape, seed, nl=6, dtype=np.uint32, order="C"):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, nl, size=tuple(-(-s // 3) for s in shape))
    lab = np.kron(base, np.ones((3,) * len(shape), np.uint8))
    lab = lab[tuple(slice(0, s) for s in shape)]
    lab = np.where(rng.random(shape) < 0.1, rng.integers(0, nl, shape), lab)
    lab = lab.astype(dtype)
    return np.asfortranarray(lab) if order == "F" else lab


@pytest.mark.parametrize("kind", ["uint8", "uint16", "int64", "float32",
                                  "float16", "F-order", "strided"])
def test_runs_match_jax(backend, kind):
    if kind in ("F-order", "strided"):
        lab = _labels((9, 10, 11), seed=1, order="F")
        if kind == "strided":  # neither C nor F: flattened by a copy
            lab = lab[:, ::2]
    else:
        lab = _labels((9, 10, 11), seed=2, dtype=kind)
    got = edt_tpu_torch.runs(lab)
    assert got == edt_tpu.runs(lab)
    assert list(got) == sorted(got)
    flat = rle._flat_memory_order(lab)
    # float16 is not a dtype of the native kit: the NumPy path either way
    assert rle._use_native(flat) == (backend == "native"
                                     and kind != "float16")


def test_draw_erase_transfer_match_jax(backend):
    lab = _labels((7, 8, 9), seed=3)
    rns = edt_tpu_torch.runs(lab)
    src = np.random.default_rng(4).random(lab.shape).astype(np.float32)
    for k, runs_ in rns.items():
        got = edt_tpu_torch.draw(k + 5, runs_, np.zeros_like(lab))
        assert np.array_equal(got, edt_tpu.draw(k + 5, runs_,
                                                np.zeros_like(lab)))
        got = edt_tpu_torch.erase(runs_, lab.copy())
        assert np.array_equal(got, edt_tpu.erase(runs_, lab.copy()))
        for dest_dtype in (np.float32, np.float64):  # same and mixed dtypes
            got = edt_tpu_torch.transfer(runs_, src,
                                         np.zeros(lab.shape, dest_dtype))
            ref = edt_tpu.transfer(runs_, src, np.zeros(lab.shape, dest_dtype))
            assert np.array_equal(got, ref)
    img = np.zeros(5, np.uint32)
    for bad in ([(3, 2)], [(0, 9)]):
        with pytest.raises(RuntimeError, match="Invalid run"):
            edt_tpu_torch.draw(1, bad, img)
        with pytest.raises(RuntimeError, match="Invalid run"):
            edt_tpu_torch.transfer(bad, img, img.copy())


def test_reshape_matches_jax():
    arr = np.arange(24, dtype=np.uint32).reshape(2, 3, 4)
    for a in (arr, np.asfortranarray(arr), arr[:, ::2]):
        for shape, order in (((24,), None), ((4, 6), None), ((6, 4), "F"),
                             ((6, 4), "C")):
            if a.size != 24 and shape != (24,):
                continue
            size_shape = (a.size,) if shape == (24,) else shape
            got = edt_tpu_torch.reshape(a, size_shape, order=order)
            ref = edt_tpu.reshape(a, size_shape, order=order)
            assert np.array_equal(got, ref)
            assert np.shares_memory(got, a) == np.shares_memory(ref, a)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("order", ["C", "F"])
def test_each_matches_jax(backend, in_place, order):
    lab = _labels((10, 11, 12), seed=5, order=order)
    dt = edt_tpu.edt(lab, (1.0, 2.0, 3.0), True)
    view = edt_tpu_torch.each(lab, dt, in_place=in_place)
    ref = {k: img.copy() for k, img in edt_tpu.each(lab, dt)}
    assert len(view) == len(ref) == len(np.unique(lab[lab != 0]))
    got = {}
    for k, img in view:
        assert img.dtype == np.float32 and img.shape == lab.shape
        assert img.flags.f_contiguous == (order == "F")
        assert img.flags.writeable == (not in_place)
        got[k] = img.copy()
    assert list(got) == list(ref)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
        assert np.array_equal(got[k], (lab == k) * dt), k


def test_in_place_buffer_is_read_only_and_scrubbed(backend):
    lab = _labels((8, 9, 10), seed=6)
    dt = np.random.default_rng(7).random(lab.shape).astype(np.float32) + 1
    it = iter(edt_tpu_torch.each(lab, dt, in_place=True))
    k, img = next(it)
    with pytest.raises(ValueError):
        img[0, 0, 0] = 1.0
    assert np.count_nonzero(img) == np.count_nonzero(lab == k)
    k2, img2 = next(it)  # advancing scrubs the first label's voxels
    assert img2 is img and k2 != k
    assert np.count_nonzero(img) == np.count_nonzero(lab == k2)
    it.close()  # the consumer stops early: the buffer is scrubbed
    assert img.flags.writeable and not img.any()
    for _, img in edt_tpu_torch.each(lab, dt, in_place=True):
        break  # a for loop that breaks releases its generator the same way
    assert not img.any()


def test_backend_and_native_build():
    path = build.build()
    assert path.parent == build.BUILD_DIR and path.exists()
    assert path.name.startswith("rle-") and build.build() == path
    assert rle_native.available() and rle.backend() == "native"


def test_native_build_force(tmp_path, monkeypatch):
    """build() reuses the hashed target; build(force=True) and ``python -m
    edt_tpu_torch.native.build --force`` compile it again all the same,
    as the JAX package's ``build(force=True)`` and ``--force`` do."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    path = build.build()
    ino = path.stat().st_ino
    assert path.parent == tmp_path
    assert build.build() == path and path.stat().st_ino == ino
    assert build.build(force=True) == path and path.stat().st_ino != ino
    monkeypatch.undo()
    t0 = time.time_ns()
    out = subprocess.run(
        [sys.executable, "-m", "edt_tpu_torch.native.build", "--force"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    built = Path(out.stdout.strip())
    assert built == build.target() and built.stat().st_mtime_ns >= t0


def test_extract_label_and_each_device_match_jax():
    lab = _labels((9, 8, 7), seed=8, dtype=np.int32)
    dt = edt_tpu.edt(lab, (2.0, 1.0, 1.0))
    lt, dtt = torch.from_numpy(lab), torch.from_numpy(dt)
    for k in (0, 1, 4):
        got = torch_api.extract_label(lt, dtt, k)
        assert np.array_equal(got.numpy(),
                              np.asarray(edtj.extract_label(lab, dt, k)))
    ref = {int(k): np.asarray(v) for k, v in edtj.each_device(lab, dt)}
    got = {k: v.numpy() for k, v in torch_api.each_device(lt, dtt)}
    assert list(got) == list(ref) and 0 not in got
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    some = list(ref)[:2]
    assert list(dict(torch_api.each_device(lt, dtt, ids=some))) == some


def test_extract_labels_matches_jax():
    lab = _labels((7, 9, 8), seed=9, dtype=np.int32)
    dt = edt_tpu.edt(lab, (1.0, 2.0, 1.0))
    ids = sorted(int(u) for u in np.unique(lab) if u)
    got = torch_api.extract_labels(torch.from_numpy(lab),
                                   torch.from_numpy(dt), ids)
    ref = np.asarray(edtj.extract_labels(lab, dt, ids))
    assert got.shape == (len(ids), *lab.shape)
    assert np.array_equal(got.numpy(), ref)
    host = {k: img.copy() for k, img in edt_tpu_torch.each(lab, dt)}
    for k, slab in zip(ids, got.numpy()):
        assert np.array_equal(slab, host[k]), k
