"""ctypes bindings for the native RLE kit (a copy of
``edt_tpu.native.rle_native``; the semantics of the reference library's
C++ helpers, edt_voxel_graph.hpp:238-310; see rle.cpp).

The library is built and loaded at first use, not at import.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from edt_tpu_torch.native import build

_I64P = ctypes.POINTER(ctypes.c_int64)

_STARTS_SUFFIX = {
    np.dtype(np.uint8): "u8",
    np.dtype(np.int8): "u8",
    np.dtype(np.bool_): "u8",
    np.dtype(np.uint16): "u16",
    np.dtype(np.int16): "u16",
    np.dtype(np.uint32): "u32",
    np.dtype(np.int32): "u32",
    np.dtype(np.uint64): "u64",
    np.dtype(np.int64): "u64",
    np.dtype(np.float32): "f32",
    np.dtype(np.float64): "f64",
}

SUPPORTED_DTYPES = set(_STARTS_SUFFIX)


@functools.cache
def available() -> bool:
    """Whether the kit can be used here: built already, or g++ to build it."""
    return build.target().exists() or build.compiler() is not None


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build()))
    for suffix in set(_STARTS_SUFFIX.values()):
        fn = getattr(lib, f"edt_run_starts_{suffix}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, _I64P]
    lib.edt_fill_runs.restype = ctypes.c_int
    lib.edt_fill_runs.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        _I64P, _I64P, ctypes.c_int64,
    ]
    lib.edt_copy_runs.restype = ctypes.c_int
    lib.edt_copy_runs.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        _I64P, _I64P, ctypes.c_int64,
    ]
    return lib


def _ptr(a, typ=ctypes.c_void_p):
    return a.ctypes.data_as(typ)


def extract_runs(flat: np.ndarray):
    """label -> list[(start, end)] over a 1-D contiguous array."""
    from edt_tpu_torch.rle import _group_runs

    flat = np.ascontiguousarray(flat)
    n = flat.size
    if n == 0:
        return {}
    starts = np.empty(n, dtype=np.int64)
    fn = getattr(_lib(), f"edt_run_starts_{_STARTS_SUFFIX[flat.dtype]}")
    count = fn(_ptr(flat), n, _ptr(starts, _I64P))
    starts = starts[:count]
    ends = np.concatenate([starts[1:], [n]])
    return _group_runs(flat[starts], starts, ends)


def _runs_arrays(runs_):
    starts = np.asarray([r[0] for r in runs_], dtype=np.int64)
    ends = np.asarray([r[1] for r in runs_], dtype=np.int64)
    return starts, ends


def set_run_voxels(value, runs_, flat: np.ndarray):
    starts, ends = _runs_arrays(runs_)
    val = np.asarray(value, dtype=flat.dtype)
    rc = _lib().edt_fill_runs(
        _ptr(flat), flat.size, flat.itemsize, _ptr(val),
        _ptr(starts, _I64P), _ptr(ends, _I64P), starts.size,
    )
    if rc != 0:
        raise RuntimeError("Invalid run.")


def transfer_run_voxels(runs_, src: np.ndarray, dest: np.ndarray):
    starts, ends = _runs_arrays(runs_)
    rc = _lib().edt_copy_runs(
        _ptr(src), _ptr(dest), dest.size, dest.itemsize,
        _ptr(starts, _I64P), _ptr(ends, _I64P), starts.size,
    )
    if rc != 0:
        raise RuntimeError("Invalid run.")
