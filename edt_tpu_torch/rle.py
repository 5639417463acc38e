"""Run-length label extraction kit: runs / draw / erase / transfer / each
(counterpart of ``edt_tpu.rle``; host code, NumPy in and out).

API- and semantics-compatible with the reference library (edt.pyx:847-994
and edt_voxel_graph.hpp:238-310). Runs are computed over the
*memory-order* flattening of the array (the reference flattens with
stride tricks, edt.pyx:851-879), as (start, end) half-open intervals.

Two backends, as in the JAX package: the native C++ kit
(``edt_tpu_torch.native``, built with g++ at first use) for the dtypes and
layouts it takes, and a vectorized NumPy path for the rest and where no
g++ is on the PATH. ``backend()`` says which one runs. Serial O(N)
bookkeeping belongs on the host, not the card.
"""

from __future__ import annotations

import numpy as np

from edt_tpu_torch.native import rle_native as _native


def backend() -> str:
    """"native" where the C++ kit takes the inputs it supports, else
    "numpy"."""
    return "native" if _native.available() else "numpy"


def reshape(arr, shape, order=None):
    """View ``arr`` with a new shape without copying when contiguous.

    Capability parity with the reference's stride-trick reshape
    (edt.pyx:851-879): the new shape's strides are laid over the RAW
    BUFFER in the requested ``order`` — so an explicit order that differs
    from the array's own contiguity reinterprets the buffer (no copy, no
    logical-order remap), exactly like the reference's as_strided version.
    Realized without manual stride arithmetic: flatten in memory order
    (a view), then reshape that 1-D view with the requested order (NumPy
    returns a view for both). Non-contiguous arrays fall back to a plain
    (copying) reshape — the reference's as_strided would silently read a
    garbage layout there.
    """
    c, f = arr.flags.c_contiguous, arr.flags.f_contiguous
    if order is None:
        if f and not c:
            order = "F"
        elif c:
            order = "C"
        else:
            return arr.reshape(shape)
    if c or f:
        flat = arr.reshape(-1, order="F" if (f and not c) else "C")
        return flat.reshape(shape, order=order)
    return arr.reshape(shape, order=order)


def _flat_memory_order(arr):
    return reshape(arr, (arr.size,))


def runs(labels):
    """Map label -> list of (start, end) runs over the flattened volume.

    Mirrors the reference's extract_runs (edt_voxel_graph.hpp:238-268) via
    edt.pyx:882-894.
    """
    flat = _flat_memory_order(np.asarray(labels))
    if _use_native(flat):
        return _native.extract_runs(flat)
    return _runs_numpy(flat)


def _use_native(flat, *more):
    if not _native.available():
        return False
    arrs = (flat,) + more
    return all(
        a.dtype in _native.SUPPORTED_DTYPES and a.flags.c_contiguous
        for a in arrs
    )


def _runs_numpy(flat):
    n = flat.size
    if n == 0:
        return {}
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    keys = flat[starts]
    return _group_runs(keys, starts, ends)


def _group_runs(keys, starts, ends):
    """Group (start, end) pairs by key, keys ascending (like the reference's
    std::map, edt_voxel_graph.hpp:239), preserving in-key order."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    ss = starts[order].tolist()
    es = ends[order].tolist()
    bounds = np.flatnonzero(ks[1:] != ks[:-1]) + 1
    group_starts = np.concatenate([[0], bounds]).tolist()
    group_ends = np.concatenate([bounds, [ks.size]]).tolist()
    uniq = ks[np.concatenate([[0], bounds])].tolist()
    pairs = list(zip(ss, es))
    return {k: pairs[a:b] for k, a, b in zip(uniq, group_starts, group_ends)}


def _check_runs(rns, voxels):
    for s, e in rns:
        if s < 0 or e > voxels or e < 0 or s >= e:
            raise RuntimeError("Invalid run.")


def draw(label, runs_, image):
    """Write ``label`` into ``image`` under ``runs_``.

    Mirrors the reference's set_run_voxels (edt_voxel_graph.hpp:270-289)
    via edt.pyx:897-915.
    """
    flat = _flat_memory_order(np.asarray(image))
    _check_runs(runs_, flat.size)
    if runs_ and _use_native(flat):
        _native.set_run_voxels(label, runs_, flat)
        return image
    for s, e in runs_:
        flat[s:e] = label
    return image


def erase(runs_, image):
    """Zero ``image`` under ``runs_`` (the reference's edt.pyx:938-948)."""
    return draw(0, runs_, image)


def transfer(runs_, src, dest):
    """Copy ``src`` values to ``dest`` under ``runs_``.

    Mirrors the reference's transfer_run_voxels
    (edt_voxel_graph.hpp:291-310) via edt.pyx:917-936.
    """
    src_flat = _flat_memory_order(np.asarray(src))
    dest_flat = _flat_memory_order(np.asarray(dest))
    assert src_flat.size == dest_flat.size
    _check_runs(runs_, dest_flat.size)
    if runs_ and src_flat.dtype == dest_flat.dtype and _use_native(
        src_flat, dest_flat
    ):
        _native.transfer_run_voxels(runs_, src_flat, dest_flat)
        return dest
    for s, e in runs_:
        dest_flat[s:e] = src_flat[s:e]
    return dest


class _EachView:
    """Sized iterable of (label, image) pairs for :func:`each`.

    ``fg_runs`` maps each nonzero label to its run list; iteration order is
    ascending label (inherited from :func:`runs`). With ``in_place`` one
    buffer is reused: it is yielded read-only and scrubbed back to zero
    after the consumer advances (even if iteration stops via an exception),
    so only the current label's distances are ever visible in it.
    """

    def __init__(self, shape, order, fg_runs, dt, in_place):
        self._shape = shape
        self._order = order
        self._fg_runs = fg_runs
        self._dt = dt
        self._in_place = in_place

    def __len__(self):
        return len(self._fg_runs)

    def _blank(self):
        return np.zeros(self._shape, dtype=np.float32, order=self._order)

    def __iter__(self):
        if not self._in_place:
            for label, rns in self._fg_runs.items():
                out = self._blank()
                transfer(rns, self._dt, out)
                yield label, out
            return
        shared = self._blank()
        for label, rns in self._fg_runs.items():
            transfer(rns, self._dt, shared)
            shared.setflags(write=False)
            try:
                yield label, shared
            finally:
                shared.setflags(write=True)
                erase(rns, shared)


def each(labels, dt, in_place=False):
    """Sized iterable of (label, image): each image holds only that label's
    distances, full volume size, float32.

    Capability parity with the reference's ``edt.each`` (edt.pyx:950-994
    semantics: background label 0 skipped, image order follows the label
    array's memory order, ``in_place=True`` reuses a single read-only
    buffer).
    """
    labels = np.asarray(labels)
    fg_runs = {k: r for k, r in runs(labels).items() if k != 0}
    order = "F" if labels.flags.f_contiguous and not labels.flags.c_contiguous else "C"
    return _EachView(labels.shape, order, fg_runs, dt, in_place)
