"""Host-side (NumPy) reference implementation of the multi-label EDT.

A copy of ``edt_tpu.utils.host_reference`` (NumPy only), kept here so the
port imports nothing of the JAX package. Independent reimplementation of
the published algorithms — Rosenfeld & Pfaltz (1966) first pass,
Felzenszwalb & Huttenlocher (2012) parabolic envelope pass with
per-segment restarts — matching the semantics of the reference library
``edt`` (edt.hpp:70-377). Used as:

  * an exact oracle (pass method="fh" for the pure sequential-envelope
    formulation), and
  * the fallback of the NumPy API for axes longer than the device path
    takes.

Two parabolic-pass backends:

  * method="fh": per-row sequential FH envelope scan (the oracle) —
    float64 intercepts like the reference (edt.hpp:187-214), slow.
  * method="auto" (default): rows are processed in chunks by a banded
    min-plus vectorized across the whole chunk — the same radius pruning
    and wall-subsumption lemma the K1 kernel uses, so it is exactly equal
    to the FH result — falling back to the sequential scan only for chunks
    whose pruning radius is genuinely huge.

Emits float32.
"""

from __future__ import annotations

import numpy as np

# rows per vectorized chunk; radius above which a chunk falls back to the
# sequential FH scan (banded work is O(rows * n * radius))
_CHUNK_ROWS = 2048
_BAND_LIMIT = 256


def _rp_row_sq(labels: np.ndarray, w: float, black_border: bool) -> np.ndarray:
    """Closed-form Rosenfeld-Pfaltz multi-label squared EDT of one row."""
    n = labels.shape[0]
    d = np.empty(n, dtype=np.float64)
    if n == 0:
        return d
    idx = np.arange(n)
    neq = labels[1:] != labels[:-1]
    starts = np.concatenate([[0], np.flatnonzero(neq) + 1])
    ends = np.concatenate([starts[1:], [n]])
    seg_of = np.searchsorted(starts, idx, side="right") - 1
    s = starts[seg_of]
    e = ends[seg_of]
    dl = (idx - s + 1.0) * w
    dr = (e - idx + 0.0) * w
    if not black_border:
        dl = np.where(s > 0, dl, np.inf)
        dr = np.where(e < n, dr, np.inf)
    d = np.minimum(dl, dr)
    d[labels == 0] = 0.0
    return d * d


def _parabolic_segment_sq(f: np.ndarray, w: float, bb_left: bool, bb_right: bool):
    """FH lower-envelope scan of one same-label segment (in place).

    Math per Felzenszwalb & Huttenlocher, Theory of Computing 8 (2012),
    anisotropy-corrected as in reference edt.hpp:203-215; the implicit
    border parabolas follow edt.hpp:231-243.
    """
    n = f.shape[0]
    if n == 0:
        return
    w2 = float(w) * float(w)
    ff = f.astype(np.float64)
    # Clamp infinities so intercepts stay finite (reference tofinite,
    # edt.hpp:39-45 — avoids INF - INF in the intercept formula).
    big = np.finfo(np.float32).max - 1.0
    ffc = np.minimum(ff, big)
    v = np.zeros(n, dtype=np.int64)
    ranges = np.empty(n + 1, dtype=np.float64)
    ranges[0] = -np.inf
    ranges[1] = np.inf
    k = 0
    for i in range(1, n):
        while True:
            j = v[k]
            factor = (i - j) * w2
            s_int = (ffc[i] - ffc[j] + factor * (i + j)) / (2.0 * factor)
            if k > 0 and s_int <= ranges[k]:
                k -= 1
            else:
                break
        k += 1
        v[k] = i
        ranges[k] = s_int
        ranges[k + 1] = np.inf

    k = 0
    for i in range(n):
        while ranges[k + 1] < i:
            k += 1
        val = w2 * (i - v[k]) ** 2 + ffc[v[k]]
        if bb_left:
            val = min(val, w2 * (i + 1.0) ** 2)
        if bb_right:
            val = min(val, w2 * (n - i + 0.0) ** 2)
        f[i] = np.float32(val)
    # restore infinities (reference toinfinite, edt.hpp:47-53)
    f[f >= big] = np.inf


def _parabolic_row_sq(f, labels, w, black_border):
    """Multi-segment parabolic pass over one row (reference edt.hpp:344-377)."""
    n = labels.shape[0]
    if n == 0:
        return
    neq = labels[1:] != labels[:-1]
    starts = np.concatenate([[0], np.flatnonzero(neq) + 1])
    ends = np.concatenate([starts[1:], [n]])
    for s, e in zip(starts, ends):
        if labels[s] == 0:
            continue
        _parabolic_segment_sq(
            f[s:e], w, black_border or s > 0, black_border or e < n
        )


def _segment_bounds_rows(labels2d):
    """Per-voxel [start, end) of the same-label run, vectorized over rows.

    int32 throughout: NumPy's int64 accumulate is ~15x slower.
    """
    R, n = labels2d.shape
    idx = np.arange(n, dtype=np.int32)
    neq = labels2d[:, 1:] != labels2d[:, :-1]
    ones = np.ones((R, 1), dtype=bool)
    is_start = np.concatenate([ones, neq], axis=1)
    is_end = np.concatenate([neq, ones], axis=1)
    start = np.maximum.accumulate(
        np.where(is_start, idx, np.int32(0)), axis=1
    )
    end = np.minimum.accumulate(
        np.where(is_end, idx + np.int32(1), np.int32(n))[:, ::-1], axis=1
    )[:, ::-1]
    return start, end


_BIG = np.int32(2 ** 30)  # open-border sentinel for integer wall distances


def _wall_distances(labels2d, black_border):
    """Integer distance to the nearest same-label segment edge per side,
    with _BIG marking an open (non-wall) volume border."""
    n = labels2d.shape[1]
    start, end = _segment_bounds_rows(labels2d)
    idx = np.arange(n, dtype=np.int32)
    li = idx - start
    li += np.int32(1)
    ri = end - idx
    if not black_border:
        li[start == 0] = _BIG
        ri[end == n] = _BIG
    return li, ri


def _rp_rows_sq(labels2d, w, black_border):
    """Vectorized Rosenfeld-Pfaltz pass over all rows at once.

    Integer distances first (cheap int32 ops), one float64 scale+square at
    the end — bit-identical to the per-row formulation ((k*w)^2 in f64,
    cast f32 by the caller).
    """
    li, ri = _wall_distances(labels2d, black_border)
    dmin = np.minimum(li, ri)
    dmin[labels2d == 0] = 0
    d = dmin.astype(np.float64) * w
    d *= d
    d[dmin >= _BIG] = np.inf
    return d


def _parabolic_rows_banded(f2d, labels2d, w, black_border):
    """Vectorized multi-label parabolic pass over a chunk of rows.

    Unmasked banded min-plus + per-segment wall parabolas — exactly equal
    to the per-row FH scan by the wall-subsumption lemma (the same
    derivation as the K1 kernel; pinned bit-identical by
    tests/test_pallas_kernels.py::test_unmasked_plus_walls_equals_masked).
    The offset band is pruned per chunk: winners satisfy
    w2 (i-j)^2 <= bound_row - minf_row. Returns None if the radius exceeds
    _BAND_LIMIT (the caller then uses the sequential scan).
    """
    R, n = f2d.shape
    w2 = float(w) * float(w)
    # integer wall distances; square in f64 with the FH association
    # w2 * (k * k) so 'auto' stays bit-identical to the sequential scan
    li, ri = _wall_distances(labels2d, black_border)
    wi = np.minimum(li, ri)
    wf = wi.astype(np.float64)
    walls = wf * wf
    walls *= w2
    walls[wi >= _BIG] = np.inf

    fb = f2d.astype(np.float64)
    bound_row = np.minimum(fb, walls).max(axis=1)
    minf_row = fb.min(axis=1)
    with np.errstate(invalid="ignore"):  # inf - inf rows resolved below
        gap = bound_row - minf_row
    gap = np.where(np.isfinite(gap), np.maximum(gap, 0.0),
                   np.where(np.isinf(minf_row), 0.0, np.inf))
    gmax = float(gap.max(initial=0.0))
    if not np.isfinite(gmax):
        return None
    radius = int(np.sqrt(gmax / w2)) + 1
    if radius > _BAND_LIMIT:
        return None

    pad = np.full((R, n + 2 * radius), np.inf)
    pad[:, radius:radius + n] = fb
    d = np.full((R, n), np.inf)
    tmp = np.empty((R, n))
    for k in range(-radius, radius + 1):
        np.add(pad[:, radius + k:radius + k + n], w2 * (k * k), out=tmp)
        np.minimum(d, tmp, out=d)
    np.minimum(d, walls, out=d)
    d[labels2d == 0] = 0.0
    return d.astype(np.float32)


def _parabolic_rows_sq(f2d, labels2d, w, black_border, method="auto"):
    """Parabolic pass over (R, n) rows, in place on f2d (float32)."""
    R, n = f2d.shape
    if method == "auto":
        for r0 in range(0, R, _CHUNK_ROWS):
            sl = slice(r0, min(r0 + _CHUNK_ROWS, R))
            out = _parabolic_rows_banded(f2d[sl], labels2d[sl], w,
                                         black_border)
            if out is not None:
                f2d[sl] = out
            else:
                for r in range(sl.start, sl.stop):
                    _parabolic_row_sq(f2d[r], labels2d[r], float(w),
                                      black_border)
    else:
        for r in range(R):
            _parabolic_row_sq(f2d[r], labels2d[r], float(w), black_border)


def edtsq_host(labels: np.ndarray, anisotropy, black_border: bool = False,
               method: str = "auto") -> np.ndarray:
    """Exact multi-label anisotropic squared EDT on the host (N-D).

    method="fh" forces the sequential per-row FH envelope scan everywhere
    (the independent oracle); "auto" uses the vectorized banded evaluation
    when the pruning radius is small (exactly equal output, much faster).
    """
    labels = np.asarray(labels)
    nd = labels.ndim
    anisotropy = np.broadcast_to(np.asarray(anisotropy, dtype=np.float64), (nd,))
    out = np.zeros(labels.shape, dtype=np.float32)
    if labels.size == 0:
        return out

    # Pass 1 along last axis.
    flat_l = labels.reshape(-1, labels.shape[-1])
    flat_o = out.reshape(-1, labels.shape[-1])
    if method == "auto":
        flat_o[:] = _rp_rows_sq(flat_l, float(anisotropy[-1]), black_border)
    else:
        for r in range(flat_l.shape[0]):
            flat_o[r] = _rp_row_sq(flat_l[r], float(anisotropy[-1]),
                                   black_border)

    # Parabolic passes along the remaining axes. moveaxis+reshape may copy,
    # so write the processed block back explicitly.
    for ax in range(nd - 2, -1, -1):
        lm = np.moveaxis(labels, ax, -1)
        om = np.moveaxis(out, ax, -1)
        n = lm.shape[-1]
        moved_shape = om.shape
        lm2 = np.ascontiguousarray(lm).reshape(-1, n)
        om2 = np.ascontiguousarray(om).reshape(-1, n)
        _parabolic_rows_sq(om2, lm2, float(anisotropy[ax]), black_border,
                           method=method)
        out = np.ascontiguousarray(
            np.moveaxis(om2.reshape(moved_shape), -1, ax)
        )
    return out


def edt_host(labels, anisotropy, black_border=False, method="auto"):
    return np.sqrt(edtsq_host(labels, anisotropy, black_border, method))
