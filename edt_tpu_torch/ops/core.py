"""Core 1-D EDT passes on torch tensors (counterpart of ``edt_tpu.ops.core``).

The N-D multi-label EDT decomposes into 1-D passes (Saito–Toriwaki):

  pass 1: Rosenfeld–Pfaltz, here a closed form over per-voxel segment
          bounds (one row scan, ``ops.bounds``):
              d(i) = min(w (i - seg_start(i) + 1), w (seg_end(i) - i))
          with INF where a segment touches an open (non-black) border and
          0 at background, squared at the end;
  pass 2+: Felzenszwalb–Huttenlocher lower envelope, evaluated as a
          min-plus (tropical) transform
              d(i) = min_j f(j) + w^2 (i - j)^2
          followed by the implicit border ("wall") parabolas of each
          same-label segment.

Every value is formed with the same f32 operations in the same order as
the JAX package, so the results are bit-identical to it: the min-plus cost
is ``f + w2 * (k * k)`` with two roundings, and every square is an f32
product of f32 values. No INF - INF is ever formed, so INF propagates
without NaNs.

All functions work along the LAST axis; callers move axes. ``w`` and
``w2`` are Python floats holding f32 values (see ``f32``).
"""

from __future__ import annotations

import numpy as np
import torch

from edt_tpu_torch.ops import bounds
from edt_tpu_torch.utils import profiling

F32 = torch.float32
INF = float("inf")


def f32(x) -> float:
    """Round ``x`` to float32 and return it as a Python float.

    torch casts a Python scalar operand to the tensor's dtype, so a float
    that already holds an f32 value enters f32 arithmetic exactly.
    """
    return float(np.float32(x))


def segment_bounds(labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-voxel [start, end) of the contiguous same-label run along axis -1.

    int32 positions; labels are only compared with ``!=`` (on a card: bool,
    integers and floats, ``bounds.segment_bounds``). ``start`` doubles as
    a segment id. CUDA tensors take the kernel through its custom op, CPU
    tensors the plain version (``ops.bounds``).
    """
    n = labels.shape[-1]
    card = labels.device.type == "cuda"
    with profiling.span("edt_tpu_torch.bounds", labels, n=n,
                        impl="kernel" if card else "plain"):
        if card:
            return torch.ops.edt_tpu_torch.segment_bounds(labels)
        return bounds.segment_bounds_plain(labels)


def rp_pass_sq(labels: torch.Tensor, w: float, black_border: bool) -> torch.Tensor:
    """First-axis multi-label squared EDT along axis -1 (closed form).

    Background = 0; the first voxel of a label run is at distance w from the
    wall; a run touching the volume edge is INF unless ``black_border``.
    """
    n = labels.shape[-1]
    if n == 0:
        return torch.zeros(labels.shape, dtype=F32, device=labels.device)
    w = f32(w)
    start, end = segment_bounds(labels)
    with profiling.span("edt_tpu_torch.first_pass", labels):
        idx = torch.arange(n, dtype=torch.int32, device=labels.device)
        dl = (idx - start + 1).to(F32) * w
        dr = (end - idx).to(F32) * w
        if not black_border:
            dl = torch.where(start > 0, dl, INF)
            dr = torch.where(end < n, dr, INF)
        d = torch.minimum(dl, dr)
        d = torch.where(labels == 0, 0.0, d)
        return d * d


def _minplus_chunk(f: torch.Tensor, seg, w2: float) -> torch.Tensor:
    """Brute-force min-plus over a (rows, n) chunk.

    d[r, i] = min_j f[r, j] + w2 (i - j)^2, restricted to
    seg[r, j] == seg[r, i] when ``seg`` is given. seg=None is the unmasked
    form: foreign-segment candidates can never beat the wall parabolas that
    border_envelopes_sq applies afterwards, so the mask is redundant in the
    full parabolic pass.
    """
    n = f.shape[-1]
    i = torch.arange(n, dtype=F32, device=f.device)
    diff = i[:, None] - i[None, :]
    quad = (diff * diff) * w2  # (n_i, n_j)
    cost = f[..., None, :] + quad  # (rows, n_i, n_j)
    if seg is not None:
        same = seg[..., None, :] == seg[..., :, None]
        cost = torch.where(same, cost, INF)
    return cost.amin(dim=-1)


def minplus_masked(f: torch.Tensor, seg, w2: float,
                   row_chunk: int = 256) -> torch.Tensor:
    """Min-plus transform along axis -1 of (R, n) rows, ``row_chunk`` rows
    at a time so the (rows, n, n) cost tensor stays bounded. ``seg`` is
    (R, n) for the segment-masked form or None for the unmasked form."""
    w2 = f32(w2)
    R = f.shape[0]
    if R <= row_chunk:
        return _minplus_chunk(f, seg, w2)
    out = torch.empty_like(f)
    for r0 in range(0, R, row_chunk):
        sl = slice(r0, r0 + row_chunk)
        out[sl] = _minplus_chunk(f[sl], None if seg is None else seg[sl], w2)
    return out


def border_envelopes_sq(d: torch.Tensor, start: torch.Tensor,
                        end: torch.Tensor, n: int, w2: float,
                        black_border: bool) -> torch.Tensor:
    """Apply the implicit border parabolas of each same-label segment.

    Interior segment boundaries always act as walls; the volume edge does
    only with ``black_border``.
    """
    w2 = f32(w2)
    idx = torch.arange(d.shape[-1], dtype=torch.int32, device=d.device)
    li = (idx - start + 1).to(F32)
    ri = (end - idx).to(F32)
    lwall = (li * li) * w2
    rwall = (ri * ri) * w2
    if not black_border:
        lwall = torch.where(start > 0, lwall, INF)
        rwall = torch.where(end < n, rwall, INF)
    return torch.minimum(d, torch.minimum(lwall, rwall))


def binary_border_sq(d: torch.Tensor, n: int, w2: float) -> torch.Tensor:
    """Whole-row border parabolas of the binary pass with black_border."""
    idx = torch.arange(n, dtype=torch.int32, device=d.device)
    li = (idx + 1).to(F32)
    ri = (n - idx).to(F32)
    return torch.minimum(d, torch.minimum(li * li, ri * ri) * f32(w2))


def parabolic_pass_sq(
    f: torch.Tensor,
    labels: torch.Tensor,
    w: float,
    black_border: bool,
    row_chunk: int = 256,
    minplus_fn=None,
    binary: bool = False,
    parabolic_fn=None,
) -> torch.Tensor:
    """Multi-label parabolic (FH) squared-EDT pass along axis -1, with the
    JAX package's signature.

    ``f`` holds squared distances from previous passes; ``labels`` drives
    the per-segment restarts. ``row_chunk``: rows a chunk of the
    brute-force min-plus (``minplus_masked``). ``parabolic_fn``, if given,
    runs the whole pass (segment bounds, min-plus, walls); signature
    (f2d, labels2d, w2, black_border, binary) -> d2d. Otherwise
    ``minplus_fn``, if given, replaces the brute-force min-plus alone, with
    the JAX package's signature (f2d, start2d, end2d, w2, masked) -> d2d;
    the binary pass hands it f2d as placeholder bounds with masked=False.

    ``binary=True`` is the fast path for two-valued volumes: background
    voxels carry f == 0 and act as sources themselves, which makes segment
    masking and interior wall parabolas redundant.
    """
    n = f.shape[-1]
    if n == 0:
        return f
    w = f32(w)
    w2 = f32(w * w)
    shape = f.shape
    f2 = f.reshape(-1, n)

    if parabolic_fn is not None:
        d = parabolic_fn(f2, labels.reshape(-1, n), w2, black_border, binary)
        return d.reshape(shape)

    if binary:
        with profiling.span("edt_tpu_torch.kernel", f, kernel="minplus"):
            if minplus_fn is None:
                d = minplus_masked(f2, None, w2, row_chunk)
            else:
                d = minplus_fn(f2, f2, f2, w2, masked=False)
        d = d.reshape(shape)
        if not black_border:
            return d
        with profiling.span("edt_tpu_torch.mask", f):
            return binary_border_sq(d, n, w2)

    start, end = segment_bounds(labels)
    with profiling.span("edt_tpu_torch.kernel", f, kernel="minplus"):
        if minplus_fn is None:
            d = minplus_masked(f2, None, w2, row_chunk)
        else:
            d = minplus_fn(f2, start.reshape(-1, n), end.reshape(-1, n), w2,
                           masked=True)
    with profiling.span("edt_tpu_torch.mask", f):
        d = border_envelopes_sq(d.reshape(shape), start, end, n, w2,
                                black_border)
        return torch.where(labels == 0, 0.0, d)
