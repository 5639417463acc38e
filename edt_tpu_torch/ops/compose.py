"""N-D composition of the 1-D EDT passes on torch tensors (counterpart of
``edt_tpu.ops.compose``).

A Rosenfeld–Pfaltz pass along the first axis of ``axis_order``, then a
Felzenszwalb–Huttenlocher parabolic pass along each remaining axis. Each
pass moves its axis last and makes the tensor contiguous, so every pass
works on (rows, n) C-order rows. Arrays are plain (s0, ..., sk) tensors
with anisotropy[k] attached to axis k; C/F order is the API layer's
concern.
"""

from __future__ import annotations

import torch

from edt_tpu_torch.ops import core, minplus
from edt_tpu_torch.utils import profiling


def use_pallas_default():
    """Whether the kernels are the default backend: a CUDA device is
    available. The JAX package's function of this name also returns False
    while ``EDT_TPU_DISABLE_PALLAS`` is set; the port reads no such
    variable, so that one inherited from a JAX run on the CPU never sends
    the card to the plain versions. A plain run is asked for explicitly:
    ``kernels=soft.PLAIN``, or a ``parabolic_fn``/``minplus_fn`` here."""
    return torch.cuda.is_available()


def default_minplus_fn(use_pallas=None):
    """The min-plus backend with the JAX package's contract, (f2d,
    start2d, end2d, w2, masked) -> d2d, walls applied by the caller
    (``core.parabolic_pass_sq``): K1 (through its custom op) when
    ``use_pallas``, default ``use_pallas_default()``; None, the plain
    path, otherwise. The name is the JAX package's: its Pallas kernel is
    K1 here. K1 fuses the walls of a row's interior segment bounds
    (black_border=False); the caller's walls, a min with the same
    parabolas, leave the values unchanged."""
    if use_pallas is None:
        use_pallas = use_pallas_default()
    if not use_pallas:
        return None

    def fn(f2d, seg_start, seg_end, w2, masked=True):
        return torch.ops.edt_tpu_torch.minplus_walls(
            f2d, seg_start if masked else None, seg_end if masked else None,
            w2, False, masked)

    return fn


def default_parabolic_fn(use_pallas=None):
    """The whole parabolic pass on K1 (``minplus.make_parabolic_fn()``)
    when ``use_pallas``, default ``use_pallas_default()``; None, the
    plain path, otherwise."""
    if use_pallas is None:
        use_pallas = use_pallas_default()
    return minplus.make_parabolic_fn() if use_pallas else None


def _along_last(fn, axis, *tensors):
    """Move ``axis`` of every tensor last (contiguous, in a transpose
    span), call fn, move back."""
    moved = profiling.contiguous(*(t.movedim(axis, -1) for t in tensors))
    return fn(*moved).movedim(-1, axis)


def parabolic_along(f, labels, axis, w, black_border, binary=False,
                    parabolic_fn=None, minplus_fn=None):
    """One parabolic pass along ``axis`` of f (labels unused when
    ``binary``), through ``core.parabolic_pass_sq``."""
    if binary:
        return _along_last(
            lambda ff: core.parabolic_pass_sq(
                ff, ff, w, black_border, binary=True,
                parabolic_fn=parabolic_fn, minplus_fn=minplus_fn),
            axis, f)
    return _along_last(
        lambda ff, lab: core.parabolic_pass_sq(
            ff, lab, w, black_border, parabolic_fn=parabolic_fn,
            minplus_fn=minplus_fn),
        axis, f, labels)


def edtsq(
    labels: torch.Tensor,
    anisotropy,
    black_border: bool = False,
    minplus_fn=None,
    binary: bool = False,
    parabolic_fn=None,
    axis_order: tuple | None = None,
) -> torch.Tensor:
    """Squared multi-label anisotropic EDT of an N-D label tensor.

    labels: 0 is background; label boundaries act as walls at distance w.
    anisotropy: (ndim,) voxel pitch per axis. binary: fast path for
    two-valued volumes (nonzero = one foreground label).
    minplus_fn: the min-plus alone, the JAX package's contract
    (f2d, start2d, end2d, w2, masked) -> d2d, with the walls applied after
    it (``core.parabolic_pass_sq``); used only without ``parabolic_fn``.
    parabolic_fn: the parabolic pass, (f2d, labels2d, w2, black_border,
    binary) -> d2d. With neither, ``minplus.make_parabolic_fn()``, which
    runs the K1 kernel on CUDA tensors and its plain version on CPU
    tensors.
    axis_order: static permutation whose first entry takes the RP pass;
    default (nd-1, ..., 0).
    """
    nd = labels.dim()
    anisotropy = [core.f32(a) for a in anisotropy]
    if len(anisotropy) != nd:
        raise ValueError(f"anisotropy must have {nd} components")
    kind, mode_of = "given", None
    if parabolic_fn is None and minplus_fn is None:
        parabolic_fn = minplus.make_parabolic_fn()
        kind, mode_of = "K1", lambda n: minplus.k1_mode(n, not binary)
    if axis_order is None:
        axis_order = tuple(range(nd - 1, -1, -1))

    with profiling.span("edt_tpu_torch.edtsq", labels, shape=labels.shape,
                        binary=binary, dtype=labels.dtype):
        a1 = axis_order[0]
        with profiling.pass_span(labels, a1, "closed_form"):
            f = _along_last(
                lambda lab: core.rp_pass_sq(lab, anisotropy[a1], black_border),
                a1, labels)
        for ax in axis_order[1:]:
            with profiling.pass_span(labels, ax, kind, mode_of):
                f = parabolic_along(f, labels, ax, anisotropy[ax],
                                    black_border, binary, parabolic_fn,
                                    minplus_fn)
    return f


def edt(labels, anisotropy, black_border=False, minplus_fn=None,
        parabolic_fn=None, axis_order=None):
    """Euclidean distance (sqrt of edtsq)."""
    return torch.sqrt(edtsq(labels, anisotropy, black_border, minplus_fn,
                            parabolic_fn=parabolic_fn, axis_order=axis_order))


def sdfsq(labels, anisotropy, black_border=False, minplus_fn=None,
          parabolic_fn=None, axis_order=None):
    """Squared signed distance field: edtsq(x) - edtsq(x == 0)."""
    fg = edtsq(labels, anisotropy, black_border, minplus_fn,
               parabolic_fn=parabolic_fn, axis_order=axis_order)
    bg = edtsq((labels == 0).to(torch.uint8), anisotropy, black_border,
               minplus_fn, binary=True, parabolic_fn=parabolic_fn,
               axis_order=axis_order)
    return fg - bg


def sdf(labels, anisotropy, black_border=False, minplus_fn=None,
        parabolic_fn=None, axis_order=None):
    """Signed distance field: edt(x) - edt(x == 0)."""
    fg = edt(labels, anisotropy, black_border, minplus_fn,
             parabolic_fn=parabolic_fn, axis_order=axis_order)
    bg = torch.sqrt(edtsq((labels == 0).to(torch.uint8), anisotropy,
                          black_border, minplus_fn, binary=True,
                          parabolic_fn=parabolic_fn, axis_order=axis_order))
    return fg - bg
