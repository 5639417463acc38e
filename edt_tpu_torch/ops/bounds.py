"""Segment bounds and wall counts: one scan of each row of labels.

``core.segment_bounds`` (each label run's [start, end) along the last
axis, int32) and ``models.soft._wall_counts`` (the distance in voxels to
the nearest label-boundary wall along an axis, in the volume's own
layout) run the kernel ``csrc/bounds.cu`` (CUDA C++ for sm_90a, built by
``_build``, bound with ctypes) on CUDA tensors and their plain versions,
``segment_bounds_plain`` and ``wall_counts_plain`` (the JAX package's
cummax / cummin formulation in torch), on CPU tensors. The kernel
replaces no Pallas kernel: the JAX package leaves these scans to XLA.

The kernel reads each label once and writes each output once, a warp a
row where the scanned axis is the last (stride 1), a thread a column
where it is strided; the wrapper picks the layout from the input's shape.
Labels compare with their own type's ``!=`` (integers of one width share
an instantiation; floats keep -0.0 == 0.0 and NaN != NaN); any other type
raises. ``launches`` counts the kernel launches, ``card_launches`` those
on each card (by device index); every launch runs on its tensor's card.

Both are ``torch.library`` custom ops, ``edt_tpu_torch::segment_bounds``
and ``edt_tpu_torch::wall_counts`` (with fake implementations), so an
export on a card records each scan as one node. Their callers take the op
for CUDA tensors only and call the plain versions on the CPU, so graphs
exported on the CPU keep the torch ops.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from edt_tpu_torch.ops import _build
from edt_tpu_torch.ops.wall_sentinels import WALL_SENT16, WALL_SENT32

# csrc/bounds.cu's label kinds: integers (and bool) by width, floats by type
_KINDS = {
    torch.bool: 0, torch.uint8: 0, torch.int8: 0,
    torch.int16: 1, torch.uint16: 1,
    torch.int32: 2, torch.uint32: 2,
    torch.int64: 3, torch.uint64: 3,
    torch.float16: 4, torch.bfloat16: 5, torch.float32: 6, torch.float64: 7,
}

# the kernel forms positions and counts (up to 2n + 2) in int32
MAX_AXIS = (1 << 30) - 1

launches = 0
card_launches: dict[int, int] = {}


def count_dtype(n: int):
    """(dtype, sentinel) of the wall counts of an axis of n voxels: int16
    while 2n + 2 fits it (``argmin.I16_MAX_AXIS``), else int32."""
    from edt_tpu_torch.ops.argmin import I16_MAX_AXIS

    if n <= I16_MAX_AXIS:
        return torch.int16, WALL_SENT16
    return torch.int32, WALL_SENT32


def segment_bounds_plain(labels):
    """Plain PyTorch version: (start, end) int32 of each voxel's run along
    axis -1, from cummax / cummin scans of the label changes."""
    n = labels.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=labels.device)
    neq = labels[..., 1:] != labels[..., :-1]
    pad = torch.ones(labels.shape[:-1] + (1,), dtype=torch.bool,
                     device=labels.device)
    is_start = torch.cat([pad, neq], dim=-1)
    is_end = torch.cat([neq, pad], dim=-1)
    start = torch.where(is_start, idx, 0).cummax(dim=-1).values
    end = (torch.where(is_end, idx + 1, n).flip(-1)
           .cummin(dim=-1).values.flip(-1))
    return start, end


def wall_counts_plain(labels, axis, black_border):
    """Plain PyTorch version: min(i - start + 1, end - i) along ``axis``,
    in labels' own layout, in ``count_dtype``; the sentinel at an open
    side (a run touching the volume edge without ``black_border``)."""
    n = labels.shape[axis]
    idt, sent = count_dtype(n)
    shape1 = [1] * labels.dim()
    shape1[axis] = n
    idx = torch.arange(n, dtype=idt, device=labels.device).reshape(shape1)
    neq = labels.narrow(axis, 1, n - 1) != labels.narrow(axis, 0, n - 1)
    pad_shape = list(labels.shape)
    pad_shape[axis] = 1
    edge = torch.full(pad_shape, bool(black_border), dtype=torch.bool,
                      device=labels.device)
    is_start = torch.cat([edge, neq], dim=axis)
    is_end = torch.cat([neq, edge], dim=axis)
    # a missing start marker (open-left run) gives li = i + n + 2 > n
    li = (idx - torch.where(is_start, idx, -(n + 1)).cummax(dim=axis).values
          + 1)
    ri = (torch.where(is_end, idx, 2 * n).flip(axis).cummin(dim=axis)
          .values.flip(axis) + 1 - idx)
    wmin = torch.minimum(li, ri)  # <= 2n + 2, exact
    return torch.where(wmin > n, sent, wmin)


@functools.cache
def _lib():
    lib = _build.load("bounds")
    lib.edt_segment_bounds.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.edt_wall_counts.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.edt_segment_bounds.restype = ctypes.c_int
    lib.edt_wall_counts.restype = ctypes.c_int
    return lib


def _on_card(name, labels, n):
    """The labels, C-contiguous, and their kind, for a launch on their
    card; raises on what the kernel does not take."""
    if labels.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {labels.device}")
    if labels.dtype not in _KINDS:
        raise ValueError(f"{name}: labels of dtype {labels.dtype} are not "
                         f"supported")
    if n > MAX_AXIS:
        raise ValueError(f"{name}: an axis of {n} voxels exceeds {MAX_AXIS}")
    return labels.contiguous(), _KINDS[labels.dtype]


def _launched(name, err, device):
    global launches
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches += 1
    card_launches[device.index] = card_launches.get(device.index, 0) + 1


def segment_bounds(labels):
    """(start, end) int32 of each voxel's same-label run along axis -1:
    start the first voxel of the run, end one past its last. CUDA tensors
    run the kernel, CPU tensors the plain version."""
    if labels.device.type == "cpu":
        return segment_bounds_plain(labels)
    if labels.dim() == 0:
        raise ValueError("segment_bounds: labels need an axis")
    n = labels.shape[-1]
    lab, kind = _on_card("segment_bounds", labels, n)
    start = torch.empty(lab.shape, dtype=torch.int32, device=lab.device)
    end = torch.empty_like(start)
    if lab.numel() == 0:
        return start, end
    with torch.cuda.device(lab.device):  # the runtime launches on the current card
        err = _lib().edt_segment_bounds(
            lab.data_ptr(), start.data_ptr(), end.data_ptr(),
            lab.numel() // n, n, kind,
            torch.cuda.current_stream().cuda_stream)
    _launched("segment_bounds", err, lab.device)
    return start, end


def wall_counts(labels, axis, black_border):
    """The wall counts of ``wall_counts_plain`` along ``axis``, in labels'
    own layout: the kernel on CUDA tensors (a warp a row where the axis
    has stride 1, else a thread a column), the plain version on CPU
    tensors."""
    if labels.device.type == "cpu":
        return wall_counts_plain(labels, axis, black_border)
    axis = axis + labels.dim() if axis < 0 else axis
    if not 0 <= axis < labels.dim():
        raise ValueError(f"wall_counts: axis {axis} of a {labels.dim()}-D "
                         f"tensor")
    n = labels.shape[axis]
    if n == 0:  # the plain version's narrow(axis, 1, -1) raises too
        raise ValueError("wall_counts: the axis has no voxel")
    lab, kind = _on_card("wall_counts", labels, n)
    idt, sent = count_dtype(n)
    out = torch.empty(lab.shape, dtype=idt, device=lab.device)
    if lab.numel() == 0:
        return out
    outer = math.prod(lab.shape[:axis])
    inner = math.prod(lab.shape[axis + 1:])
    with torch.cuda.device(lab.device):
        err = _lib().edt_wall_counts(
            lab.data_ptr(), out.data_ptr(), outer, n, inner, kind,
            out.element_size(), sent, int(bool(black_border)),
            torch.cuda.current_stream().cuda_stream)
    _launched("wall_counts", err, lab.device)
    return out


@torch.library.custom_op("edt_tpu_torch::segment_bounds", mutates_args=(),
                         schema="(Tensor labels) -> (Tensor, Tensor)")
def segment_bounds_op(labels):
    """``segment_bounds`` as a custom op: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    return segment_bounds(labels)


@segment_bounds_op.register_fake
def _segment_bounds_op_fake(labels):
    return (labels.new_empty(labels.shape, dtype=torch.int32),
            labels.new_empty(labels.shape, dtype=torch.int32))


@torch.library.custom_op(
    "edt_tpu_torch::wall_counts", mutates_args=(),
    schema="(Tensor labels, int axis, bool black_border) -> Tensor")
def wall_counts_op(labels, axis, black_border):
    """``wall_counts`` as a custom op: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    return wall_counts(labels, axis, black_border)


@wall_counts_op.register_fake
def _wall_counts_op_fake(labels, axis, black_border):
    return labels.new_empty(labels.shape,
                            dtype=count_dtype(labels.shape[axis])[0])
