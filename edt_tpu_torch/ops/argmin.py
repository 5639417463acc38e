"""K2: min-plus with its leftmost argmin, walls optional.

Counterpart of ``edt_tpu.ops.pallas_kernels.minplus_argmin_pallas``: the
forward of the differentiable EDT at temperature 0. The kernel is
``csrc/argmin.cu`` (CUDA C++ for sm_90a, built by ``_build``, bound with
ctypes); ``minplus_argmin_plain`` is its plain PyTorch version.

``minplus_argmin`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors. ``launches`` counts the kernel launches,
``long_launches`` those in its long-row mode (rows past ``MAX_AXIS``). The
same wrapper is the ``torch.library`` custom op
``edt_tpu_torch::minplus_argmin``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from edt_tpu_torch.ops import _build, core
from edt_tpu_torch.ops.minplus import (MAX_SMEM_BYTES, _check, plain_chunks,
                                       quad_rows)
from edt_tpu_torch.ops.wall_sentinels import WALL_SENT16, WALL_SENT32

# Longest row of the kernel's shared-memory mode: it stages the f32 row in
# shared memory, 4 B a voxel (the walls stay in device memory), within an
# H100 block's opt-in 232448 bytes less the kernel's few static bytes.
# Longer rows take its long-row mode (the row read from device memory).
MAX_AXIS = (MAX_SMEM_BYTES - 256) // 4

# Rows up to this length keep int16 link offsets and int16 wall counts.
I16_MAX_AXIS = 16000

# csrc/argmin.cu's wall_kind codes; its arg_kind codes are 0 (absolute
# int32), 1 (int16 offsets) and 2 (int32 offsets)
_WALL_KINDS = {None: 0, torch.float32: 1, torch.int16: 2, torch.int32: 3}

launches = 0
long_launches = 0


def link_dtype(n: int) -> torch.dtype:
    """Dtype of the link offsets of rows of ``n``: int16 when |argj - i|
    < n fits, which halves the residual kept for the backward."""
    return torch.int16 if n <= I16_MAX_AXIS else torch.int32


def walls_from_counts(cnt: torch.Tensor, w2: float) -> torch.Tensor:
    """f32 squared wall field (INF = open) from integer wall counts, as
    ``(w2 * c) * c``: the order of the JAX package's ``w2 * c * c``."""
    sent = WALL_SENT16 if cnt.dtype == torch.int16 else WALL_SENT32
    c = cnt.to(torch.float32)
    return torch.where(cnt >= sent, core.INF, (c * core.f32(w2)) * c)


def _check_walls(f, walls):
    if walls is None:
        return
    if walls.dtype not in _WALL_KINDS:
        raise ValueError(f"walls must be float32, int16 or int32, got "
                         f"{walls.dtype}")
    if walls.shape != f.shape or walls.device != f.device:
        raise ValueError(f"walls: expected {tuple(f.shape)} on {f.device}, "
                         f"got {tuple(walls.shape)} on {walls.device}")
    if walls.dtype == torch.int16 and f.shape[-1] > I16_MAX_AXIS:
        # int16 counts can reach n + 1 > WALL_SENT16 and would read as open
        raise ValueError(f"int16 wall counts require n <= {I16_MAX_AXIS} "
                         f"(got n={f.shape[-1]}); use int32 counts")


def minplus_argmin_plain(f, w2, walls=None, emit_offsets=False):
    """Plain PyTorch version of the kernel: the brute-force cost tensor
    with ``argmin`` (the first index on ties), over ``plain_chunks`` of
    rows and targets, then the wall clamp and the arg encoding."""
    _check_walls(f, walls)
    R, n = f.shape
    w2 = core.f32(w2)
    d = torch.empty_like(f)
    argj = torch.empty((R, n), dtype=torch.int64, device=f.device)
    for r0, r1, i0, i1 in plain_chunks(R, n):
        cost = f[r0:r1, None, :] + quad_rows(i0, i1, n, w2, f.device)
        arg = cost.argmin(dim=-1)
        d[r0:r1, i0:i1] = cost.gather(-1, arg.unsqueeze(-1)).squeeze(-1)
        argj[r0:r1, i0:i1] = arg
    idx = torch.arange(n, dtype=torch.int64, device=f.device)
    win = None
    if walls is not None:
        wf = walls if walls.dtype == torch.float32 else walls_from_counts(walls, w2)
        win = d <= wf  # ties stay with the candidate
        d = torch.where(win, d, wf)
    if emit_offsets:
        idt = link_dtype(n)
        o = (argj - idx).to(idt)
        if win is not None:
            o = torch.where(win, o, torch.iinfo(idt).min)
        return d, o
    if win is not None:
        argj = torch.where(win, argj, ~idx)
    return d, argj.to(torch.int32)


@functools.cache
def _kernel():
    lib = _build.load("argmin")
    fn = lib.edt_minplus_argmin
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def minplus_argmin(f, w2, walls=None, emit_offsets=False, *,
                   _long_rows=False):
    """(d, arg): d[r, i] = min_j f[r, j] + w2 (i - j)^2 with its leftmost
    argmin, the walls min'd in (ties to the candidate).

    f: (R, n) f32. walls: None, (R, n) f32 squared walls (INF = open), or
    int16/int32 wall counts (>= WALL_SENT16/32 = open). arg: absolute
    int32 index, ~i on a wall win; with ``emit_offsets`` the offset
    argj - i in ``link_dtype(n)``, the dtype's min on a wall win. All
    C-contiguous on one device. CUDA tensors run the K2 kernel (its
    long-row mode past ``MAX_AXIS``, or with ``_long_rows``, which holds the
    two modes against each other); CPU tensors the plain version.
    """
    global launches, long_launches
    if f.device.type == "cpu":
        return minplus_argmin_plain(f, w2, walls, emit_offsets)
    if f.device.type != "cuda":
        raise ValueError(f"minplus_argmin: unsupported device {f.device}")
    if f.dim() != 2:
        raise ValueError(f"f must be (rows, n), got shape {tuple(f.shape)}")
    R, n = f.shape
    _check("f", f, torch.float32, (R, n), f.device)
    _check_walls(f, walls)
    if walls is not None:
        _check("walls", walls, walls.dtype, (R, n), f.device)
    if R >= 2 ** 31:
        raise ValueError(f"{R} rows exceed one launch grid")
    adt = link_dtype(n) if emit_offsets else torch.int32
    d = torch.empty_like(f)
    arg = torch.empty((R, n), dtype=adt, device=f.device)
    if R == 0 or n == 0:
        return d, arg
    long_rows = _long_rows or n > MAX_AXIS
    with torch.cuda.device(f.device):  # the runtime launches on the current card
        err = _kernel()(
            f.data_ptr(), None if walls is None else walls.data_ptr(),
            d.data_ptr(), arg.data_ptr(), R, n, core.f32(w2),
            _WALL_KINDS[None if walls is None else walls.dtype],
            (1 if adt == torch.int16 else 2) if emit_offsets else 0,
            int(long_rows), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"minplus_argmin kernel launch failed: cudaError {err}")
    launches += 1
    long_launches += long_rows
    return d, arg


@torch.library.custom_op(
    "edt_tpu_torch::minplus_argmin", mutates_args=(),
    schema="(Tensor f, float w2, Tensor? walls=None, bool emit_offsets=False)"
           " -> (Tensor, Tensor)")
def minplus_argmin_op(f, w2, walls=None, emit_offsets=False):
    """K2 as a custom op: ``minplus_argmin``, which launches the kernel on
    CUDA tensors and runs the plain version on CPU tensors."""
    return minplus_argmin(f, w2, walls, emit_offsets)


@minplus_argmin_op.register_fake
def _minplus_argmin_op_fake(f, w2, walls=None, emit_offsets=False):
    adt = link_dtype(f.shape[-1]) if emit_offsets else torch.int32
    return torch.empty_like(f), torch.empty_like(f, dtype=adt)
