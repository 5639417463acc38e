"""K1: the min-plus parabolic pass with fused wall parabolas.

Counterpart of ``edt_tpu.ops.pallas_kernels.minplus_pallas`` with
``walls=True`` and of its ``make_parabolic_fn``. The kernel is
``csrc/minplus.cu`` (CUDA C++ for sm_90a, built by ``_build``, bound with
ctypes); ``minplus_walls_plain`` is its plain PyTorch version.

``minplus_walls`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors. ``launches`` counts the kernel launches,
``long_launches`` those in its long-row mode and ``card_launches`` those
on each card (by device index). Every launch runs on its tensor's card,
whichever card is current. Rows up to ``MAX_AXIS`` run
the kernel's shared-memory mode, longer ones its long-row mode (the row
read from device memory), so every length runs on the card. Each
target's search stops under a floor: its segment's min f on masked rows
up to ``SEGMENT_FLOOR_AXIS``, the row's min f elsewhere
(``segment_floor``).

The same pair is registered as the ``torch.library`` custom op
``edt_tpu_torch::minplus_walls`` (``minplus_walls`` on every device, with a
fake implementation for tracing), so that ``torch.export``
records K1 as one node. ``make_parabolic_fn()``, and so ``compose.edtsq``,
calls K1 through the op.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from edt_tpu_torch.ops import _build, core

# Longest row of the kernel's shared-memory mode: it stages one f32 row in
# shared memory, and an H100 block may opt in to 232448 bytes, less the
# kernel's few static bytes. Longer rows take its long-row mode.
MAX_SMEM_BYTES = 232448
MAX_AXIS = (MAX_SMEM_BYTES - 256) // 4


# Masked rows up to this length keep their segments' running minima of f
# beside f in shared memory (8 B a voxel): each target's segment min f is
# the floor of its search.
SEGMENT_FLOOR_AXIS = (MAX_SMEM_BYTES - 256) // 8


def segment_floor(n, masked):
    """Whether K1 searches a row of n voxels under each target's segment
    min f, else under the row's min f: masked rows up to
    ``SEGMENT_FLOOR_AXIS``. Longer masked rows (and rows forced into the
    long-row mode) keep the row's floor; binary rows are one segment,
    whose min f is the row's."""
    return masked and n <= SEGMENT_FLOOR_AXIS


# The plain versions' (rows, targets, n) cost tensors stay below this.
PLAIN_COST_BYTES = 1 << 30

launches = 0
long_launches = 0
card_launches: dict[int, int] = {}


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def plain_chunks(R, n):
    """(r0, r1, i0, i1) blocks of rows and targets whose (rows, targets, n)
    f32 cost tensor stays under ``PLAIN_COST_BYTES``: whole rows while one
    row's (n, n) fits, else one row at a time in blocks of targets (a
    65536-voxel row's whole cost tensor would be 17 GB)."""
    row_bytes = 4 * n * n
    if row_bytes <= PLAIN_COST_BYTES:
        rows, tgt = max(1, PLAIN_COST_BYTES // max(row_bytes, 1)), max(n, 1)
    else:
        rows, tgt = 1, max(1, PLAIN_COST_BYTES // (4 * n))
    for r0 in range(0, R, rows):
        for i0 in range(0, n, tgt):
            yield r0, min(R, r0 + rows), i0, min(n, i0 + tgt)


def quad_rows(i0, i1, n, w2, device):
    """(i1 - i0, n) f32 w2 (i - j)^2, rounded as ``core._minplus_chunk``
    forms it: (diff * diff) * w2."""
    i = torch.arange(i0, i1, dtype=torch.float32, device=device)
    j = torch.arange(n, dtype=torch.float32, device=device)
    diff = i[:, None] - j[None, :]
    return (diff * diff) * core.f32(w2)


@functools.cache
def _kernel():
    lib = _build.load("minplus")
    fn = lib.edt_minplus_walls
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def minplus_walls_plain(f, ss, se, w2, black_border, masked):
    """Plain PyTorch version of the kernel: brute-force unmasked min-plus
    (``core._minplus_chunk``'s arithmetic over ``plain_chunks``) plus the
    wall parabolas (``core.border_envelopes_sq`` masked, the whole-row
    border parabolas for binary). Background needs no zeroing: it carries
    f == 0, and candidate j == i pins it to 0."""
    R, n = f.shape
    d = torch.empty_like(f)
    for r0, r1, i0, i1 in plain_chunks(R, n):
        q = quad_rows(i0, i1, n, w2, f.device)
        d[r0:r1, i0:i1] = (f[r0:r1, None, :] + q).amin(dim=-1)
    if masked:
        return core.border_envelopes_sq(d, ss, se, n, w2, black_border)
    return core.binary_border_sq(d, n, w2) if black_border else d


def minplus_walls(f, ss, se, w2, black_border, masked, *, _long_rows=False):
    """d[r, i] = min_j f[r, j] + w2 (i - j)^2, then the walls.

    f: (R, n) f32; ss, se: (R, n) int32 segment bounds when ``masked``
    (multi-label), ignored otherwise (binary). All C-contiguous on one
    device. CUDA tensors run the K1 kernel (its long-row mode past
    ``MAX_AXIS``, or with ``_long_rows``, which holds the two modes against
    each other); CPU tensors the plain version.
    """
    global launches, long_launches
    if f.device.type == "cpu":
        return minplus_walls_plain(f, ss, se, w2, black_border, masked)
    if f.device.type != "cuda":
        raise ValueError(f"minplus_walls: unsupported device {f.device}")
    if f.dim() != 2:
        raise ValueError(f"f must be (rows, n), got shape {tuple(f.shape)}")
    R, n = f.shape
    _check("f", f, torch.float32, (R, n), f.device)
    if masked:
        _check("ss", ss, torch.int32, (R, n), f.device)
        _check("se", se, torch.int32, (R, n), f.device)
    if R >= 2 ** 31:
        raise ValueError(f"{R} rows exceed one launch grid")
    out = torch.empty_like(f)
    if R == 0 or n == 0:
        return out
    long_rows = _long_rows or n > MAX_AXIS
    with torch.cuda.device(f.device):  # the runtime launches on the current card
        err = _kernel()(f.data_ptr(), ss.data_ptr() if masked else None,
                        se.data_ptr() if masked else None, out.data_ptr(), R,
                        n, core.f32(w2), int(masked), int(black_border),
                        int(long_rows), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"minplus_walls kernel launch failed: cudaError {err}")
    launches += 1
    long_launches += long_rows
    card_launches[f.device.index] = card_launches.get(f.device.index, 0) + 1
    return out


@torch.library.custom_op(
    "edt_tpu_torch::minplus_walls", mutates_args=(),
    schema="(Tensor f, Tensor? ss, Tensor? se, float w2, bool black_border, "
           "bool masked) -> Tensor")
def minplus_walls_op(f, ss, se, w2, black_border, masked):
    """K1 as a custom op: ``minplus_walls``, which launches the kernel on
    CUDA tensors and runs the plain version on CPU tensors."""
    return minplus_walls(f, ss, se, w2, black_border, masked)


@minplus_walls_op.register_fake
def _minplus_walls_op_fake(f, ss, se, w2, black_border, masked):
    return torch.empty_like(f)


def make_parabolic_fn(minplus_fn=None):
    """Whole parabolic pass, (f2d, labels2d, w2, black_border, binary) ->
    d2d: segment bounds, then ``minplus_fn`` with the walls fused. The
    default, ``compose.edtsq``'s, is K1 through its custom op;
    ``make_parabolic_fn(minplus_walls_plain)`` is the same pass through the
    plain version on any device."""
    if minplus_fn is None:
        minplus_fn = torch.ops.edt_tpu_torch.minplus_walls

    def fn(f2d, labels2d, w2, black_border, binary):
        if binary:
            return minplus_fn(f2d, None, None, w2, black_border, masked=False)
        ss, se = core.segment_bounds(labels2d)
        return minplus_fn(f2d, ss, se, w2, black_border, masked=True)

    return fn
