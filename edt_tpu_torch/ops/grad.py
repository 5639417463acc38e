"""K3 and K4: the backward kernels of the differentiable EDT at t = 0.

- K3, ``minplus_grad``: the transpose of K2's argmin routing, counterpart
  of ``edt_tpu.ops.pallas_kernels.minplus_grad_pallas``;
  ``minplus_grad_plain`` is its plain version.
- K4, ``binary_grad_scan``: the backward of the closed-form binary pass,
  counterpart of ``pallas_kernels.binary_grad_scan_pallas``;
  ``binary_grad_scan_plain`` (through ``binary_grad_from_links``) is its
  plain version.

Both kernels are in ``csrc/grad.cu`` (CUDA C++ for sm_90a, built by
``_build``, bound with ctypes). Each wrapper launches its kernel for CUDA
tensors and takes the plain version only for CPU tensors, and counts its
launches (``minplus_grad_launches``, ``binary_grad_scan_launches``; K3's in
its long-row mode also ``minplus_grad_long_launches``). Each is also a
``torch.library`` custom op: ``edt_tpu_torch::minplus_grad`` and
``edt_tpu_torch::binary_grad_scan``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from edt_tpu_torch.ops import _build
from edt_tpu_torch.ops.minplus import MAX_SMEM_BYTES, _check

# Longest row of K3's shared-memory mode: each warp keeps its row's f32
# accumulator in shared memory, 4 B a voxel, and at the longest rows a
# block holds one warp, within an H100 block's opt-in 232448 bytes. Longer
# rows take its long-row mode (the accumulator in the output row). K4 keeps
# nothing in shared memory and takes any length in its one mode.
MAX_AXIS = (MAX_SMEM_BYTES - 256) // 4

# csrc/grad.cu's link_kind codes
_ABS_I32, _OFF_I16, _OFF_I32 = 0, 1, 2

minplus_grad_launches = 0
minplus_grad_long_launches = 0
binary_grad_scan_launches = 0


def _one_link_input(argj, offsets):
    if (argj is None) == (offsets is None):
        raise ValueError("pass exactly one of argj and offsets")


def minplus_grad_plain(g, argj=None, offsets=None, off_sent=None):
    """Plain version of K3: ``scatter_add_`` of the live cotangents onto
    their links ``i + o``. Inert voxels (``off_sent`` offsets, negative
    argj) and links that leave the row credit nothing."""
    _one_link_input(argj, offsets)
    n = g.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=g.device)
    if offsets is not None:
        links = idx + offsets.to(torch.int64)
        live = (offsets != off_sent) if off_sent is not None else True
    else:
        links = argj.to(torch.int64)
        live = links >= 0
    live = live & (links >= 0) & (links < n)
    gm = torch.where(live, g, 0.0)
    return torch.zeros_like(g).scatter_add_(1, torch.where(live, links, idx), gm)


def _seg_scan(h, flags):
    """Inclusive segmented sum along dim 1 that restarts AT flagged
    positions: log2(n) shift-and-add steps (Hillis-Steele)."""
    v, fl = h, flags
    n = h.shape[1]
    s = 1
    while s < n:
        vs = torch.nn.functional.pad(v[:, :-s], (s, 0))
        fs = torch.nn.functional.pad(fl[:, :-s], (s, 0))
        v = torch.where(fl, v, vs + v)
        fl = fl | fs
        s *= 2
    return v


def binary_grad_from_links(gm, o0, z):
    """df of the closed-form binary pass from its links (counterpart of
    ``edt_tpu.models.soft._binary_grad_from_links``).

    gm: (R, n) cotangents with inert voxels zeroed; o0: link offsets with 0
    at self wins, zero sites and inert voxels; z: the zero sites. Every
    winner links to the nearest zero on its side, so two segmented sums
    that restart at zero sites gather each zero site's cotangents:

        df[j] = gm[j] [o0[j] == 0] + z[j] (prefix(gm [o0 > 0])[j - 1]
                                           + suffix(gm [o0 < 0])[j + 1])
    """
    fs = _seg_scan(torch.where(o0 > 0, gm, 0.0), z)
    rs = _seg_scan(torch.where(o0 < 0, gm, 0.0).flip(1), z.flip(1)).flip(1)
    fs_prev = torch.nn.functional.pad(fs[:, :-1], (1, 0))
    rs_next = torch.nn.functional.pad(rs[:, 1:], (0, 1))
    return (torch.where(o0 == 0, gm, 0.0)
            + torch.where(z, fs_prev + rs_next, 0.0))


def binary_grad_scan_plain(g, offsets, off_sent=None):
    """Plain version of K4: decode the offsets (zero sites at the dtype
    max, ``off_sent`` inert) and take ``binary_grad_from_links``."""
    if off_sent is not None:
        live = offsets != off_sent
        g = torch.where(live, g, 0.0)
        offsets = torch.where(live, offsets, 0)
    z = offsets == torch.iinfo(offsets.dtype).max
    return binary_grad_from_links(g, torch.where(z, 0, offsets), z)


@functools.cache
def _kernels():
    lib = _build.load("grad")
    fns = (lib.edt_minplus_grad, lib.edt_binary_grad_scan)
    for fn, mode in zip(fns, ([ctypes.c_int], [])):  # K3's long_rows flag
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, *mode, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _check_cuda(name, g, links, link_dtypes):
    if g.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {g.device}")
    if g.dim() != 2:
        raise ValueError(f"g must be (rows, n), got shape {tuple(g.shape)}")
    R, n = g.shape
    _check("g", g, torch.float32, (R, n), g.device)
    if links.dtype not in link_dtypes:
        raise ValueError(f"{name}: links must be one of {link_dtypes}, got "
                         f"{links.dtype}")
    _check("links", links, links.dtype, (R, n), g.device)
    if R >= 2 ** 31:
        raise ValueError(f"{R} rows exceed one launch grid")
    return R, n


def _launch(fn, name, g, links, kind, off_sent, *mode):
    out = torch.empty_like(g)
    R, n = g.shape
    with torch.cuda.device(g.device):  # the runtime launches on the current card
        err = fn(g.data_ptr(), links.data_ptr(), out.data_ptr(), R, n, kind,
                 0 if off_sent is None else int(off_sent),
                 int(off_sent is not None), *mode,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def minplus_grad(g, argj=None, offsets=None, off_sent=None, *,
                 _long_rows=False):
    """df[r, j] = sum_i g[r, i] [link[r, i] == j]: the VJP of K2's argmin.

    g: (R, n) f32. Exactly one of ``argj`` (absolute int32 indices,
    negative = inert) and ``offsets`` (int16/int32 ``argj - i``;
    ``off_sent`` marks inert voxels). All C-contiguous on one device. CUDA
    tensors run the K3 kernel (its long-row mode past ``MAX_AXIS``, or with
    ``_long_rows``, which holds the two modes against each other); CPU
    tensors the plain version.
    """
    global minplus_grad_launches, minplus_grad_long_launches
    _one_link_input(argj, offsets)
    if g.device.type == "cpu":
        return minplus_grad_plain(g, argj, offsets, off_sent)
    links = argj if offsets is None else offsets
    dtypes = (torch.int32,) if offsets is None else (torch.int16, torch.int32)
    R, n = _check_cuda("minplus_grad", g, links, dtypes)
    if R == 0 or n == 0:
        return torch.zeros_like(g)
    if offsets is None:
        kind, off_sent = _ABS_I32, None
    else:
        kind = _OFF_I16 if offsets.dtype == torch.int16 else _OFF_I32
    long_rows = _long_rows or n > MAX_AXIS
    out = _launch(_kernels()[0], "minplus_grad", g, links, kind, off_sent,
                  int(long_rows))
    minplus_grad_launches += 1
    minplus_grad_long_launches += long_rows
    return out


def binary_grad_scan(g, offsets, off_sent=None):
    """df of the closed-form binary pass from its link offsets: zero sites
    at the dtype max, wall wins at ``off_sent`` (inert).

    g: (R, n) f32; offsets: (R, n) int16/int32. All C-contiguous on one
    device. CUDA tensors run the K4 kernel; CPU tensors the plain version.
    """
    global binary_grad_scan_launches
    if g.device.type == "cpu":
        return binary_grad_scan_plain(g, offsets, off_sent)
    R, n = _check_cuda("binary_grad_scan", g, offsets,
                       (torch.int16, torch.int32))
    if R == 0 or n == 0:
        return torch.zeros_like(g)
    kind =_OFF_I16 if offsets.dtype == torch.int16 else _OFF_I32
    out = _launch(_kernels()[1], "binary_grad_scan", g, offsets, kind, off_sent)
    binary_grad_scan_launches += 1
    return out


@torch.library.custom_op(
    "edt_tpu_torch::minplus_grad", mutates_args=(),
    schema="(Tensor g, Tensor? argj=None, Tensor? offsets=None, "
           "int? off_sent=None) -> Tensor")
def minplus_grad_op(g, argj=None, offsets=None, off_sent=None):
    """K3 as a custom op: ``minplus_grad``, which launches the kernel on
    CUDA tensors and runs the plain version on CPU tensors."""
    return minplus_grad(g, argj, offsets, off_sent)


@minplus_grad_op.register_fake
def _minplus_grad_op_fake(g, argj=None, offsets=None, off_sent=None):
    return torch.empty_like(g)


@torch.library.custom_op(
    "edt_tpu_torch::binary_grad_scan", mutates_args=(),
    schema="(Tensor g, Tensor offsets, int? off_sent=None) -> Tensor")
def binary_grad_scan_op(g, offsets, off_sent=None):
    """K4 as a custom op: ``binary_grad_scan``, which launches the kernel on
    CUDA tensors and runs the plain version on CPU tensors."""
    return binary_grad_scan(g, offsets, off_sent)


@binary_grad_scan_op.register_fake
def _binary_grad_scan_op_fake(g, offsets, off_sent=None):
    return torch.empty_like(g)
