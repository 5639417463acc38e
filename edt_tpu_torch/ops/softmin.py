"""K5 and K6: the softmin-plus pass at temperature t > 0 and its gradient.

- K5, ``softmin``: d[r, i] = -t log sum_j exp(-(f[r, j] + w2 (i - j)^2) / t),
  counterpart of ``edt_tpu.ops.pallas_kernels.softmin_pallas``;
  ``softmin_plain`` is its plain version, the exact logsumexp.
- K6, ``softmin_grad``: (df, e) with the softmax weights p_ij of d,
  df_j = sum_i g_i p_ij and e_i = sum_j p_ij (i - j)^2, counterpart of
  ``pallas_kernels.softmin_grad_pallas``; ``softmin_grad_plain`` is its
  plain version. The weights are exp((d_i - f_j - w2 (i-j)^2) / t)
  divided by their sum over j: 1 in exact arithmetic, where the JAX
  package leaves it, but in f32 d's round-off makes every weight of a
  target off by ulp(d_i) / t (0.16 % at d = 4096, t = 0.3), and the sum
  cancels that.

Both kernels are in ``csrc/softmin.cu`` (CUDA C++ for sm_90a, built by
``_build``, bound with ctypes). They drop the terms whose weight is below
exp(-SOFT_CUT), as the TPU kernels do, so they match the plain versions to
f32 round-off. Each wrapper launches its kernel for CUDA tensors and takes
the plain version only for CPU tensors, and counts its launches
(``launches`` for K5, ``grad_launches`` for K6; ``long_launches`` and
``grad_long_launches`` those in their long-row modes). Each is also a
``torch.library`` custom op: ``edt_tpu_torch::softmin`` and
``edt_tpu_torch::softmin_grad``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from edt_tpu_torch.ops import _build, core
from edt_tpu_torch.ops.minplus import (MAX_SMEM_BYTES, _check, plain_chunks,
                                       quad_rows)

SOFT_CUT = 30.0

# Longest rows of the kernels' shared-memory modes: K5 stages the f32 row
# in shared memory (4 B a voxel on rows a block holds; rows up to 2048 a
# warp holds, with pads and a table, 16 B a voxel), K6 the row of f beside
# its f32 df accumulator (8 B a voxel), within an H100 block's opt-in
# 232448 bytes less the kernels' few static bytes. Longer rows take each
# kernel's long-row mode (the row read from device memory).
MAX_AXIS = (MAX_SMEM_BYTES - 256) // 4
GRAD_MAX_AXIS = (MAX_SMEM_BYTES - 256) // 8

launches = 0
grad_launches = 0
long_launches = 0
grad_long_launches = 0


def softmin_plain(f, w2, t):
    """Plain version of K5: the exact logsumexp over the (rows, n, n) cost
    tensor, over ``plain_chunks`` of rows and targets (the JAX package's
    ``_soft_fwd_impl``)."""
    R, n = f.shape
    w2, t = core.f32(w2), core.f32(t)
    d = torch.empty_like(f)
    for r0, r1, i0, i1 in plain_chunks(R, n):
        cost = f[r0:r1, None, :] + quad_rows(i0, i1, n, w2, f.device)
        d[r0:r1, i0:i1] = -t * torch.logsumexp(-cost / t, dim=-1)
    return d


def softmin_grad_plain(f, d, g, w2, t):
    """Plain version of K6: the softmax weights recomputed from d over the
    (rows, n, n) cost tensor and divided by their sum, over ``plain_chunks``
    of rows and targets, df summed over the target blocks (the JAX
    package's ``_soft_bwd_impl``, normalised, with the per-target e in place
    of its reduced dw2 = sum(g * e))."""
    R, n = f.shape
    w2, t = core.f32(w2), core.f32(t)
    df = torch.empty_like(f)
    e = torch.empty_like(f)
    for r0, r1, i0, i1 in plain_chunks(R, n):
        q = quad_rows(i0, i1, n, 1.0, f.device)
        p = torch.exp(-(f[r0:r1, None, :] + w2 * q - d[r0:r1, i0:i1, None]) / t)
        p = p / p.sum(dim=-1, keepdim=True)
        part = torch.einsum("ri,rij->rj", g[r0:r1, i0:i1], p)
        if i0 == 0:
            df[r0:r1] = part
        else:
            df[r0:r1] += part
        e[r0:r1, i0:i1] = (p * q).sum(dim=-1)
    return df, e


@functools.cache
def _kernels():
    lib = _build.load("softmin")
    fwd, bwd = lib.edt_softmin, lib.edt_softmin_grad
    fwd.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_cuda(name, f, t):
    if f.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {f.device}")
    if f.dim() != 2:
        raise ValueError(f"f must be (rows, n), got shape {tuple(f.shape)}")
    R, n = f.shape
    _check("f", f, torch.float32, (R, n), f.device)
    if R >= 2 ** 31:
        raise ValueError(f"{R} rows exceed one launch grid")
    if not t > 0.0:
        raise ValueError(f"{name} needs a temperature > 0, got {t}")
    return R, n


def softmin(f, w2, t, *, _long_rows=False):
    """d[r, i] = -t log sum_j exp(-(f[r, j] + w2 (i - j)^2) / t), INF on
    all-INF rows.

    f: (R, n) f32, C-contiguous. CUDA tensors run the K5 kernel (its
    long-row mode past ``MAX_AXIS``, or with ``_long_rows``, which holds the
    two modes against each other); CPU tensors the plain version.
    """
    global launches, long_launches
    if f.device.type == "cpu":
        return softmin_plain(f, w2, t)
    R, n = _check_cuda("softmin", f, t)
    d = torch.empty_like(f)
    if R == 0 or n == 0:
        return d
    long_rows = _long_rows or n > MAX_AXIS
    with torch.cuda.device(f.device):  # the runtime launches on the current card
        err = _kernels()[0](f.data_ptr(), d.data_ptr(), R, n, core.f32(w2),
                            core.f32(t), int(long_rows),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"softmin kernel launch failed: cudaError {err}")
    launches += 1
    long_launches += long_rows
    return d


def softmin_grad(f, d, g, w2, t, *, _long_rows=False):
    """(df, e) of the softmin pass: df_j = sum_i g_i p_ij, e_i = sum_j p_ij
    (i - j)^2 with p_ij the softmax weights exp((d_i - f_j - w2 (i - j)^2)
    / t) over j, normalised to sum 1.

    f, d (``softmin``'s output), g: (R, n) f32, C-contiguous, on one
    device; f finite somewhere in every row (an all-INF row gives 0 here,
    NaN in the plain version). CUDA tensors run the K6 kernel (its long-row
    mode past ``GRAD_MAX_AXIS``, or with ``_long_rows``, which holds the two
    modes against each other); CPU tensors the plain version.
    """
    global grad_launches, grad_long_launches
    if f.device.type == "cpu":
        return softmin_grad_plain(f, d, g, w2, t)
    R, n = _check_cuda("softmin_grad", f, t)
    _check("d", d, torch.float32, (R, n), f.device)
    _check("g", g, torch.float32, (R, n), f.device)
    df = torch.empty_like(f)
    e = torch.empty_like(f)
    if R == 0 or n == 0:
        return df, e
    long_rows = _long_rows or n > GRAD_MAX_AXIS
    with torch.cuda.device(f.device):  # the runtime launches on the current card
        err = _kernels()[1](f.data_ptr(), d.data_ptr(), g.data_ptr(),
                            df.data_ptr(), e.data_ptr(), R, n, core.f32(w2),
                            core.f32(t), int(long_rows),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"softmin_grad kernel launch failed: cudaError {err}")
    grad_launches += 1
    grad_long_launches += long_rows
    return df, e


@torch.library.custom_op(
    "edt_tpu_torch::softmin", mutates_args=(),
    schema="(Tensor f, float w2, float t) -> Tensor")
def softmin_op(f, w2, t):
    """K5 as a custom op: ``softmin``, which launches the kernel on CUDA
    tensors and runs the plain version on CPU tensors."""
    return softmin(f, w2, t)


@softmin_op.register_fake
def _softmin_op_fake(f, w2, t):
    return torch.empty_like(f)


@torch.library.custom_op(
    "edt_tpu_torch::softmin_grad", mutates_args=(),
    schema="(Tensor f, Tensor d, Tensor g, float w2, float t) "
           "-> (Tensor, Tensor)")
def softmin_grad_op(f, d, g, w2, t):
    """K6 as a custom op: ``softmin_grad``, which launches the kernel on
    CUDA tensors and runs the plain version on CPU tensors."""
    return softmin_grad(f, d, g, w2, t)


@softmin_grad_op.register_fake
def _softmin_grad_op_fake(f, d, g, w2, t):
    return torch.empty_like(f), torch.empty_like(f)
