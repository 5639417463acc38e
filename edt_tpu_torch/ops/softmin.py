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
(``launches`` for K5, ``grad_launches`` for K6).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from edt_tpu_torch.ops import _build, core
from edt_tpu_torch.ops.minplus import MAX_SMEM_BYTES, PLAIN_COST_BYTES, _check

SOFT_CUT = 30.0

# Longest rows the kernels take: K5 stages the f32 row in shared memory
# (4 B a voxel), K6 the rows of f, d and g (12 B a voxel), within an H100
# block's opt-in 232448 bytes less the kernels' few static bytes. Longer
# axes raise.
MAX_AXIS = (MAX_SMEM_BYTES - 256) // 4
GRAD_MAX_AXIS = (MAX_SMEM_BYTES - 256) // 12

launches = 0
grad_launches = 0


def _row_chunks(R, n):
    """Row blocks whose (rows, n, n) f32 cost tensor fits PLAIN_COST_BYTES."""
    rows = max(1, PLAIN_COST_BYTES // (4 * n * n or 1))
    return ((r0, min(R, r0 + rows)) for r0 in range(0, R, rows))


def _quad(n, device):
    i = torch.arange(n, dtype=torch.float32, device=device)
    diff = i[:, None] - i[None, :]
    return diff * diff


def softmin_plain(f, w2, t):
    """Plain version of K5: the exact logsumexp over the (rows, n, n) cost
    tensor, chunked over rows under ``PLAIN_COST_BYTES`` (the JAX
    package's ``_soft_fwd_impl``)."""
    R, n = f.shape
    w2, t = core.f32(w2), core.f32(t)
    d = torch.empty_like(f)
    if R and n:
        wq = w2 * _quad(n, f.device)
        for r0, r1 in _row_chunks(R, n):
            cost = f[r0:r1, None, :] + wq
            d[r0:r1] = -t * torch.logsumexp(-cost / t, dim=-1)
    return d


def softmin_grad_plain(f, d, g, w2, t):
    """Plain version of K6: the softmax weights recomputed from d over the
    (rows, n, n) cost tensor and divided by their sum, chunked over rows
    (the JAX package's ``_soft_bwd_impl``, normalised, with the per-target
    e in place of its reduced dw2 = sum(g * e))."""
    R, n = f.shape
    w2, t = core.f32(w2), core.f32(t)
    df = torch.empty_like(f)
    e = torch.empty_like(f)
    if R and n:
        q = _quad(n, f.device)
        wq = w2 * q
        for r0, r1 in _row_chunks(R, n):
            p = torch.exp(-(f[r0:r1, None, :] + wq - d[r0:r1, :, None]) / t)
            p = p / p.sum(dim=-1, keepdim=True)
            df[r0:r1] = torch.einsum("ri,rij->rj", g[r0:r1], p)
            e[r0:r1] = (p * q).sum(dim=-1)
    return df, e


@functools.cache
def _kernels():
    lib = _build.load("softmin")
    fwd, bwd = lib.edt_softmin, lib.edt_softmin_grad
    fwd.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_cuda(name, f, max_axis, t):
    if f.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {f.device}")
    if f.dim() != 2:
        raise ValueError(f"f must be (rows, n), got shape {tuple(f.shape)}")
    R, n = f.shape
    _check("f", f, torch.float32, (R, n), f.device)
    if n > max_axis:
        raise ValueError(f"rows of {n} exceed the kernel's {max_axis}")
    if R >= 2 ** 31:
        raise ValueError(f"{R} rows exceed one launch grid")
    if not t > 0.0:
        raise ValueError(f"{name} needs a temperature > 0, got {t}")
    return R, n


def softmin(f, w2, t):
    """d[r, i] = -t log sum_j exp(-(f[r, j] + w2 (i - j)^2) / t), INF on
    all-INF rows.

    f: (R, n) f32, C-contiguous. CUDA tensors run the K5 kernel; CPU
    tensors the plain version.
    """
    global launches
    if f.device.type == "cpu":
        return softmin_plain(f, w2, t)
    R, n = _check_cuda("softmin", f, MAX_AXIS, t)
    d = torch.empty_like(f)
    if R == 0 or n == 0:
        return d
    err = _kernels()[0](f.data_ptr(), d.data_ptr(), R, n, core.f32(w2),
                        core.f32(t),
                        torch.cuda.current_stream(f.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"softmin kernel launch failed: cudaError {err}")
    launches += 1
    return d


def softmin_grad(f, d, g, w2, t):
    """(df, e) of the softmin pass: df_j = sum_i g_i p_ij, e_i = sum_j p_ij
    (i - j)^2 with p_ij the softmax weights exp((d_i - f_j - w2 (i - j)^2)
    / t) over j, normalised to sum 1.

    f, d (``softmin``'s output), g: (R, n) f32, C-contiguous, on one
    device; f finite somewhere in every row (an all-INF row gives 0 here,
    NaN in the plain version). CUDA tensors run the K6 kernel; CPU tensors
    the plain version.
    """
    global grad_launches
    if f.device.type == "cpu":
        return softmin_grad_plain(f, d, g, w2, t)
    R, n = _check_cuda("softmin_grad", f, GRAD_MAX_AXIS, t)
    _check("d", d, torch.float32, (R, n), f.device)
    _check("g", g, torch.float32, (R, n), f.device)
    df = torch.empty_like(f)
    e = torch.empty_like(f)
    if R == 0 or n == 0:
        return df, e
    err = _kernels()[1](f.data_ptr(), d.data_ptr(), g.data_ptr(),
                        df.data_ptr(), e.data_ptr(), R, n, core.f32(w2),
                        core.f32(t),
                        torch.cuda.current_stream(f.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"softmin_grad kernel launch failed: cudaError {err}")
    grad_launches += 1
    return df, e
