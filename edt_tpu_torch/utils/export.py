"""Ahead-of-time export for serving (counterpart of
``edt_tpu.utils.export``): ``torch.export`` of fixed-shape transforms,
serialized to bytes and called back without retracing.

    data = serialize_transform((512, 512, 512), np.uint32,
                               anisotropy=(6, 6, 30), black_border=True)
    run = load(data)            # serving side
    dt = run(labels)            # labels: a torch tensor, see export_transform

Every kernel is a ``torch.library`` custom op (K1
``edt_tpu_torch::minplus_walls``; K2 to K6 ``::minplus_argmin``,
``::minplus_grad``, ``::binary_grad_scan``, ``::softmin``,
``::softmin_grad``; the row scans ``::segment_bounds`` and
``::wall_counts``, recorded for card tensors only: on the CPU they stay
torch ops), so a program records each pass as one op node and loading it
needs ``edt_tpu_torch`` imported in the serving process to register the
ops. That is where the port differs from ``jax.export``,
whose artifacts run with no import of the exporting package. The
differentiable transforms export with their gradient, as ``jax.grad`` of
them does there:

    def gfn(labels, occ):
        occ = occ.detach().requires_grad_()
        with torch.enable_grad():
            out = soft.multilabel_edtsq(labels, occ, (6, 6, 30), True)
            return torch.autograd.grad(out.sum(), occ)[0]

    run = load(export_fn(gfn, labels, occ))
"""

from __future__ import annotations

import io

import numpy as np
import torch

from edt_tpu_torch import api
from edt_tpu_torch.ops import compose


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn, *example_args):
    """``torch.export.export`` of ``fn`` for the shapes, dtypes and device
    of the example tensors; returns an ``ExportedProgram``.

    ``fn`` may call ``torch.autograd.grad``: the backward of each pass
    (its ``autograd.Function``) then runs while the program is traced and
    its kernels' ops are recorded beside the forward's. That needs the
    non-strict export (``strict=False``), which runs ``fn`` as Python on
    fake tensors; the strict one traces with TorchDynamo, which refuses
    ``torch.autograd.grad`` in the graph.

    The program keeps no example inputs: ``torch.export.save`` would write
    them beside the graph, a whole volume each (537 MB for a 512^3 uint32
    one)."""
    program = torch.export.export(_Fn(fn), tuple(example_args), strict=False)
    program.example_inputs = None
    return program


def export_transform(shape, dtype=np.uint32, anisotropy=None,
                     black_border=False, binary=False, sqrt=False,
                     device=None):
    """Exported EDT of a fixed-shape volume on ``device`` (default CUDA):
    labels -> (squared) distances, f32.

    The program takes the tensor the NumPy API would pass for ``dtype``
    labels: ``torch.from_numpy(api._as_device_labels(labels))`` (uint32 is
    viewed as int32, uint16 and int16 widen to int32). 64-bit labels map by
    their values there, to int32 ids or float32, so export those with the
    dtype their mapped volume has. binary: the unmasked fast path (callers
    promise two-valued labels); sqrt: Euclidean instead of squared
    distances."""
    device = api._device(device)
    nd = len(shape)
    anis = [float(a) for a in np.asarray(
        anisotropy if anisotropy is not None else (1.0,) * nd,
        np.float32).reshape(nd)]

    def fn(labels):
        d = compose.edtsq(labels, anis, bool(black_border),
                          binary=bool(binary))
        return torch.sqrt(d) if sqrt else d

    mapped = api._as_device_labels(np.zeros(0, dtype))
    example = torch.zeros(tuple(shape), dtype=torch.from_numpy(mapped).dtype,
                          device=device)
    return export_fn(fn, example)


def serialize_transform(shape, dtype=np.uint32, **kw) -> bytes:
    """``export_transform``'s program as bytes (``torch.export.save``)."""
    buf = io.BytesIO()
    torch.export.save(export_transform(shape, dtype, **kw), buf)
    return buf.getvalue()


def load(data):
    """bytes (or an ``ExportedProgram``) -> a callable running the program.
    Needs ``edt_tpu_torch`` imported, which this module is part of."""
    if isinstance(data, (bytes, bytearray)):
        data = torch.export.load(io.BytesIO(data))
    return data.module()
