"""Device-native API on torch tensors (counterpart of ``edt_tpu.jax_api``).

    import edt_tpu_torch.torch_api as edtt
    d2 = edtt.edtsq(labels, (1.0, 1.0, 1.0), black_border=True)

Tensors in, tensors out, on the tensors' own device (K1 and the other
kernels on a CUDA tensor, their plain versions on a CPU tensor). For the
NumPy drop-in API use the top-level ``edt_tpu_torch`` module instead.

``default_minplus_fn`` and ``default_parabolic_fn`` keep the JAX
package's meaning: the kernel-backed function (K1) with CUDA, None where
the plain path runs; ``make_parabolic_fn`` builds the pass around any
min-plus. The sharded names (``default_mesh``,
``edtsq_sharded``, ``edtsq_sharded_auto``, ``edt_sharded``,
``sdf_sharded``, ``edtsq_voxel_graph_sharded``) run over
``torch.distributed``, every rank calling them (``parallel.sharded``).
"""

from __future__ import annotations

import torch

from edt_tpu_torch.models.soft import (
    default_barrier,
    edtsq_from_heights,
    multilabel_edtsq,
    soft_edtsq,
    soft_sdfsq,
    wall_counts_for,
)
from edt_tpu_torch.ops.compose import (
    default_minplus_fn,
    default_parabolic_fn,
    edt,
    edtsq,
    sdf,
    sdfsq,
)
from edt_tpu_torch.ops.minplus import make_parabolic_fn
from edt_tpu_torch.ops.voxel_graph import edtsq_voxel_graph_torch
from edt_tpu_torch.parallel.sharded import (
    default_mesh,
    edt_sharded,
    edtsq_sharded,
    edtsq_sharded_auto,
    edtsq_voxel_graph_sharded,
    sdf_sharded,
)


def extract_label(labels, dt, label):
    """dt masked to one label, on their device: dt * (labels == label).

    The reference library's masking fallback as one device op; use
    ``extract_labels`` to take many labels in one launch.
    """
    return torch.where(labels == label, dt, torch.zeros((), dtype=dt.dtype,
                                                        device=dt.device))


def extract_labels(labels, dt, ids):
    """A (len(ids), *labels.shape) stack whose slab k is
    dt * (labels == ids[k]): one broadcast compare against the id vector,
    in one launch. The stack is len(ids) full volumes, so callers chunk
    batches that would not fit in device memory.
    """
    ids = torch.as_tensor(ids, dtype=labels.dtype, device=labels.device)
    hit = labels.unsqueeze(0) == ids.reshape((-1,) + (1,) * labels.dim())
    return torch.where(hit, dt.unsqueeze(0),
                       torch.zeros((), dtype=dt.dtype, device=dt.device))


def each_device(labels, dt, ids=None):
    """Device-side analog of ``edt_tpu_torch.each``: yields (label, masked
    dt) with every masked volume computed and left on the device.

    ids: the labels to yield; by default the unique nonzero labels (one
    device reduction and a small copy of the id list to the host).
    """
    if ids is None:
        ids = [u for u in torch.unique(labels).tolist() if u != 0]
    for k in ids:
        yield k, extract_label(labels, dt, k)


__all__ = [
    "edt", "edtsq", "sdf", "sdfsq",
    "default_minplus_fn", "default_parabolic_fn", "make_parabolic_fn",
    "edtsq_voxel_graph_torch",
    "edtsq_from_heights", "multilabel_edtsq", "wall_counts_for",
    "soft_edtsq", "soft_sdfsq",
    "default_barrier",
    "default_mesh", "edtsq_sharded", "edtsq_sharded_auto", "edt_sharded",
    "sdf_sharded", "edtsq_voxel_graph_sharded",
    "extract_label", "extract_labels", "each_device",
]
