"""Slab-sharded EDT over ``torch.distributed`` (counterpart of
``edt_tpu.parallel.sharded``).

One process a card: every rank of a process group calls the same function
on the same arguments (SPMD), as every device runs the JAX package's
``shard_map`` body. The volume is cut into slabs along axis 0, one a rank,
and each 1-D pass runs on rows that lie whole on one rank:

  pass 1 (axis 2, the closed form) and pass 2 (axis 1): rows lie inside a
  slab, no communication;
  pass 3 (axis 0): rows cross slabs, so one all-to-all rotates the
  volume (axis 2 split across the ranks, axis 0 gathered), the pass runs
  on whole rows, and a second all-to-all rotates it back.

Each rank's passes go through ``compose``/``core`` as on one card, so K1
sees whole rows. The labels ride the same rotation, except on the binary
path, which needs none. The slab body (``edtsq_slabs``, over a list of
slabs and an exchange) also serves ``parallel.local``, the NumPy API's
one-process form over several cards.

The JAX concepts map so:

- a ``Mesh`` with one axis named ``axis_name``: a 1-D ``DeviceMesh`` with
  ``mesh_dim_names=(axis_name,)`` (``default_mesh``);
- a global array sharded ``P(axis_name)``: a ``DTensor`` placed
  ``[Shard(0)]`` on that mesh;
- the ``shard_map`` body on its block: plain tensor code on the rank's
  slab;
- ``lax.all_to_all(x, axis_name, split_axis, concat_axis, tiled=True)``:
  ``all_to_all`` (``rotate`` with its gradient, the reverse rotation);
- ``lax.axis_index(axis_name)``: the rank in the mesh's group.

Inputs are a tensor holding the whole volume, the same on every rank, or a
``DTensor``; outputs are a ``DTensor`` ``[Shard(0)]`` of the input's shape
whose slabs follow DTensor's uneven layout: with c = ceil(s0 / n), rank r
keeps rows [r c, min((r + 1) c, s0)). The tensors stay on their device:
the collectives take them as they are (NCCL on cards; gloo, which stages
CUDA tensors through host memory, or CPU tensors).

Any shape is accepted: axes 0 and 2 are padded to a multiple of the rank
count and cropped after, exactly as the JAX package does:

  * black_border=True pads with background (zeros): a background plane
    just outside the volume is the black border itself.
  * black_border=False pads by edge replication: segments touching the
    edge extend through the pad to the still-open border, and a padded
    candidate costs at least as much as the edge candidate it copies, so
    the result is bit-identical to the unpadded transform.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from edt_tpu_torch import api
from edt_tpu_torch.ops import compose, core, minplus
from edt_tpu_torch.ops.voxel_graph import doubled_3d_torch
from edt_tpu_torch.utils import profiling


def default_mesh(axis_name: str = "sp", *, device=None) -> DeviceMesh:
    """A 1-D mesh over every rank of the initialised default process
    group, on CUDA unless ``device`` names another device type. Each rank
    selects its card (``torch.cuda.set_device``) before, as ``torchrun``
    users do; otherwise DeviceMesh takes card rank % device_count."""
    if not dist.is_initialized():
        raise RuntimeError(
            "default_mesh: initialise the process group first "
            "(torch.distributed.init_process_group, or run under torchrun)")
    return init_device_mesh(api._device(device).type,
                            (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


# ---------------- the rotation ----------------


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over ``group``: split ``split_axis`` into one block a rank, send block
    j to rank j, and join the blocks received along ``concat_axis`` in
    rank order. Every rank passes the same shape. The bytes move as
    uint8, so any dtype travels (NCCL maps no int16, gloo few types)."""
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    with profiling.span("edt_tpu_torch.rotate", x, ranks=n,
                        bytes=x.numel() * x.element_size()):
        send = x.movedim(split_axis, 0)
        (send,) = profiling.contiguous(
            send.reshape(n, send.shape[0] // n, *send.shape[1:]))
        recv = torch.empty_like(send)
        if send.numel():
            with profiling.span("edt_tpu_torch.exchange", x,
                                bytes=send.numel() * send.element_size()):
                dist.all_to_all_single(recv.view(-1).view(torch.uint8),
                                       send.view(-1).view(torch.uint8),
                                       group=group)
        shape = list(x.shape)
        shape[split_axis] //= n
        shape[concat_axis] *= n
        # recv[j] is rank j's block: put the split axis back, then rank j's
        # part of the concat axis just before it (index j * size + k)
        with profiling.span(profiling.TRANSPOSE, x, bytes=0) as s:
            out = (recv.movedim(1, split_axis + 1).movedim(0, concat_axis)
                   .reshape(shape))
            s.copied(recv, out)
        return out


class _Rotate(torch.autograd.Function):
    """``all_to_all`` whose gradient is the reverse rotation (the
    transpose of ``lax.all_to_all``)."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (concat_axis, split_axis)
        return all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group, *ctx.axes), None, None, None


def rotate(x, group, split_axis, concat_axis):
    """Differentiable ``all_to_all``."""
    return _Rotate.apply(x, group, split_axis, concat_axis)


# ---------------- slabs in, DTensor out ----------------


def pad_axis(x, axis, size, black_border, edge=None):
    """Pad ``axis`` of ``x`` to ``size``: zeros under black_border, else
    ``edge`` repeated, a plane of size 1 along ``axis`` (default: x's
    last; see module doc)."""
    shape = list(x.shape)
    shape[axis] = size - x.shape[axis]
    if shape[axis] <= 0:
        return x
    if black_border:
        fill = x.new_zeros(shape)
    else:
        if edge is None:
            edge = x.narrow(axis, x.shape[axis] - 1, 1)
        fill = edge.expand(shape)
    return torch.cat([x, fill], dim=axis)


def _pad_rotation_axes(x, nshards, black_border, pad_axes=(0, 2)):
    """Pad ``x`` so every axis of ``pad_axes`` divides ``nshards``: zeros
    under black_border, else the edge plane repeated (see module doc)."""
    for a in pad_axes:
        x = pad_axis(x, a, -(-x.shape[a] // nshards) * nshards, black_border)
    return x


def _local_slab(x, mesh, axis_name, black_border, pad_axes=(0, 2)):
    """(this rank's slab of the padded volume, the volume's shape).

    A DTensor placed [Shard(0)] on ``mesh`` whose ``pad_axes`` divide the
    rank count gives its own local slab. Any other DTensor is first
    gathered whole onto every rank (``full_tensor``, an all-gather of the
    volume), then padded and cut like a plain tensor."""
    n = mesh.size()
    if isinstance(x, DTensor):
        if (x.device_mesh == mesh and tuple(x.placements) == (Shard(0),)
                and all(x.shape[a] % n == 0 for a in pad_axes)):
            return x.to_local(), tuple(x.shape)
        x = x.full_tensor()
    shape = tuple(x.shape)
    x = _pad_rotation_axes(x, n, black_border, pad_axes)
    c = x.shape[0] // n
    r = mesh.get_local_rank(axis_name)
    return x[r * c:(r + 1) * c], shape


def crop(slab, shape, r):
    """Slab ``r`` (c rows of the padded volume) cropped to the volume's
    ``shape``: rows [r c, min((r + 1) c, s0)), DTensor's own uneven
    layout, and the first shape[a] of every other axis."""
    c = slab.shape[0]
    slab = slab[:max(0, min(c, shape[0] - r * c))]
    for a in range(1, slab.dim()):
        slab = slab.narrow(a, 0, shape[a])
    return slab


def _to_dtensor(local, shape, mesh, axis_name):
    """Crop a padded slab to the volume's ``shape`` and wrap it as a
    DTensor [Shard(0)]."""
    local = crop(local, shape, mesh.get_local_rank(axis_name))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh, [Shard(0)],
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def edtsq_slabs(labs, anis, black_border, exchange, binary, minplus_fn,
                parabolic_fn):
    """The transform of a list of slabs of one volume, whose axes 0 (the
    slabs) and 2 divide the slab count n, each slab on its own device.
    ``exchange(slabs, split_axis, concat_axis)`` is the all-to-all over
    them: the slabs with ``split_axis`` cut into n blocks, block j of
    every slab joined in slab order along ``concat_axis`` as slab j.

    SPMD over a process group, the list holds the rank's own slab
    (``_group_exchange``); one process over several cards, one slab a
    card (``parallel.local``). Pass 1 (axis 2, the closed form) and pass 2
    (axis 1) run on each slab; pass 3 (axis 0) between two exchanges."""
    fs = [compose._along_last(
        lambda lb: core.rp_pass_sq(lb, anis[2], black_border), 2, lab)
        for lab in labs]
    fs = [compose.parabolic_along(f, lab, 1, anis[1], black_border, binary,
                                  parabolic_fn, minplus_fn)
          for f, lab in zip(fs, labs)]
    fs = exchange(fs, 2, 0)
    labs = [None] * len(fs) if binary else exchange(labs, 2, 0)
    fs = [compose.parabolic_along(f, lab, 0, anis[0], black_border, binary,
                                  parabolic_fn, minplus_fn)
          for f, lab in zip(fs, labs)]
    return exchange(fs, 0, 2)


def _group_exchange(group):
    """``edtsq_slabs``'s exchange for one rank's slab: ``all_to_all``."""
    return lambda slabs, split_axis, concat_axis: [
        all_to_all(slabs[0], group, split_axis, concat_axis)]


def _edtsq_slab(lab, anis, black_border, group, binary, minplus_fn,
                parabolic_fn):
    """``edtsq_slabs`` on this rank's slab over ``group``."""
    return edtsq_slabs([lab], anis, black_border, _group_exchange(group),
                       binary, minplus_fn, parabolic_fn)[0]


def doubled_slab(fg, graph, shape, r, n, black_border):
    """Slab ``r`` of the voxel graph's doubled volume, from slab r of the
    foreground mask and the graph (c rows of the volume padded along
    axis 0 to n c), axis 2 padded to a multiple of n. black_border zeroes
    the *original* volume's last doubled plane along each axis, which
    under padding may lie inside an earlier slab."""
    s0, s1, s2 = shape
    D = doubled_3d_torch(fg, graph.to(torch.uint8), False)
    if black_border:
        D[:, :, 2 * s2 - 1] = 0
        D[:, 2 * s1 - 1, :] = 0
        tail_slab, tail_off = divmod(2 * s0 - 1, D.shape[0])
        if r == tail_slab:
            D[tail_off] = 0
    return _pad_rotation_axes(D, n, black_border, (2,))


def _anisotropy(anisotropy):
    return [core.f32(a) for a in np.asarray(anisotropy, np.float32).reshape(3)]


def half_anisotropy(anisotropy):
    """The voxel graph's pitches on the doubled volume, halved in f32."""
    return _anisotropy(np.asarray(anisotropy, np.float32).reshape(3)
                       / np.float32(2.0))


def pass_order(anisotropy):
    """``edtsq_sharded_auto``'s permutation of the volume's axes: the
    largest pitch first (the sharded axis), ascending-pitch pass order
    (ties: the default order), as the single-card API orders its passes."""
    anis = np.asarray(anisotropy, np.float32).reshape(3)
    order = sorted(range(3), key=lambda a: (float(anis[a]), -a))
    return order[2], order[1], order[0]


def _check_3d(x):
    if x.dim() != 3:
        raise ValueError("the sharded path is 3-D; lower dimensions fit on "
                         f"one card (got shape {tuple(x.shape)})")


# ---------------- the transforms ----------------


def edtsq_sharded(labels, anisotropy, black_border=False, *, mesh,
                  axis_name="sp", binary=False, minplus_fn=None,
                  parabolic_fn=None) -> DTensor:
    """Squared multi-label EDT of a 3-D volume sharded along axis 0 of
    ``mesh`` (every rank calls it). Any shape (module doc).

    labels: the whole (s0, s1, s2) volume, the same on every rank, or a
    DTensor. A DTensor that is not [Shard(0)] on ``mesh``, or whose axis 0
    or 2 does not divide the rank count, costs an all-gather of the whole
    volume onto every rank before it is padded. binary=True is the fast
    path for two-valued volumes (labels already a foreground mask): no
    label rotation. minplus_fn and parabolic_fn as in ``compose.edtsq``;
    with neither, K1 on CUDA tensors.
    """
    _check_3d(labels)
    if minplus_fn is None and parabolic_fn is None:
        parabolic_fn = minplus.make_parabolic_fn()
    lab, shape = _local_slab(labels, mesh, axis_name, black_border)
    out = _edtsq_slab(lab, _anisotropy(anisotropy), black_border,
                      mesh.get_group(axis_name), binary, minplus_fn,
                      parabolic_fn)
    return _to_dtensor(out, shape, mesh, axis_name)


def edtsq_sharded_auto(labels, anisotropy, black_border=False, *, mesh=None,
                       axis_name="sp", binary=False, minplus_fn=None,
                       parabolic_fn=None) -> DTensor:
    """``edtsq_sharded`` in ascending-pitch pass order over the default
    (or given) mesh: the volume is permuted so that the smallest pitch
    takes the closed form and the largest the rotated pass, as the
    single-card API orders its passes. The result comes back in the
    input's layout, sharded along the input axis that took the largest
    pitch (a DTensor permute, no communication)."""
    if mesh is None:
        mesh = default_mesh(axis_name)
    anis = np.asarray(anisotropy, np.float32).reshape(3)
    perm = pass_order(anis)
    kw = dict(mesh=mesh, axis_name=axis_name, binary=binary,
              minplus_fn=minplus_fn, parabolic_fn=parabolic_fn)
    if perm == (0, 1, 2):
        return edtsq_sharded(labels, anis, black_border, **kw)
    out = edtsq_sharded(labels.permute(perm), anis[list(perm)], black_border,
                        **kw)
    return out.permute(tuple(int(i) for i in np.argsort(perm)))


def edtsq_voxel_graph_sharded(labels, graph, anisotropy, black_border=False,
                              *, mesh, axis_name="sp",
                              minplus_fn=None) -> DTensor:
    """Voxel-connectivity-graph EDT sharded along axis 0, any shape.

    Each rank doubles its own slab (``doubled_3d_torch``), so the 8x
    doubled volume never exists whole. Axis 0 is padded to a multiple of
    the rank count before doubling (zeros under black_border, else edge
    replication, which copies the edge voxel's graph bits). black_border
    zeroes the *original* volume's last doubled plane along each axis,
    which under padding may lie inside an earlier rank's slab. "x" is the
    last array axis (C order).
    """
    _check_3d(labels)
    lab, shape = _local_slab(labels, mesh, axis_name, black_border, (0,))
    g, _ = _local_slab(graph, mesh, axis_name, black_border, (0,))
    fg = lab > 0 if lab.is_floating_point() else lab != 0
    D = doubled_slab(fg, g, shape, mesh.get_local_rank(axis_name),
                     mesh.size(), black_border)
    parabolic_fn = (None if minplus_fn is not None
                    else minplus.make_parabolic_fn())
    d2 = _edtsq_slab(D, half_anisotropy(anisotropy), black_border,
                     mesh.get_group(axis_name), True, minplus_fn,
                     parabolic_fn)
    return _to_dtensor(d2[::2, ::2, :2 * shape[2]:2], shape, mesh, axis_name)


def edt_sharded(labels, anisotropy, black_border=False, *, mesh,
                axis_name="sp", binary=False, minplus_fn=None,
                parabolic_fn=None) -> DTensor:
    """Euclidean distance, sqrt of ``edtsq_sharded``."""
    return torch.sqrt(edtsq_sharded(
        labels, anisotropy, black_border, mesh=mesh, axis_name=axis_name,
        binary=binary, minplus_fn=minplus_fn, parabolic_fn=parabolic_fn))


def sdf_sharded(labels, anisotropy, black_border=False, *, mesh,
                axis_name="sp", minplus_fn=None) -> DTensor:
    """Signed distance field, edt(x) - edt(x == 0), sharded."""
    kw = dict(mesh=mesh, axis_name=axis_name, minplus_fn=minplus_fn)
    fg = edt_sharded(labels, anisotropy, black_border, **kw)
    bg = edt_sharded((labels == 0).to(torch.uint8), anisotropy, black_border,
                     binary=True, **kw)
    return fg - bg
