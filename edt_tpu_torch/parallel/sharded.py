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
path, which needs none.

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
    send = x.movedim(split_axis, 0)
    send = send.reshape(n, send.shape[0] // n, *send.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    if send.numel():
        dist.all_to_all_single(recv.view(-1).view(torch.uint8),
                               send.view(-1).view(torch.uint8), group=group)
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    # recv[j] is rank j's block: put the split axis back, then rank j's
    # part of the concat axis just before it (index j * size + k)
    return recv.movedim(1, split_axis + 1).movedim(0, concat_axis).reshape(shape)


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


def _pad_rotation_axes(x, nshards, black_border, pad_axes=(0, 2)):
    """Pad ``x`` so every axis of ``pad_axes`` divides ``nshards``: zeros
    under black_border, else the edge plane repeated (see module doc)."""
    for a in pad_axes:
        p = (-x.shape[a]) % nshards
        if p:
            edge = x.narrow(a, x.shape[a] - 1, 1)
            fill = torch.zeros_like(edge) if black_border else edge
            size = list(x.shape)
            size[a] = p
            x = torch.cat([x, fill.expand(size)], dim=a)
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


def _to_dtensor(local, shape, mesh, axis_name):
    """Crop a padded slab to the volume's ``shape`` and wrap it as a
    DTensor [Shard(0)]: rank r keeps rows [r c, min((r + 1) c, s0)) of
    its c-row slab, DTensor's own uneven layout."""
    c = local.shape[0]
    r = mesh.get_local_rank(axis_name)
    local = local[:max(0, min(c, shape[0] - r * c))]
    for a in range(1, local.dim()):
        local = local.narrow(a, 0, shape[a])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh, [Shard(0)],
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _edtsq_slab(lab, anis, black_border, group, binary, minplus_fn,
                parabolic_fn):
    """The transform of a slab whose axes 0 (over the ranks) and 2 divide
    the rank count."""
    f = compose._along_last(
        lambda lb: core.rp_pass_sq(lb, anis[2], black_border), 2, lab)
    f = compose.parabolic_along(f, lab, 1, anis[1], black_border, binary,
                                parabolic_fn, minplus_fn)
    f = all_to_all(f, group, 2, 0)
    lab = None if binary else all_to_all(lab, group, 2, 0)
    f = compose.parabolic_along(f, lab, 0, anis[0], black_border, binary,
                                parabolic_fn, minplus_fn)
    return all_to_all(f, group, 0, 2)


def _anisotropy(anisotropy):
    return [core.f32(a) for a in np.asarray(anisotropy, np.float32).reshape(3)]


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
    order = sorted(range(3), key=lambda a: (float(anis[a]), -a))
    perm = (order[2], order[1], order[0])  # sharded axis 0: largest pitch
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
    n = mesh.size()
    lab, shape = _local_slab(labels, mesh, axis_name, black_border, (0,))
    g, _ = _local_slab(graph, mesh, axis_name, black_border, (0,))
    s0, s1, s2 = shape
    fg = lab > 0 if lab.is_floating_point() else lab != 0
    D = doubled_3d_torch(fg, g.to(torch.uint8), False)
    if black_border:
        D[:, :, 2 * s2 - 1] = 0
        D[:, 2 * s1 - 1, :] = 0
        tail_rank, tail_off = divmod(2 * s0 - 1, D.shape[0])
        if mesh.get_local_rank(axis_name) == tail_rank:
            D[tail_off] = 0
    D = _pad_rotation_axes(D, n, black_border, (2,))
    half = np.asarray(anisotropy, np.float32).reshape(3) / np.float32(2.0)
    parabolic_fn = (None if minplus_fn is not None
                    else minplus.make_parabolic_fn())
    d2 = _edtsq_slab(D, _anisotropy(half), black_border,
                     mesh.get_group(axis_name), True, minplus_fn,
                     parabolic_fn)
    return _to_dtensor(d2[::2, ::2, :2 * s2:2], shape, mesh, axis_name)


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
