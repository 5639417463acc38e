"""The (dp, sp) mesh of the trainers' sharded steps (counterpart of the
``shard_map`` plumbing in ``edt_tpu.models.distance_net`` and
``edt_tpu.models.unet3d``).

A 2-D ``DeviceMesh`` with ``mesh_dim_names`` (dp_axis, sp_axis), one
process a card, every rank calling the step (SPMD): the batch is split
over dp and spatial axis 0 (X) over sp, as JAX's ``P(dp, sp)``. The
mesh's ranks are numbered dp * n_sp + sp (``DeviceMesh``'s row-major
order).

- ``batch_block``: this rank's block of a batch, from the whole batch (the
  same on every rank) or from a ``DTensor`` placed (Shard(0), Shard(1)).
- ``mesh_group``: the process group of the whole mesh, for the
  ``all_reduce`` that stands for ``lax.psum`` over (dp, sp).
- ``replicated_step``: the step of ``grad_reduce_scatter=False``: the
  rank's loss, its gradients, one ``all_reduce`` (SUM) of every gradient
  and of the loss over the mesh, then the same optimizer step on every
  rank, so the parameters stay replicated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard


def axis_size(mesh, axis: str) -> int:
    return dist.get_world_size(mesh.get_group(axis))


def batch_block(x, mesh, dp_axis: str = "dp", sp_axis: str = "sp"):
    """This rank's block of ``x`` (B, X, ...): batch rows
    [dp b, (dp + 1) b) and X rows [sp c, (sp + 1) c), b = B / n_dp,
    c = X / n_sp. ``x`` is the whole batch, the same on every rank, or a
    DTensor; one placed (Shard(0), Shard(1)) on (dp_axis, sp_axis) of
    ``mesh`` gives its own local block, any other is first gathered
    whole (``full_tensor``). Raises ValueError when B or X does not
    divide."""
    n_dp, n_sp = axis_size(mesh, dp_axis), axis_size(mesh, sp_axis)
    if x.dim() < 2 or x.shape[0] % n_dp or x.shape[1] % n_sp:
        raise ValueError(
            f"a batch {tuple(x.shape)} does not split over the mesh: the "
            f"batch over {n_dp} ({dp_axis}) ranks and axis 1 over {n_sp} "
            f"({sp_axis})")
    if isinstance(x, DTensor):
        want = [Shard(0), Shard(0)]
        want[mesh.mesh_dim_names.index(sp_axis)] = Shard(1)
        if x.device_mesh == mesh and list(x.placements) == want:
            return x.to_local()
        x = x.full_tensor()
    b, c = x.shape[0] // n_dp, x.shape[1] // n_sp
    i, j = mesh.get_local_rank(dp_axis), mesh.get_local_rank(sp_axis)
    return x[i * b:(i + 1) * b, j * c:(j + 1) * c]


def mesh_group(mesh):
    """The process group over every rank of ``mesh``: the default group,
    which the mesh must span (as ``init_device_mesh`` over the world
    does)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(
            f"the mesh holds {mesh.size()} of the {dist.get_world_size()} "
            "ranks; the sharded steps take a mesh over every rank")
    return dist.group.WORLD


def replicated_step(model, optimizer, local_loss, group):
    """``step(feats, target) -> loss``: ``local_loss(feats, target)`` is
    this rank's share of the global loss (its sum of squared errors over
    the global count); its gradients and itself are summed over ``group``
    in one ``all_reduce``, and ``optimizer`` (over ``model``'s parameters)
    steps on every rank. Returns the global loss."""
    params = list(model.parameters())

    def step(feats, target_dt):
        optimizer.zero_grad(set_to_none=True)
        loss = local_loss(feats, target_dt)
        loss.backward()
        with torch.no_grad():
            buf = torch.cat([(p.grad if p.grad is not None
                              else torch.zeros_like(p)).reshape(-1)
                             for p in params] + [loss.detach().reshape(1)])
            dist.all_reduce(buf, group=group)
            for p, g in zip(params, buf.split([p.numel() for p in params]
                                              + [1])):
                p.grad = g.view_as(p)
        optimizer.step()
        return buf[-1]

    return step
