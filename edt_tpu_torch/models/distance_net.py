"""DistanceFieldNet on one device (counterpart of
``edt_tpu.models.distance_net``).

A per-voxel MLP head predicts soft occupancy from multi-channel voxel
features; the loss compares the differentiable squared EDT of that
occupancy (``soft.soft_edtsq`` at temperature t > 0: K5 forward, K6
backward on CUDA tensors) against a target distance field:

  features (B, X, Y, Z, C) --MLP--> logits --sigmoid--> occupancy
      --softmin passes--> d --L2 vs target--> loss --grad--> parameters

Matmuls stay in f32 (``torch.backends.cuda.matmul.allow_tf32`` False, the
PyTorch default), as the JAX package's ``preferred_element_type=F32``
asks. ``jax.nn.gelu`` is the tanh approximation, so is the port's.
``params_from_jax`` takes the JAX package's parameter dict, as NumPy
arrays, to the module's state dict.

The sharded step runs over a 2-D (dp, sp) ``DeviceMesh``, one process a
card, every rank calling it (``parallel.train``): the batch over dp, X
over sp, the axis-0 pass between two ``all_to_all`` rotations over the
sp group. The head is pointwise, so spatial sharding needs no halo. Two
modes, as in the JAX package:

- ``grad_reduce_scatter=False``: one ``all_reduce`` of the gradients and
  the loss over the mesh; the optimizer runs replicated.
- ``grad_reduce_scatter=True``: each gradient, flattened and zero-padded
  to a multiple of the mesh size n, is ``reduce_scatter``ed over sp, then
  over dp; the optimizer (``init_sharded_opt_state``) holds the rank's
  1/n slice of every parameter and its moments, block sp * n_dp + dp of
  the flat layout (JAX's sp-major order); the updated slices come back
  by ``all_gather`` over dp, then sp. ``DeviceMesh`` numbers the ranks
  dp * n_sp + sp, so the world group's rank order is not the block order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from edt_tpu_torch import api
from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import compose
from edt_tpu_torch.parallel import train

F32 = torch.float32


class DistanceFieldNet(nn.Module):
    """The MLP head c_in -> hidden -> hidden -> 1 (the JAX package's
    ``init_params`` and ``apply``): weights drawn from ``generator`` as
    N(0, 1/fan_in), biases zero."""

    def __init__(self, c_in=8, hidden=32, *, generator=None, device=None):
        super().__init__()
        self.fc1 = nn.Linear(c_in, hidden, device=device)
        self.fc2 = nn.Linear(hidden, hidden, device=device)
        self.fc3 = nn.Linear(hidden, 1, device=device)
        with torch.no_grad():
            for layer in (self.fc1, self.fc2, self.fc3):
                w = torch.randn(layer.weight.shape, generator=generator,
                                dtype=F32)
                layer.weight.copy_(w / np.sqrt(layer.in_features))
                layer.bias.zero_()

    def forward(self, feats):
        """Per-voxel occupancy logits; feats (..., C) -> (...)."""
        x = F.gelu(self.fc1(feats.to(F32)), approximate="tanh")
        x = F.gelu(self.fc2(x), approximate="tanh")
        return self.fc3(x)[..., 0]


def params_from_jax(params) -> dict:
    """The state dict of ``DistanceFieldNet`` from the JAX package's
    parameter dict (``w1``..``w3`` as (in, out), ``b1``..``b3``)."""
    out = {}
    for k in (1, 2, 3):
        w = np.asarray(params[f"w{k}"], np.float32)
        out[f"fc{k}.weight"] = torch.from_numpy(w.T.copy())
        out[f"fc{k}.bias"] = torch.from_numpy(
            np.asarray(params[f"b{k}"], np.float32).copy())
    return out


def forward(model, feats, anisotropy=(1.0, 1.0, 1.0), temperature=0.3,
            barrier=None, axis_name=None, *, kernels=soft.KERNELS):
    """Predicted squared distance field of a batch (B, X, Y, Z, C) of
    feature volumes, (B, X, Y, Z). axis_name: None, or the process group
    over which X is sharded (feats then this rank's slabs)."""
    occ = torch.sigmoid(model(feats))
    return soft._soft_edtsq_batch(occ, anisotropy, True, barrier,
                                  temperature, axis_name, kernels=kernels)


def loss_fn(model, feats, target_dt, anisotropy=(1.0, 1.0, 1.0),
            temperature=0.3, barrier=None, axis_name=None, *,
            kernels=soft.KERNELS):
    d = forward(model, feats, anisotropy, temperature, barrier, axis_name,
                kernels=kernels)
    return torch.mean((d - target_dt) ** 2)


def make_train_step(model, optimizer, anisotropy=(1.0, 1.0, 1.0),
                    temperature=0.3, barrier=None, *, kernels=soft.KERNELS):
    """One training step, ``step(feats, target) -> loss``: the loss, its
    gradient, and one update of ``optimizer`` (``optax.adam(lr)`` is
    ``torch.optim.Adam(params, lr, betas=(0.9, 0.999), eps=1e-8)``)."""

    def step(feats, target_dt):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, feats, target_dt, anisotropy, temperature,
                       barrier, kernels=kernels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _pad_flat(x, n):
    """x flattened and zero-padded to a multiple of n."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % n))


def _block(mesh, dp_axis, sp_axis) -> int:
    """This rank's block of the flat padded layout: sp * n_dp + dp."""
    return (mesh.get_local_rank(sp_axis) * train.axis_size(mesh, dp_axis)
            + mesh.get_local_rank(dp_axis))


def _own_slice(p, n, block):
    flat = _pad_flat(p.detach(), n)
    size = flat.numel() // n
    return flat[block * size:(block + 1) * size]


def init_sharded_opt_state(mesh, make_optimizer, model, dp_axis="dp",
                           sp_axis="sp"):
    """The rank's optimizer for the reduce-scatter step (ZeRO-style): each
    parameter flattened, zero-padded to a multiple of the mesh size n, and
    this rank's 1/n slice of it (block sp * n_dp + dp) copied out;
    ``make_optimizer``, a callable from a list of tensors to a
    ``torch.optim`` optimizer (e.g. ``lambda ts: torch.optim.Adam(ts,
    3e-3)``), builds the optimizer over those slices, so its moments live
    on the same 1/n of the flat layout. Feed it to
    ``make_sharded_train_step(..., grad_reduce_scatter=True)``. (The JAX
    package's ``params_template`` has no counterpart: the model carries
    its shapes.)"""
    n = mesh.size()
    block = _block(mesh, dp_axis, sp_axis)
    return make_optimizer([_own_slice(p, n, block).clone()
                           for p in model.parameters()])


def _sharded_slices(optimizer, params, n):
    """The optimizer's parameters when they are the 1/n slices of
    ``init_sharded_opt_state``, in the model's order; else ValueError."""
    slices = [t for group in optimizer.param_groups for t in group["params"]]
    ids = {id(p) for p in params}
    if (len(slices) != len(params)
            or any(id(s) in ids or s.dim() != 1
                   or s.numel() != -(-p.numel() // n)
                   for s, p in zip(slices, params))):
        raise ValueError(
            "grad_reduce_scatter=True takes the optimizer of "
            "init_sharded_opt_state(mesh, make_optimizer, model)")
    return slices


def make_sharded_train_step(model, mesh, optimizer,
                            anisotropy=(1.0, 1.0, 1.0), temperature=0.3,
                            barrier=None, dp_axis="dp", sp_axis="sp",
                            grad_reduce_scatter=False, *,
                            kernels=soft.KERNELS):
    """Training step over a (dp, sp) ``DeviceMesh``, ``step(feats, target)
    -> loss``, every rank calling it (module doc).

    feats (B, X, Y, Z, C) and target (B, X, Y, Z): the whole batch, the
    same on every rank, or DTensors placed (Shard(0), Shard(1)); B must
    divide by n_dp, X by n_sp and Z by n_sp (the rotation). Each rank's
    loss is its sum of squared errors over the global count; the step
    returns the global loss. The parameters stay replicated.

    grad_reduce_scatter=False: ``optimizer`` is over ``model.parameters()``.
    grad_reduce_scatter=True: ``optimizer`` is the one
    ``init_sharded_opt_state`` built over this rank's slices.
    """
    if barrier is None:
        raise ValueError(
            "sharded training requires an explicit barrier (the default "
            "would be derived from the local slab shape)")
    dp = mesh.get_group(dp_axis)
    sp = mesh.get_group(sp_axis)
    whole = train.mesh_group(mesh)
    n = mesh.size()

    def local_loss(feats, target_dt):
        f = train.batch_block(feats, mesh, dp_axis, sp_axis)
        t = train.batch_block(target_dt, mesh, dp_axis, sp_axis)
        d = forward(model, f, anisotropy, temperature, barrier, sp,
                    kernels=kernels)
        return torch.sum((d - t) ** 2) / (d.numel() * n)

    if not grad_reduce_scatter:
        return train.replicated_step(model, optimizer, local_loss, whole)

    params = list(model.parameters())
    slices = _sharded_slices(optimizer, params, n)
    block = _block(mesh, dp_axis, sp_axis)
    n_sp = dist.get_world_size(sp)

    def step(feats, target_dt):
        model.zero_grad(set_to_none=True)
        optimizer.zero_grad(set_to_none=True)
        loss = local_loss(feats, target_dt)
        loss.backward()
        with torch.no_grad():
            loss = loss.detach().reshape(1)
            dist.all_reduce(loss, group=whole)
            for p, s in zip(params, slices):
                g = _pad_flat(p.grad if p.grad is not None
                              else torch.zeros_like(p), n)
                # over sp first, then dp: the block sp * n_dp + dp
                part = g.new_empty(g.numel() // n_sp)
                dist.reduce_scatter_tensor(part, g, group=sp)
                s.grad = torch.empty_like(s)
                dist.reduce_scatter_tensor(s.grad, part, group=dp)
                s.copy_(_own_slice(p, n, block))
            optimizer.step()
            for p, s in zip(params, slices):
                # the reverse of the scatter: over dp, then sp
                part = s.new_empty(s.numel() * (n // n_sp))
                dist.all_gather_into_tensor(part, s, group=dp)
                full = s.new_empty(s.numel() * n)
                dist.all_gather_into_tensor(full, part, group=sp)
                p.copy_(full[:p.numel()].view_as(p))
        return loss[0]

    return step


def _box_labels(rng, batch, shape) -> np.ndarray:
    """``synthetic_batch``'s geometry: one random box a volume, uint8."""
    labels = np.zeros((batch, *shape), np.uint8)
    for b in range(batch):
        x0, y0, z0 = rng.integers(0, np.array(shape) // 2, 3)
        x1, y1, z1 = (
            np.array([x0, y0, z0]) + rng.integers(2, np.array(shape) // 2, 3))
        labels[b, x0:x1, y0:y1, z0:z1] = 1
    return labels


def synthetic_batch(rng, batch, shape, c_in=8, *, device=None):
    """A toy task: noisy renderings of random boxes and their true squared
    EDT (``compose.edtsq`` with black borders). rng: a NumPy Generator,
    which draws the boxes, then the noise. Returns (feats (B, X, Y, Z, C),
    target (B, X, Y, Z)) on ``device`` (default CUDA)."""
    dev = api._device(device)
    labels = _box_labels(rng, batch, shape)
    lab = torch.from_numpy(labels).to(dev)
    target = torch.stack([compose.edtsq(lab[b], (1.0, 1.0, 1.0), True)
                          for b in range(batch)])
    noise = rng.standard_normal((batch, *shape, c_in), dtype=np.float32)
    feats = lab[..., None].to(F32) + torch.from_numpy(noise).to(dev) * 0.1
    return feats, target
