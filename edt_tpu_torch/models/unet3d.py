"""UNet3D on one device (counterpart of ``edt_tpu.models.unet3d``).

A small 3-D U-Net predicts soft occupancy from voxel features; the loss
compares the differentiable squared EDT of that occupancy
(``soft.soft_edtsq`` at temperature t > 0: K5 forward, K6 backward on CUDA
tensors) against a target distance field:

  features (B, X, Y, Z, C) --3x3x3 convs--> logits --sigmoid--> occupancy
      --softmin passes--> d --L2 vs target--> loss

Feature volumes stay (B, X, Y, Z, C) at the API, as in the JAX package,
and are permuted to NCDHW inside. The JAX package's DHWIO kernels
(k, k, k, ci, co) are ``Conv3d`` weights (co, ci, k, k, k). Convolutions
pad as XLA's "SAME" does: (k - 1) / 2 on each side at stride 1, and at
stride 2 on an even extent (0, 1), which ``Conv3d``'s symmetric padding
cannot express, so they take an explicit ``F.pad``. ``compute_dtype=
torch.bfloat16`` casts inputs and weights; the output of each conv returns
to f32. The convolutions go to cuDNN (``F.conv3d``), as the JAX package
leaves them to XLA; on the card an f32 conv runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False.

Sharded (``axis_name``, a process group over which X is sharded; the
step over a (dp, sp) mesh, ``parallel.train``): every 3x3x3 conv first
exchanges halos along axis 2 of the NCDHW activations (X): each rank
sends its first plane to the rank before it and its last to the rank
after (``batch_isend_irecv``), and the edge ranks receive zeros, the
"SAME" zero padding of the unsharded conv. The exchange's backward sends
each halo's cotangent back to the rank that owns the plane, which adds it
to its boundary plane's gradient. The haloed axis then takes the VALID
conv at stride 1; at stride 2 it drops the left halo plane and keeps the
right (windows start at even positions), H and W padding (0, 1). Every
slab, and the full Y and Z, must be a multiple of 2**levels, so the
stride-2 stages and the nearest-neighbour upsample stay slab-local.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from edt_tpu_torch.models import soft
from edt_tpu_torch.parallel import train

F32 = torch.float32


def _conv_layer(k, c_in, c_out, generator, device):
    conv = nn.Conv3d(c_in, c_out, k, device=device)
    with torch.no_grad():
        w = torch.randn(conv.weight.shape, generator=generator, dtype=F32)
        conv.weight.copy_(w / np.sqrt(k * k * k * c_in))
        conv.bias.zero_()
    return conv


class UNet3D(nn.Module):
    """``levels`` stride-2 encoder stages and a mirrored decoder, channel
    widths doubling from c0 (the JAX package's ``init_params``): weights
    drawn from ``generator`` as N(0, 1/fan_in), biases zero. ``forward``
    is the JAX package's ``apply``."""

    def __init__(self, c_in=4, c0=8, levels=2, *, generator=None,
                 device=None):
        super().__init__()
        conv = lambda k, ci, co: _conv_layer(k, ci, co, generator, device)  # noqa: E731
        self.stem = conv(3, c_in, c0)
        ch = c0
        for lv in range(levels):
            self.add_module(f"down{lv}", conv(3, ch, ch * 2))  # stride 2
            ch *= 2
            self.add_module(f"enc{lv}", conv(3, ch, ch))
        for lv in reversed(range(levels)):
            self.add_module(f"up{lv}", conv(3, ch, ch // 2))
            ch //= 2
            # the decoder conv takes [upsampled | skip]
            self.add_module(f"dec{lv}", conv(3, 2 * ch, ch))
        self.head = conv(1, ch, 1)

    def forward(self, feats, axis_name=None, compute_dtype=None):
        """Occupancy logits; feats (B, X, Y, Z, C) -> (B, X, Y, Z).
        axis_name: None, or the process group over which X is sharded
        (feats then this rank's slabs; module doc)."""
        levels = num_levels(self)
        if axis_name is not None and any(n % 2 ** levels
                                         for n in feats.shape[1:4]):
            raise ValueError(
                f"sharded UNet3D: the slab {tuple(feats.shape[1:4])} must "
                f"be a multiple of 2**levels = {2 ** levels} on every axis")
        act = lambda x: F.gelu(x, approximate="tanh")  # noqa: E731
        cv = lambda x, name, stride=1: _conv(  # noqa: E731
            x, getattr(self, name), stride, axis_name, compute_dtype)
        x = act(cv(feats.to(F32).permute(0, 4, 1, 2, 3), "stem"))
        skips = []
        for lv in range(levels):
            skips.append(x)
            x = act(cv(x, f"down{lv}", stride=2))
            x = act(cv(x, f"enc{lv}"))
        for lv in reversed(range(levels)):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = act(cv(x, f"up{lv}"))
            x = torch.cat([x, skips[lv]], dim=1)
            x = act(cv(x, f"dec{lv}"))
        return cv(x, "head")[:, 0]


def num_levels(model) -> int:
    return sum(1 for name, _ in model.named_children()
               if name.startswith("down"))


def _same_pads(shape, k, stride):
    """F.pad's (lo, hi) pairs, last axis first, of XLA's "SAME" padding."""
    pads = []
    for n in reversed(shape):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _swap_planes(first, last, group):
    """Send ``first`` to the group's previous rank and ``last`` to its
    next; returns (the previous rank's ``last``, the next rank's
    ``first``), zeros at the edge ranks."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    from_prev = torch.zeros_like(last, memory_format=torch.contiguous_format)
    from_next = torch.zeros_like(first, memory_format=torch.contiguous_format)
    ops = []
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, first.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_prev, peer, group)]
    if r < n - 1:
        peer = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, last.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_next, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _ExchangeHalo(torch.autograd.Function):
    """(B, C, d, H, W) -> (B, C, d + 2, H, W): the previous rank's last
    plane before the slab, the next rank's first plane after it (JAX's
    non-wrapping ``ppermute`` pair). The backward returns each halo's
    cotangent to the plane it copied."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        left, right = _swap_planes(x[:, :, :1], x[:, :, -1:], group)
        return torch.cat([left, x, right], dim=2)

    @staticmethod
    def backward(ctx, g):
        to_prev, to_next = g[:, :, :1], g[:, :, -1:]
        from_prev, from_next = _swap_planes(to_prev, to_next, ctx.group)
        dx = g[:, :, 1:-1].clone()
        dx[:, :, :1] += from_prev
        dx[:, :, -1:] += from_next
        return dx, None


def _conv(x, conv, stride=1, axis_name=None, compute_dtype=None):
    """3-D conv of an NCDHW tensor with "SAME" padding on the whole volume
    and an f32 output. With ``axis_name`` the sharded axis 2 is padded by
    the halo exchange instead of zeros (module doc); k = 1 takes none."""
    w = conv.weight
    k = w.shape[-1]
    if axis_name is None or k == 1:
        pads = _same_pads(x.shape[2:], k, stride)
    else:
        x = _ExchangeHalo.apply(x, axis_name)
        if stride == 1:
            pads = [1, 1, 1, 1, 0, 0]  # the haloed axis takes VALID
        else:
            x = x[:, :, 1:]
            pads = [0, 1, 0, 1, 0, 0]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    x = F.pad(x, pads)
    return F.conv3d(x, w, stride=stride).to(F32) + conv.bias[:, None, None, None]


def params_from_jax(params) -> dict:
    """The state dict of ``UNet3D`` from the JAX package's parameter dict
    ({name: {"w": (k, k, k, ci, co), "b": (co,)}}, as NumPy arrays)."""
    out = {}
    for name, p in params.items():
        w = np.asarray(p["w"], np.float32).transpose(4, 3, 0, 1, 2)
        out[f"{name}.weight"] = torch.from_numpy(w.copy())
        out[f"{name}.bias"] = torch.from_numpy(
            np.asarray(p["b"], np.float32).copy())
    return out


def loss_fn(model, feats, target_dt, anisotropy=(1.0, 1.0, 1.0),
            temperature=0.3, barrier=None, axis_name=None, compute_dtype=None,
            mesh_axes=None, *, kernels=soft.KERNELS):
    """MSE between the soft EDT of the predicted occupancy and target_dt.
    Sharded, ``mesh_axes`` (the process groups of the mesh's axes, e.g.
    (dp, sp)) makes the rank's sum of squared errors normalise by the
    global count; the caller sums the ranks' losses."""
    occ = torch.sigmoid(model(feats, axis_name, compute_dtype))
    d = soft._soft_edtsq_batch(occ, anisotropy, True, barrier, temperature,
                               axis_name, kernels=kernels)
    n = 1
    for group in mesh_axes or ():
        n *= dist.get_world_size(group)
    return torch.sum((d - target_dt) ** 2) / (d.numel() * n)


def make_train_step(model, optimizer, **kw):
    """One training step, ``step(feats, target) -> loss``, with ``loss_fn``'s
    keywords."""

    def step(feats, target_dt):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, feats, target_dt, **kw)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_sharded_train_step(model, mesh, optimizer,
                            anisotropy=(1.0, 1.0, 1.0), temperature=0.3,
                            barrier=None, dp_axis="dp", sp_axis="sp",
                            compute_dtype=None, *, kernels=soft.KERNELS):
    """Training step over a (dp, sp) ``DeviceMesh``, ``step(feats, target)
    -> loss``, every rank calling it: the batch over dp, X over sp (feats
    and target the whole batch on every rank, or DTensors placed
    (Shard(0), Shard(1)); ``parallel.train.batch_block``). The convs
    exchange halos over sp, the EDT rotates its sharded axis, and one
    ``all_reduce`` sums the gradients and the loss over the mesh;
    ``optimizer`` (over ``model.parameters()``) steps on every rank."""
    if barrier is None:
        raise ValueError("sharded training requires an explicit barrier")
    axes = (mesh.get_group(dp_axis), mesh.get_group(sp_axis))

    def local_loss(feats, target_dt):
        return loss_fn(model, train.batch_block(feats, mesh, dp_axis, sp_axis),
                       train.batch_block(target_dt, mesh, dp_axis, sp_axis),
                       anisotropy, temperature, barrier, axes[1],
                       compute_dtype, axes, kernels=kernels)

    return train.replicated_step(model, optimizer, local_loss,
                                 train.mesh_group(mesh))
