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
``torch.backends.cudnn.allow_tf32`` is False. The halo exchange and the
sharded step are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from edt_tpu_torch.models import soft

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

    def forward(self, feats, compute_dtype=None):
        """Occupancy logits; feats (B, X, Y, Z, C) -> (B, X, Y, Z)."""
        levels = num_levels(self)
        act = lambda x: F.gelu(x, approximate="tanh")  # noqa: E731
        cv = lambda x, name, stride=1: _conv(  # noqa: E731
            x, getattr(self, name), stride, compute_dtype)
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


def _conv(x, conv, stride=1, compute_dtype=None):
    """3-D conv of an NCDHW tensor with "SAME" padding and an f32 output."""
    w = conv.weight
    k = w.shape[-1]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    x = F.pad(x, _same_pads(x.shape[2:], k, stride))
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
            temperature=0.3, barrier=None, compute_dtype=None,
            kernels=soft.KERNELS):
    """MSE between the soft EDT of the predicted occupancy and target_dt."""
    occ = torch.sigmoid(model(feats, compute_dtype=compute_dtype))
    d = soft._soft_edtsq_batch(occ, anisotropy, black_border=True,
                               barrier=barrier, temperature=temperature,
                               kernels=kernels)
    return torch.sum((d - target_dt) ** 2) / d.numel()


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
