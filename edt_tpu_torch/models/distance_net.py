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
arrays, to the module's state dict. The sharded steps are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from edt_tpu_torch import api
from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import compose

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
            barrier=None, kernels=soft.KERNELS):
    """Predicted squared distance field of a batch (B, X, Y, Z, C) of
    feature volumes, (B, X, Y, Z)."""
    occ = torch.sigmoid(model(feats))
    return soft._soft_edtsq_batch(occ, anisotropy, black_border=True,
                                  barrier=barrier, temperature=temperature,
                                  kernels=kernels)


def loss_fn(model, feats, target_dt, anisotropy=(1.0, 1.0, 1.0),
            temperature=0.3, barrier=None, kernels=soft.KERNELS):
    d = forward(model, feats, anisotropy, temperature, barrier, kernels)
    return torch.mean((d - target_dt) ** 2)


def make_train_step(model, optimizer, anisotropy=(1.0, 1.0, 1.0),
                    temperature=0.3, barrier=None, kernels=soft.KERNELS):
    """One training step, ``step(feats, target) -> loss``: the loss, its
    gradient, and one update of ``optimizer`` (``optax.adam(lr)`` is
    ``torch.optim.Adam(params, lr, betas=(0.9, 0.999), eps=1e-8)``)."""

    def step(feats, target_dt):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, feats, target_dt, anisotropy, temperature,
                       barrier, kernels)
        loss.backward()
        optimizer.step()
        return loss.detach()

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
