"""Voxel-connectivity-graph EDT on torch tensors (counterpart of
``edt_tpu.ops.voxel_graph``).

The reference library's voxel-graph variant (``edt_voxel_graph.hpp``) as
tensor ops: each axis is upsampled 2x; even sites copy the foreground
mask; an odd site between two voxels along an axis is foreground only if
the *directed* graph lets travel go in the + direction along that axis
(bits 0b1 = +x, 0b100 = +y, 0b10000 = +z of the voxel's bitfield, the only
bits the reference consults). The binary EDT then runs on the doubled
volume at half the anisotropy, through K1 like any binary transform, and
the even sites are subsampled back, so a blocked edge sits half a voxel
away.

"x" is the fastest-varying axis of the input's memory order: the last
array axis for C order, the first for F order.
"""

from __future__ import annotations

import numpy as np
import torch

from edt_tpu_torch.ops import compose
from edt_tpu_torch.utils.profiling import counters

_X, _Y, _Z = 0, 2, 4  # bit shifts of the +x, +y, +z edges


def _doubled_2d(fg, g, black_border):
    """NumPy 2x upsample of a 2-D mask (the reference's site table)."""
    s0, s1 = fg.shape
    D = np.zeros((2 * s0, 2 * s1), dtype=np.uint8)
    D[0::2, 0::2] = fg
    D[0::2, 1::2] = fg & ((g >> _X) & 1)  # +x edges (x = last axis)
    D[1::2, 0::2] = fg & ((g >> _Y) & 1)  # +y edges
    D[1::2, 1::2] = fg
    if black_border:
        D[:, -1] = 0
        D[-1, :] = 0
    return D


def _doubled_3d(fg, g, black_border):
    """NumPy 2x upsample of a 3-D mask: odd sites with two or more odd
    coordinates copy the mask, those with one take that axis's edge bit."""
    s0, s1, s2 = fg.shape
    D = np.zeros((2 * s0, 2 * s1, 2 * s2), dtype=np.uint8)
    D[0::2, 0::2, 0::2] = fg
    D[0::2, 0::2, 1::2] = fg & ((g >> _X) & 1)  # +x edges (x = last axis)
    D[0::2, 1::2, 0::2] = fg & ((g >> _Y) & 1)  # +y edges
    D[1::2, 0::2, 0::2] = fg & ((g >> _Z) & 1)  # +z edges
    D[0::2, 1::2, 1::2] = fg
    D[1::2, 0::2, 1::2] = fg
    D[1::2, 1::2, 0::2] = fg
    D[1::2, 1::2, 1::2] = fg
    if black_border:
        D[:, :, -1] = 0
        D[:, -1, :] = 0
        D[-1, :, :] = 0
    return D


def doubled_2d_torch(fg, g, black_border):
    """Device-side 2-D 2x upsample (counterpart of ``doubled_2d_jnp``).

    fg: (s0, s1) foreground mask; g: same-shape uint8 graph. Returns the
    (2 s0, 2 s1) uint8 doubled mask on their device.
    """
    fg = fg.to(torch.uint8)
    s0, s1 = fg.shape
    D = torch.empty((2 * s0, 2 * s1), dtype=torch.uint8, device=fg.device)
    D[0::2, 0::2] = fg
    D[0::2, 1::2] = fg & ((g >> _X) & 1)
    D[1::2, 0::2] = fg & ((g >> _Y) & 1)
    D[1::2, 1::2] = fg
    if black_border:
        D[:, -1] = 0
        D[-1, :] = 0
    return D


def doubled_3d_torch(fg, g, black_border, zero_tail=(True, True, True)):
    """Device-side 3-D 2x upsample (counterpart of ``doubled_3d_jnp``).

    fg: (s0, s1, s2) foreground mask; g: same-shape uint8 graph.
    zero_tail: whether this block holds the volume's last plane along each
    axis (under slab sharding only the last shard zeroes its tail).
    """
    fg = fg.to(torch.uint8)
    s0, s1, s2 = fg.shape
    D = torch.empty((2 * s0, 2 * s1, 2 * s2), dtype=torch.uint8,
                    device=fg.device)
    D[0::2, 0::2, 0::2] = fg
    D[0::2, 0::2, 1::2] = fg & ((g >> _X) & 1)
    D[0::2, 1::2, 0::2] = fg & ((g >> _Y) & 1)
    D[1::2, 0::2, 0::2] = fg & ((g >> _Z) & 1)
    D[0::2, 1::2, 1::2] = fg
    D[1::2, 0::2, 1::2] = fg
    D[1::2, 1::2, 0::2] = fg
    D[1::2, 1::2, 1::2] = fg
    if black_border:
        if zero_tail[2]:
            D[:, :, -1] = 0
        if zero_tail[1]:
            D[:, -1, :] = 0
        if zero_tail[0]:
            D[-1, :, :] = 0
    return D


def _edtsq_doubled(fg, graph, half_anisotropy, black_border):
    """Doubling, binary EDT at half pitch with the default axis order, and
    the even-site subsample, all on fg's device."""
    double = doubled_2d_torch if fg.dim() == 2 else doubled_3d_torch
    D = double(fg, graph, black_border)
    d2 = compose.edtsq(D, half_anisotropy, black_border, binary=True)
    return d2[(slice(0, None, 2),) * fg.dim()]


def edtsq_voxel_graph_torch(labels, graph, anisotropy, black_border=False):
    """Device-native 3-D voxel-graph squared EDT on torch tensors
    (counterpart of ``edtsq_voxel_graph_jnp``); runs on ``labels``'s device.

    "x" (bit 0b1) is the last array axis (C-order convention). Float labels
    are foreground where > 0, others where != 0. For the NumPy-facing,
    order-aware form use ``edtsq_voxel_graph``.
    """
    if labels.dim() != 3:
        raise ValueError(
            "edtsq_voxel_graph_torch is 3-D; use the NumPy API for 2-D")
    fg = labels > 0 if labels.is_floating_point() else labels != 0
    half = [float(np.float32(a) / np.float32(2.0))
            for a in np.asarray(anisotropy, np.float32).reshape(3)]
    return _edtsq_doubled(fg, graph.to(torch.uint8), half, black_border)


def edtsq_voxel_graph(data, graph, anisotropy, black_border, arr_order,
                      device):
    """Squared EDT of a 2-D or 3-D NumPy volume constrained by a directed
    voxel connectivity graph; computed on ``device`` (the API's argument:
    None is CUDA), returned as NumPy.

    Only the original-size mask and graph go to the device, and only the
    original-size result comes back: the doubled volume stays there. A 3-D
    volume whose doubled size reaches the API's auto-shard threshold
    shards over every card where there are several (``api._shard_devices``,
    ``parallel.local``): each card doubles its own slab, so the 8x volume
    never exists whole on one card.
    """
    from edt_tpu_torch import api

    dev = api._device(device)
    data = np.asarray(data)
    graph = np.asarray(graph)
    if graph.shape != data.shape:
        raise ValueError(
            f"voxel_graph shape {graph.shape} must match data shape "
            f"{data.shape}")
    if graph.dtype == np.int8:
        graph = graph.view(np.uint8)
    elif graph.dtype != np.uint8:
        graph = graph.astype(np.uint8)  # only the low 6 bits are consulted

    nd = data.ndim
    anisotropy = np.asarray(anisotropy, dtype=np.float32).reshape(nd)

    # Canonicalize so "x" (bit 0b1) is the last axis.
    if arr_order == "F":
        perm = tuple(range(nd - 1, -1, -1))
        data = np.transpose(data, perm)
        graph = np.transpose(graph, perm)
        anisotropy = anisotropy[::-1]

    # The reference's foreground test is labels > 0 on the raw values;
    # its Cython layer reads signed integers as unsigned, so only floats
    # can be negative, and negative floats are background.
    if np.issubdtype(data.dtype, np.floating):
        fg = (data > 0).astype(np.uint8)
    else:
        fg = (data != 0).astype(np.uint8)

    # the doubled volume holds 8x the voxels: the gate is on its size
    cards = (api._shard_devices(device)
             if nd == 3 and data.size * 8 >= api._shard_min_voxels() else None)
    if cards:
        from edt_tpu_torch.parallel import local

        counters.sharded_dispatches += 1
        sub = local.edtsq_voxel_graph_sharded_local(
            np.ascontiguousarray(fg), np.ascontiguousarray(graph),
            anisotropy, bool(black_border), devices=cards)
    else:
        half = [float(a) for a in anisotropy / np.float32(2.0)]
        out = _edtsq_doubled(
            torch.from_numpy(np.ascontiguousarray(fg)).to(dev),
            torch.from_numpy(np.ascontiguousarray(graph)).to(dev),
            half, bool(black_border))
        sub = out.contiguous().cpu().numpy()

    if arr_order == "F":
        # transposed view; api.edtsq makes the F-order copy
        return np.transpose(sub, perm)
    return sub
