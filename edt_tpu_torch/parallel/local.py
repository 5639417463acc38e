"""The NumPy API's auto-sharding: one process over several cards.

Counterpart of the JAX package running ``edtsq_sharded_auto`` and
``edtsq_voxel_graph_sharded`` over ``default_mesh()`` inside one process,
as its NumPy API does for a large 3-D volume wherever one process
addresses more than one device. One PyTorch process addresses every
visible card (``cuda:0`` to ``cuda:n-1``), so one controller drives them
all: the slab sequence of ``parallel.sharded`` (``edtsq_slabs``: the
closed form along axis 2, K1 along axis 1, a rotation, K1 along axis 0,
the rotation back) runs on a list of slabs, one a card, and the rotation
is ``peer_exchange``, a copy of each block to its card (peer to peer over
NVLink where the cards have it). Padding and the crop are
``parallel.sharded``'s, so the result is bit-identical to one card's.

The host volume is cut into contiguous blocks of its axis 0, one a
card; each card permutes its block to the pass order, and where axis 0
is not the sharded axis an exchange re-cuts the slabs on the cards (a
strided cut of the host volume along another axis cost more host time
than the exchange costs the cards; ``PERF.md`` §5). The results come
back the same way, each card's block copied into its rows of one NumPy
array. Host copies block the calling thread (pageable memory), so each
card's copies run in a thread of their own; the passes and rotations are
launched from the caller's thread, with nothing in between that waits
for a card.

Internal machinery of ``api.edtsq`` and ``ops.voxel_graph``, not a public
API: the explicit sharded functions are ``parallel.sharded``'s. The tests
pass any list of devices, e.g. four ``cpu`` slabs.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from edt_tpu_torch.ops import minplus
from edt_tpu_torch.parallel import sharded


def _on_cards(fn, n):
    """[fn(0), ..., fn(n - 1)], each in a thread of its own, so that the
    cards' blocking host copies overlap; the first exception raises."""
    with ThreadPoolExecutor(n) as pool:
        return list(pool.map(fn, range(n)))


def peer_exchange(devices):
    """``sharded.edtsq_slabs``'s exchange over slabs on ``devices``: block
    j of slab i goes to card j (``.to``, which orders itself after both
    cards' streams and stages a strided block), and card j joins its
    blocks in slab order along the concat axis, as
    ``lax.all_to_all(tiled=True)`` orders them."""
    def exchange(slabs, split_axis, concat_axis):
        blocks = [s.tensor_split(len(slabs), split_axis) for s in slabs]
        return [torch.cat([b[j].to(dev, non_blocking=True) for b in blocks],
                          concat_axis)
                for j, dev in enumerate(devices)]
    return exchange


def _slab(host, r, c, device, black_border):
    """Rows [r c, (r + 1) c) of host axis 0, a contiguous block of the
    C-order volume, on ``device``, padded to c rows as ``sharded`` pads
    the whole volume (zeros under black_border, else its last plane)."""
    x = torch.from_numpy(host[r * c:(r + 1) * c]).to(device)
    edge = None
    if x.shape[0] < c and not black_border:
        edge = torch.from_numpy(host[-1:]).to(device)
    return sharded.pad_axis(x, 0, c, black_border, edge)


def _gather(slabs, shape):
    """One host array (f32, C order) of the volume's ``shape`` from the
    padded slabs of host axis 0, one a card: each cropped
    (``sharded.crop``) and copied into its rows, a contiguous block."""
    out = np.empty(shape, np.float32)
    dst = torch.from_numpy(out)
    c = slabs[0].shape[0]

    def one(r):
        part = sharded.crop(slabs[r], shape, r)
        dst[r * c:r * c + part.shape[0]].copy_(part)

    _on_cards(one, len(slabs))
    return out


def edtsq_sharded_local(labels, anisotropy, black_border=False, *,
                        devices, binary=False) -> np.ndarray:
    """Squared multi-label EDT of a 3-D NumPy volume over ``devices``, one
    slab a device, in ascending-pitch pass order (``sharded.pass_order``:
    the largest pitch is the sharded axis), any shape. Returns the C-order
    f32 result, bit-identical to ``compose.edtsq`` on one device.

    The host moves blocks of axis 0 (contiguous in a C-order volume; an
    F-order one is gathered on the host on the way): each card takes its
    rows, permutes them to the pass order, and where axis 0 is not the
    sharded axis one exchange re-cuts the slabs along the sharded axis
    (and one more cuts the result back). Host axis 0 is then padded to a
    multiple of the card count: a rotation axis, padded as ``sharded``
    pads it, or the middle axis, where the same fill is exact by the same
    argument (module doc of ``sharded``) and is cropped after.

    labels: int32, uint8 or float32 labels, 0 background (the API's
    ``_as_device_labels``); binary=True takes them as a foreground mask
    (no label rotation)."""
    n = len(devices)
    anis = np.asarray(anisotropy, np.float32).reshape(3)
    perm = sharded.pass_order(anis)
    k = perm.index(0)  # where host axis 0 lies in the pass order
    c = -(-labels.shape[0] // n)
    s = labels.shape[perm[0]]
    exchange = peer_exchange(devices)

    def one(r):
        x = _slab(labels, r, c, devices[r], black_border).permute(perm)
        if k:  # the sharded axis lies whole on every card: pad it, re-cut
            x = sharded.pad_axis(x, 0, -(-s // n) * n, black_border)
        return x

    slabs = _on_cards(one, n)
    if k:
        slabs = exchange(slabs, 0, k)
    slabs = [sharded._pad_rotation_axes(x, n, black_border, (2,))
             for x in slabs]
    out = sharded.edtsq_slabs(
        slabs, sharded._anisotropy(anis[list(perm)]), black_border,
        exchange, binary, None, minplus.make_parabolic_fn())
    if k:
        out = exchange(out, k, 0)
    inv = tuple(int(i) for i in np.argsort(perm))
    return _gather([o.permute(inv) for o in out], labels.shape)


def edtsq_voxel_graph_sharded_local(fg, graph, anisotropy,
                                    black_border=False, *,
                                    devices) -> np.ndarray:
    """Voxel-connectivity-graph squared EDT of a 3-D NumPy volume over
    ``devices``, any shape: each device doubles its own slab
    (``sharded.doubled_slab``), so the 8x doubled volume never exists
    whole on one card. fg: uint8 foreground mask; graph: uint8, the same
    shape, "x" the last axis. Returns the C-order f32 result."""
    n = len(devices)
    c = -(-fg.shape[0] // n)

    def one(r):
        f = _slab(fg, r, c, devices[r], black_border)
        g = _slab(graph, r, c, devices[r], black_border)
        return sharded.doubled_slab(f, g, fg.shape, r, n, black_border)

    d2 = sharded.edtsq_slabs(
        _on_cards(one, n), sharded.half_anisotropy(anisotropy),
        black_border, peer_exchange(devices), True, None,
        minplus.make_parabolic_fn())
    s2 = fg.shape[2]
    return _gather([d[::2, ::2, :2 * s2:2] for d in d2], fg.shape)
