"""The cells' volumes, made on the device from the seed as the
configuration's ``volume`` describes them, and the voxels the traffic
changes, drawn from the seed.

- ``blocks``: labels 0 .. values-1, one a block of block^3 voxels (the
  connectomics volume of the configuration's source, as the north-star
  step's generator makes it); one ``torch.Generator`` on the device, one
  draw of the block grid, expanded in place.
- ``ones``: every voxel foreground (the upstream white cube).

``uint32`` labels are held as int32, the same bits, as the program's own
API holds them on the card; ``bool`` stays bool.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"uint32": (torch.int32, 4), "bool": (torch.bool, 1)}


def seed_of(seed: int) -> int:
    """Any whole number as a non-negative 63-bit seed."""
    return int(seed) % (1 << 63)


def make(volume: dict, shape, seed: int, device, rank=0, world=1):
    """The volume of ``shape`` from the seed, or with ``world`` ranks the
    slab of axis 0 that rank ``rank`` holds (the same draws on every
    rank)."""
    dtype, _ = DTYPES[volume["dtype"]]
    c = shape[0] // world
    slab = (c,) + tuple(shape[1:])
    if volume["kind"] == "ones":
        return torch.ones(slab, dtype=dtype, device=device)
    if volume["kind"] != "blocks":
        raise ValueError(f"unknown volume kind {volume['kind']!r}")
    blk = int(volume["block"])
    g = torch.Generator(device=device).manual_seed(seed_of(seed))
    grid = tuple(-(-s // blk) for s in shape)
    v = torch.randint(0, int(volume["values"]), grid, generator=g,
                      device=device, dtype=torch.int32)
    lo = rank * c
    v = v[lo // blk:-(-(lo + c) // blk)]
    for ax in range(len(shape)):
        v = v.repeat_interleave(blk, dim=ax)
    v = v[(slice(lo % blk, lo % blk + c),)
          + tuple(slice(0, s) for s in shape[1:])].contiguous()
    return v.to(dtype)


def label_bytes(volume: dict) -> int:
    return DTYPES[volume["dtype"]][1]


def foreground_positions(vol: torch.Tensor, seed: int, count: int, rank=0):
    """``count`` flat indices of foreground (nonzero) voxels, drawn from the
    seed (and, past rank 0, the rank) with repeats allowed, as a host int64
    array."""
    rng = np.random.default_rng([seed_of(seed), 1] + ([rank] if rank else []))
    flat = vol.reshape(-1)
    got = []
    while sum(len(g) for g in got) < count:
        idx = rng.integers(0, flat.numel(), size=2 * count)
        keep = (flat[torch.from_numpy(idx).to(flat.device)] != 0).cpu().numpy()
        got.append(idx[keep])
        if not keep.any() and len(got) > 8:
            raise ValueError("the volume has no foreground to change")
    return np.concatenate(got)[:count]


def checked_calls(seed: int, count: int, first: int):
    """The calls whose answers are kept for the check: ``count - 1`` drawn
    from the seed among the first ``first`` calls of the window, and the
    window's last call (marked -1)."""
    rng = np.random.default_rng([seed_of(seed), 2])
    early = rng.choice(first, size=max(0, count - 1), replace=False)
    return sorted(int(k) for k in early) + [-1]
