"""The plain reference that decides ``correct``: the transforms the cells
drive, written out in straightforward PyTorch. It imports torch and numpy
only, nothing of the program, and takes nothing the program made: it works
the segments, walls and costs out again from the labels and occupancy.

Semantics (those of the upstream ``edt`` library, which the program
states):

- Multi-label squared EDT: label 0 is background, at distance 0. Along
  each axis the edge of a run of one label is a wall one voxel pitch
  beyond the run's end voxel; with ``black_border`` so is the volume's
  edge, without it an edge run is open. The first pass is the closed form
  (the distance to the run's nearer end); every later pass is the min-plus
  d(i) = min_j f(j) + w^2 (i - j)^2 over the whole row, then the min with
  the walls, background pinned to 0.
- The differentiable loss (the cells' ``loss`` loop): heights h = barrier
  * occupancy; one min-plus pass per axis in ascending pitch, the later
  axis first on ties; each pass clamped by the walls of its labels' runs,
  ties to the candidate; among candidates of equal cost the leftmost
  wins. The forward is 0 at background labels; the gradient of its sum
  w.r.t. the occupancy routes each voxel's cotangent back through the
  winner of every pass, and a wall win routes nothing.

Every value is formed with the f32 operations in the order the program
documents, so that a sound program agrees bit for bit: a candidate k
voxels away costs f + (k * k) * w2 with two roundings, the first pass is
(k * w)^2, a compose-path wall (k * k) * w2, a loss-path wall (c * w2) * c,
and w2 = w * w rounded to f32. The same functions run in another
``dtype`` (bfloat16) as the control that has to come out as not correct.

The min-plus is the brute-force O(n^2) one a row, in blocks of rows so
that the (rows, n, n) cost tensor stays under ``block_bytes``. With a
``group`` (``torch.distributed``), each rank holds its slab of axis 0 and
the axis-0 pass runs on whole columns after a plain all-to-all that
splits axis 2 over the ranks, and back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

F32 = torch.float32
INF = float("inf")


def f32(x) -> float:
    """x rounded to float32, as a Python float (enters f32 ops exactly)."""
    return float(np.float32(x))


def w2_of(w) -> float:
    """The squared pitch in f32: fl(fl(w) * fl(w))."""
    w = np.float32(w)
    return float(np.float32(w * w))


def runs(lab):
    """(li, ri, open_l, open_r) along the last axis of (R, n) labels: the
    distance in voxels from each voxel to the wall beyond its run's start
    (li = i - start + 1) and end (ri = end - i), and whether that side is
    the volume's edge."""
    R, n = lab.shape
    idx = torch.arange(n, device=lab.device)
    brk = torch.ones((R, n + 1), dtype=torch.bool, device=lab.device)
    brk[:, 1:n] = lab[:, 1:] != lab[:, :-1]
    # start(i): last break at or before i; end(i): first break after i
    start = torch.where(brk[:, :n], idx, 0).cummax(dim=1).values
    pos = torch.arange(1, n + 1, device=lab.device)
    end = torch.where(brk[:, 1:], pos, n + 1).flip(1).cummin(dim=1).values.flip(1)
    return idx - start + 1, end - idx, start == 0, end == n


def minplus(f, w2, want_arg=False, block_bytes=1 << 30):
    """d[r, i] = min_j f[r, j] + (k * k) * w2, k = i - j, in f's dtype;
    with ``want_arg`` also the leftmost j attaining it (int32)."""
    R, n = f.shape
    k = torch.arange(n, device=f.device).to(f.dtype)
    diff = k[:, None] - k[None, :]
    quad = (diff * diff) * w2  # (targets, sources)
    d = torch.empty_like(f)
    arg = torch.empty((R, n), dtype=torch.int32, device=f.device) if want_arg else None
    rows = max(1, block_bytes // (n * n * f.element_size()))
    for r0 in range(0, R, rows):
        cost = f[r0:r0 + rows, None, :] + quad
        v, a = cost.min(dim=-1)  # the first index on ties
        d[r0:r0 + rows] = v
        if want_arg:
            arg[r0:r0 + rows] = a.to(torch.int32)
        del cost, v, a
    return d, arg


def _rows(t, ax):
    """t with ``ax`` moved last, as (rows, n), and the moved shape."""
    m = t.movedim(ax, -1).contiguous()
    return m.reshape(-1, m.shape[-1]), m.shape


def _back(rows, shape, ax):
    return rows.reshape(shape).movedim(-1, ax)


def edtsq(labels, anisotropy, black_border=False, binary=False, dtype=F32,
          block_bytes=1 << 30):
    """The squared EDT of ``compose.edtsq``'s contract, in ``dtype``: the
    closed form along the last axis, then the min-plus along the others
    from the last to the first. ``binary``: a two-valued volume; the
    later passes' walls are then the row's edges alone (background voxels
    are sources of their own)."""
    nd = labels.dim()
    if len(anisotropy) != nd:
        raise ValueError(f"anisotropy must have {nd} components")
    order = tuple(range(nd - 1, -1, -1))
    lab, shape = _rows(labels, order[0])
    li, ri, ol, orr = runs(lab)
    w = f32(anisotropy[order[0]])
    dl = li.to(dtype) * w
    dr = ri.to(dtype) * w
    if not black_border:
        dl = torch.where(ol, INF, dl)
        dr = torch.where(orr, INF, dr)
    d = torch.where(lab == 0, 0.0, torch.minimum(dl, dr)).to(dtype)
    f = _back(d * d, shape, order[0])
    for ax in order[1:]:
        rows, shape = _rows(f, ax)
        lab, _ = _rows(labels, ax)
        n = rows.shape[1]
        w2 = w2_of(anisotropy[ax])
        d, _ = minplus(rows, w2, block_bytes=block_bytes)
        if binary:
            if black_border:
                idx = torch.arange(n, device=d.device)
                li, ri = (idx + 1).to(dtype), (n - idx).to(dtype)
                d = torch.minimum(d, torch.minimum(li * li, ri * ri) * w2)
        else:
            li, ri, ol, orr = runs(lab)
            li, ri = li.to(dtype), ri.to(dtype)
            lw, rw = (li * li) * w2, (ri * ri) * w2
            if not black_border:
                lw = torch.where(ol, INF, lw)
                rw = torch.where(orr, INF, rw)
            d = torch.minimum(d, torch.minimum(lw, rw))
            d = torch.where(lab == 0, 0.0, d).to(dtype)
        f = _back(d, shape, ax)
    return f


def exchange(t, group, split_axis, concat_axis):
    """Split ``split_axis`` into one block a rank, send block j to rank j,
    and join the blocks received along ``concat_axis`` in rank order."""
    n = dist.get_world_size(group)
    send = torch.stack(t.chunk(n, dim=split_axis))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv.view(-1).view(torch.uint8),
                           send.view(-1).view(torch.uint8), group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def pass_order(anisotropy):
    """Ascending pitch, the later axis first on ties."""
    return sorted(range(len(anisotropy)),
                  key=lambda a: (f32(anisotropy[a]), -a))


def loss_forward_grad(labels, occupancy, anisotropy, black_border, barrier,
                      dtype=F32, block_bytes=1 << 30, group=None):
    """(out, grad): the wall-faithful multi-label squared EDT of the
    heights barrier * occupancy, and the gradient of out.sum() w.r.t. the
    occupancy, in ``dtype``; with ``group``, of this rank's slab."""
    b = f32(barrier)
    f = occupancy.to(dtype) * b
    saved = []
    for ax in pass_order(anisotropy):
        rot = group is not None and ax == 0
        lab = exchange(labels, group, 2, 0) if rot else labels
        if rot:
            f = exchange(f, group, 2, 0)
        rows, shape = _rows(f, ax)
        lab, _ = _rows(lab, ax)
        w2 = w2_of(anisotropy[ax])
        d, arg = minplus(rows, w2, want_arg=True, block_bytes=block_bytes)
        li, ri, ol, orr = runs(lab)
        li, ri = li.to(dtype), ri.to(dtype)
        if not black_border:
            li = torch.where(ol, INF, li)
            ri = torch.where(orr, INF, ri)
        c = torch.minimum(li, ri)
        walls = (c * w2) * c
        won = d <= walls  # ties to the candidate
        d = torch.where(won, d, walls)
        saved.append((ax, shape, arg, won, rot))
        f = _back(d, shape, ax)
        if rot:
            f = exchange(f, group, 0, 2)
    out = torch.where(labels == 0, 0.0, f).to(dtype)
    g = (labels != 0).to(dtype)
    for ax, shape, arg, won, rot in reversed(saved):
        if rot:
            g = exchange(g, group, 2, 0)
        rows, _ = _rows(g, ax)
        live = torch.where(won, rows, 0.0).to(dtype)
        g = _back(torch.zeros_like(rows).scatter_add_(1, arg.long(), live),
                  shape, ax)
        if rot:
            g = exchange(g, group, 0, 2)
    return out, g * b
