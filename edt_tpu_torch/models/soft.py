"""Differentiable squared Euclidean distance transforms (counterpart of
``edt_tpu.models.soft``).

The transform is posed on a continuous height field h:

    d(x) = min_v ( h(v) + sum_k w_k^2 (x_k - v_k)^2 )

with h = 0 at sources and h = barrier * occupancy elsewhere, one 1-D
min-plus pass per axis. At temperature 0 each pass is a hard min whose
``torch.autograd.Function`` keeps only the narrow argmin link offsets for
the backward (O(voxels) residuals), and routes each cotangent to the
winning source:

- a general pass runs K2 (``ops.argmin``) forward and K3 (``ops.grad``)
  backward;
- the first pass over a two-valued field (``binary_heights``) runs the
  closed form of nearest-zero scans forward and K4 backward.

At temperature t > 0 each pass is the softmin -t log sum_j exp(-cost/t),
smooth everywhere: K5 (``ops.softmin``) forward, keeping (f, d), and K6
backward, which recomputes the softmax weights from them. Walls (black
borders, label boundaries) blend in with -t logaddexp(-d/t, -walls/t), and
``binary_heights`` has no effect.

``axis_name``, a ``torch.distributed`` process group, makes the input a
rank's slab of a 3-D volume sharded along axis 0 over that group (every
rank calls the function, as under the JAX package's ``shard_map``): the
axis-0 pass, at its own place in the ascending-pitch order, runs between
two rotations (``parallel.sharded.rotate``, whose gradient is the reverse
rotation), so sharded and single-card passes compose identically. Every
rank's slab has the same shape, with axis 2 a multiple of the rank count.

``multilabel_edtsq`` is the wall-faithful multi-label form: labels define
the label-boundary walls (integer wall counts, clamped in with ties to the
candidate at t = 0), and its forward at t = 0 equals the hard ``edtsq``
where that is finite. At t = 0 every forward value is bit-identical to the
JAX package and the gradients agree up to the order of their sums; at
t > 0 both agree to f32 round-off.

Entry points take torch tensors, which stay on their device, or NumPy
arrays, which go to ``device=`` (default CUDA; with no card and no
``device=`` the call raises). ``kernels=PLAIN`` runs the same transform
through the kernels' plain versions on any device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from edt_tpu_torch import api
from edt_tpu_torch.ops import argmin, bounds, core, grad
from edt_tpu_torch.ops import softmin as soft_ops
from edt_tpu_torch.parallel.sharded import all_to_all, rotate
from edt_tpu_torch.utils import profiling

F32 = torch.float32
INF = float("inf")


class Kernels(NamedTuple):
    """The kernels the passes call: at t = 0 K2 forward, K3 and K4
    backward; at t > 0 K5 forward, K6 backward. The defaults are the
    kernels' ``torch.library`` custom ops (``edt_tpu_torch::minplus_argmin``
    and so on: the kernel on CUDA tensors, the plain version on CPU
    tensors), so that ``torch.export`` records every pass of a forward and
    of its gradient as op nodes."""

    forward: Callable = torch.ops.edt_tpu_torch.minplus_argmin  # K2
    gather: Callable = torch.ops.edt_tpu_torch.minplus_grad  # K3
    scan: Callable = torch.ops.edt_tpu_torch.binary_grad_scan  # K4
    softmin: Callable = torch.ops.edt_tpu_torch.softmin  # K5
    softmin_grad: Callable = torch.ops.edt_tpu_torch.softmin_grad  # K6


KERNELS = Kernels()
PLAIN = Kernels(argmin.minplus_argmin_plain, grad.minplus_grad_plain,
                grad.binary_grad_scan_plain, soft_ops.softmin_plain,
                soft_ops.softmin_grad_plain)


def _soft(temperature) -> bool:
    return bool(temperature) and temperature > 0.0


# ---------------- devices and inputs ----------------


def _resolve_device(inputs, device) -> torch.device:
    """The device of the call: that of its torch tensors, which must agree
    with each other and with ``device=``; else ``device=`` (default CUDA,
    raising without a card)."""
    devs = {t.device for t in inputs if isinstance(t, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"inputs lie on more than one device: "
                         f"{sorted(str(d) for d in devs)}")
    if not devs:
        return api._device(device)
    (dev,) = devs
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"device={want} but the inputs lie on {dev}")
    return dev


def _from_numpy(a, device):
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _as_tensor(x, device):
    return x if isinstance(x, torch.Tensor) else _from_numpy(x, device)


def _labels_tensor(labels, device):
    if isinstance(labels, torch.Tensor):
        return labels
    return _from_numpy(api._as_device_labels(np.asarray(labels)), device)


def _heights(barrier, occupancy):
    b = barrier.to(F32) if isinstance(barrier, torch.Tensor) else core.f32(barrier)
    return b * occupancy.to(F32)


# ---------------- hard min with argmin-residual VJP ----------------


def _minplus_hard_binary_with_arg(f, w2):
    """Closed-form (d, argj) for a two-valued height row f in {0, B}.

    The winner is the nearest zero on either side (cost w2 k^2) or the
    voxel itself at height B; every other candidate is dominated. Ties go
    to the left zero, then self, then the right zero: the leftmost j.
    int16 scans where positions fit.
    """
    R, n = f.shape
    idt = torch.int16 if n <= argmin.I16_MAX_AXIS else torch.int32
    idx = torch.arange(n, dtype=idt, device=f.device)
    zero = f <= 0.0
    pz = torch.where(zero, idx, -1).cummax(dim=1).values
    nz = torch.where(zero, idx, n).flip(1).cummin(dim=1).values.flip(1)
    kl = (idx - pz).to(F32)
    kr = (nz - idx).to(F32)
    dl = torch.where(pz >= 0, w2 * (kl * kl), INF)
    dr = torch.where(nz < n, w2 * (kr * kr), INF)
    d = torch.minimum(torch.minimum(dl, f), dr)
    argj = torch.where(dl == d, pz, torch.where(f == d, idx, nz))
    return d, argj.to(torch.int32)


def _binary_offsets(f, argj, win=None):
    """Link residual of the closed form: argj - i in the narrow dtype, the
    dtype min at wall wins (``win`` False), the dtype max at zero sites
    (the scan backward's segment marks; real links |o| < n reach
    neither)."""
    n = f.shape[1]
    idt = argmin.link_dtype(n)
    o = (argj - torch.arange(n, dtype=torch.int32, device=f.device)).to(idt)
    if win is not None:
        o = torch.where(win, o, torch.iinfo(idt).min)
    return torch.where(f <= 0.0, torch.iinfo(idt).max, o)


# w2 is a Python float in every pass: each public caller turns anisotropy
# into a NumPy constant, so no gradient flows to it and the backwards
# return None for it (and for the integer wall counts). The JAX package's
# dw2 term is dead code for the same callers.


class _MinplusHard(torch.autograd.Function):
    """Hard min-plus with the argmin-offset residual (the JAX package's
    ``_make_minplus_hard``): K2 + K3, or the closed form + K4 when
    ``binary_heights``."""

    @staticmethod
    def forward(ctx, f, w2, binary_heights, kernels):
        ctx.span = profiling.current()
        if binary_heights:
            with profiling.span("edt_tpu_torch.first_pass", f):
                d, argj = _minplus_hard_binary_with_arg(f, w2)
                o = _binary_offsets(f, argj)
        else:
            with profiling.span("edt_tpu_torch.kernel", f, kernel="K2"):
                d, o = kernels.forward(f, w2, emit_offsets=True)
        ctx.save_for_backward(o)
        ctx.binary_heights = binary_heights
        ctx.kernels = kernels
        return d

    @staticmethod
    def backward(ctx, g):
        (o,) = ctx.saved_tensors
        with profiling.span("edt_tpu_torch.backward", g, ctx.span):
            (g,) = profiling.contiguous(g)
            if ctx.binary_heights:
                with profiling.span("edt_tpu_torch.kernel", g, kernel="K4"):
                    df = ctx.kernels.scan(g, o)
            else:
                with profiling.span("edt_tpu_torch.kernel", g, kernel="K3"):
                    df = ctx.kernels.gather(g, offsets=o)
        return df, None, None, None


class _MinplusHardWalled(torch.autograd.Function):
    """Hard min-plus fused with the wall clamp (the JAX package's
    ``_make_minplus_hard_walled``): out = where(d <= walls, d, walls), ties
    to the candidate. Wall-won voxels carry the inert link marker, so the
    backward routes nothing from them."""

    @staticmethod
    def forward(ctx, f, w2, cnt, binary_heights, kernels):
        ctx.span = profiling.current()
        if binary_heights:
            with profiling.span("edt_tpu_torch.first_pass", f):
                walls = argmin.walls_from_counts(cnt, w2)
                d, argj = _minplus_hard_binary_with_arg(f, w2)
                win = d <= walls
                out = torch.where(win, d, walls)
                o = _binary_offsets(f, argj, win)
        else:
            with profiling.span("edt_tpu_torch.kernel", f, kernel="K2"):
                out, o = kernels.forward(f, w2, walls=cnt, emit_offsets=True)
        ctx.save_for_backward(o)
        ctx.binary_heights = binary_heights
        ctx.kernels = kernels
        return out

    @staticmethod
    def backward(ctx, g):
        (o,) = ctx.saved_tensors
        sent = torch.iinfo(o.dtype).min
        with profiling.span("edt_tpu_torch.backward", g, ctx.span):
            (g,) = profiling.contiguous(g)
            if ctx.binary_heights:
                with profiling.span("edt_tpu_torch.kernel", g, kernel="K4"):
                    df = ctx.kernels.scan(g, o, off_sent=sent)
            else:
                with profiling.span("edt_tpu_torch.kernel", g, kernel="K3"):
                    df = ctx.kernels.gather(g, offsets=o, off_sent=sent)
        return df, None, None, None, None


class _MinplusSoft(torch.autograd.Function):
    """Softmin-plus at temperature t > 0 with O(rows * n) residuals (the
    JAX package's ``_make_minplus_soft``): K5 forward keeps (f, d), K6
    backward recomputes the softmax weights from them."""

    @staticmethod
    def forward(ctx, f, w2, t, kernels):
        ctx.span = profiling.current()
        with profiling.span("edt_tpu_torch.kernel", f, kernel="K5"):
            d = kernels.softmin(f, w2, t)
        # d.detach(): an output saved as it is leaves a fake tensor among a
        # non-strict torch.export's constants
        ctx.save_for_backward(f, d.detach())
        ctx.w2, ctx.t, ctx.kernels = w2, t, kernels
        return d

    @staticmethod
    def backward(ctx, g):
        f, d = ctx.saved_tensors
        with profiling.span("edt_tpu_torch.backward", g, ctx.span):
            (g,) = profiling.contiguous(g)
            with profiling.span("edt_tpu_torch.kernel", g, kernel="K6"):
                df, _ = ctx.kernels.softmin_grad(f, d, g, ctx.w2, ctx.t)
        return df, None, None, None


def _blend_walls(d, walls, temperature):
    """The soft wall clamp: -t logaddexp(-d/t, -walls/t)."""
    t = core.f32(temperature)
    return -t * torch.logaddexp(-d / t, -walls / t)


# ---------------- passes and composition ----------------


def _pass_order(anis):
    """Ascending pitch, the later axis first on ties."""
    return sorted(range(anis.size), key=lambda a: (float(anis[a]), -a))


def _soft_pass(f, w, black_border, temperature=0.0, binary_heights=False,
               kernels=KERNELS):
    """One differentiable min-plus pass along the last axis of f."""
    n = f.shape[-1]
    if f.numel() == 0:
        return f
    w = core.f32(w)
    w2 = core.f32(w * w)
    f2 = f.reshape(-1, n)
    if _soft(temperature):
        d = _MinplusSoft.apply(f2, w2, core.f32(temperature), kernels)
    else:
        d = _MinplusHard.apply(f2, w2, bool(binary_heights), kernels)
    d = d.reshape(f.shape)
    if not black_border:
        return d
    with profiling.span("edt_tpu_torch.mask", f):
        idx = torch.arange(n, dtype=F32, device=f.device)
        lo = idx + 1.0
        hi = n - idx
        walls = torch.minimum(w2 * (lo * lo), w2 * (hi * hi))
        if _soft(temperature):
            return _blend_walls(d, walls, temperature)
        # ties go to the min-plus candidate, so a source exactly at the
        # wall distance keeps its gradient
        return torch.where(d <= walls, d, walls)


def _pass_kind(temperature, first_closed_form):
    if _soft(temperature):
        return "K5"
    return "closed_form" if first_closed_form else "K2"


def _passes(f, anis, black_border, temperature, binary_heights, kernels,
            lead=0, axis_name=None):
    """The passes of ``edtsq_from_heights`` over the axes after the first
    ``lead`` of f, in ascending-pitch order; the leading axes ride in the
    rows of every pass. With ``axis_name`` the spatial axis-0 pass runs
    rotated: spatial axis 2 (axis 2 + lead of f) split over the ranks,
    spatial axis 0 gathered whole. Its root span is
    ``edt_tpu_torch.multilabel_edtsq``'s, for every differentiable
    transform."""
    with profiling.span("edt_tpu_torch.multilabel_edtsq", f, shape=f.shape,
                        temperature=temperature,
                        sharded=axis_name is not None):
        for step, ax in enumerate(_pass_order(anis)):
            a = ax + lead
            rotated = axis_name is not None and ax == 0
            first = binary_heights and step == 0
            if rotated:
                f = rotate(f, axis_name, 2 + lead, lead)
            with profiling.pass_span(f, a, _pass_kind(temperature, first)):
                (fa,) = profiling.contiguous(f.movedim(a, -1))
                f = _soft_pass(fa, float(anis[ax]), black_border,
                               temperature, binary_heights=first,
                               kernels=kernels).movedim(-1, a)
            if rotated:
                f = rotate(f, axis_name, lead, 2 + lead)
    return f


def _check_axis_name(axis_name, nd):
    """``axis_name`` is None (one device) or the process group over which
    axis 0 of a 3-D volume is sharded."""
    if axis_name is None:
        return
    if nd != 3:
        raise ValueError("sharded soft EDT requires a 3-D volume")
    if not isinstance(axis_name, dist.ProcessGroup):
        raise TypeError(f"axis_name must be a torch.distributed ProcessGroup "
                        f"(e.g. mesh.get_group('sp')), got {axis_name!r}")


def edtsq_from_heights(h, anisotropy, black_border=False, temperature=0.0,
                       axis_name=None, binary_heights=False, *, device=None,
                       kernels=KERNELS):
    """Differentiable squared EDT of a height field (N-D, separable).

    h: heights, 0 at sources and +barrier at solid foreground. Returns the
    squared distances with dd/dh defined everywhere (a subgradient at
    ties at temperature 0). temperature > 0 runs the softmin passes.
    binary_heights: the caller's promise that h takes exactly two values
    {0, B}; at temperature 0 the first pass then runs the closed form with
    the same values, argmins and gradients (silently wrong otherwise).
    axis_name: None, or the process group over which axis 0 is sharded,
    h then being this rank's slab (module doc).
    """
    f = _as_tensor(h, _resolve_device([h], device)).to(F32)
    _check_axis_name(axis_name, f.dim())
    anis = np.asarray(anisotropy, np.float32).reshape(f.dim())
    return _passes(f, anis, black_border, temperature, binary_heights,
                   kernels, axis_name=axis_name)


def default_barrier(shape, anisotropy) -> float:
    """A height above any squared distance the volume can hold:
    4 sum_k (w_k s_k)^2, in f32."""
    ws = (np.asarray(anisotropy, np.float32).reshape(len(shape))
          * np.asarray(shape, np.float32))
    total = np.float32(0.0)
    for v in ws * ws:
        total = np.float32(total + v)
    return float(total * np.float32(4.0))


def soft_edtsq(occupancy, anisotropy, black_border=False, barrier=None,
               temperature=0.0, axis_name=None, binary_occupancy=False, *,
               device=None, kernels=KERNELS):
    """Squared EDT of a soft occupancy map (1 = foreground, 0 =
    background), differentiable w.r.t. occupancy. binary_occupancy
    promises values in {0, 1}: at temperature 0 the first pass then runs
    the closed form. axis_name as in ``edtsq_from_heights``; the default
    barrier then comes from the slab's shape, as in the JAX package."""
    dev = _resolve_device([occupancy, barrier], device)
    occ = _as_tensor(occupancy, dev)
    if barrier is None:
        barrier = default_barrier(tuple(occ.shape), anisotropy)
    return edtsq_from_heights(_heights(barrier, occ), anisotropy,
                              black_border, temperature, axis_name,
                              binary_occupancy, kernels=kernels)


def _soft_edtsq_batch(occupancy, anisotropy, black_border=False,
                      barrier=None, temperature=0.0, axis_name=None, *,
                      kernels=KERNELS):
    """``soft_edtsq`` of every volume of a (B, *spatial) tensor, as
    ``jax.vmap(soft_edtsq(..., axis_name=...))`` runs it in the trainers:
    the batch rides in the rows of every pass (one launch a pass), the
    passes run along the spatial axes only, and the default barrier comes
    from the spatial shape. axis_name: None, or the process group over
    which spatial axis 0 is sharded, each volume then this rank's slab
    (spatial axis 2 must split over its ranks, or the rotation raises
    ValueError, as JAX's ``all_to_all`` requires)."""
    spatial = tuple(occupancy.shape[1:])
    _check_axis_name(axis_name, len(spatial))
    anis = np.asarray(anisotropy, np.float32).reshape(len(spatial))
    if barrier is None:
        barrier = default_barrier(spatial, anis)
    return _passes(_heights(barrier, occupancy), anis, black_border,
                   temperature, False, kernels, lead=1, axis_name=axis_name)


def soft_sdfsq(occupancy, anisotropy, black_border=False, barrier=None,
               temperature=0.0, axis_name=None, *, device=None,
               kernels=KERNELS):
    """Differentiable signed squared distance: d(occ) - d(1 - occ).
    axis_name as in ``edtsq_from_heights``."""
    dev = _resolve_device([occupancy, barrier], device)
    occ = _as_tensor(occupancy, dev)
    fg = soft_edtsq(occ, anisotropy, black_border, barrier, temperature,
                    axis_name, kernels=kernels)
    bg = soft_edtsq(1.0 - occ.to(F32), anisotropy, black_border, barrier,
                    temperature, axis_name, kernels=kernels)
    return fg - bg


# ---------------- wall-faithful multi-label EDT ----------------


def _wall_counts(labels, axis, black_border):
    """Distance in voxels to the nearest label-boundary wall along
    ``axis``, in labels' own layout: min(i - start + 1, end - i), int16
    when the axis fits, the sentinel at an open side (a run touching the
    volume edge without ``black_border``). CUDA tensors take the kernel
    through its custom op, CPU tensors the plain version (``ops.bounds``).
    """
    n = labels.shape[axis]
    card = labels.device.type == "cuda"
    with profiling.span("edt_tpu_torch.bounds", labels, axis=axis, n=n,
                        impl="kernel" if card else "plain"):
        if card:
            return torch.ops.edt_tpu_torch.wall_counts(labels, axis,
                                                       bool(black_border))
        return bounds.wall_counts_plain(labels, axis, black_border)


def wall_counts_for(labels, black_border=False, axis_name=None, *,
                    device=None):
    """multilabel_edtsq's label analysis for a FIXED label volume: the wall
    counts of every axis (a tuple, each in the volume's own layout), to
    pass as ``wall_counts=`` when labels stay the same across calls.

    axis_name: None, or the process group over which axis 0 is sharded
    (labels then this rank's slab, as in multilabel_edtsq): the axis-0
    scan runs on whole rows in the rotated layout (a slab's own scan would
    plant walls at its edges) and its counts are rotated back."""
    lab = _labels_tensor(labels, _resolve_device([labels], device))
    _check_axis_name(axis_name, lab.dim())
    out = []
    for ax in range(lab.dim()):
        if axis_name is not None and ax == 0:
            c = _wall_counts(all_to_all(lab, axis_name, 2, 0), 0, black_border)
            out.append(all_to_all(c, axis_name, 0, 2))
        else:
            out.append(_wall_counts(lab, ax, black_border))
    return tuple(out)


def _multilabel_pass(f, wall_cnt_ax, w, temperature=0.0, binary_heights=False,
                     kernels=KERNELS):
    """One differentiable multi-label min-plus pass along the last axis.
    The borders are all in the wall counts (black_border edges are walls
    in ``_wall_counts``)."""
    n = f.shape[-1]
    if f.numel() == 0:
        return f
    w = core.f32(w)
    w2 = core.f32(w * w)
    if _soft(temperature):
        d = _MinplusSoft.apply(f.reshape(-1, n), w2, core.f32(temperature),
                               kernels).reshape(f.shape)
        with profiling.span("edt_tpu_torch.mask", f):
            walls = argmin.walls_from_counts(wall_cnt_ax, w2)
            return _blend_walls(d, walls, temperature)
    d = _MinplusHardWalled.apply(f.reshape(-1, n), w2,
                                 wall_cnt_ax.reshape(-1, n),
                                 bool(binary_heights), kernels)
    return d.reshape(f.shape)


def multilabel_edtsq(labels, occupancy=None, anisotropy=None,
                     black_border=False, barrier=None, temperature=0.0,
                     axis_name=None, binary_occupancy=None, wall_counts=None, *,
                     device=None, kernels=KERNELS):
    """Differentiable multi-label squared EDT, wall-faithful to the
    reference (boundary voxels at distance w).

    labels: integer volume, 0 = background; it defines the walls and is
    not differentiated. occupancy: differentiable per-voxel solidity in
    [0, 1], default ``labels != 0`` (the forward is then the hard
    ``edtsq`` wherever that is finite, and open borders saturate near the
    barrier). barrier: default ``default_barrier``. binary_occupancy:
    promise that occupancy is two-valued (default True when occupancy is
    omitted); the first pass then runs the closed form. wall_counts: the
    tuple of ``wall_counts_for(labels, black_border)``, from the SAME
    labels and black_border. temperature > 0 runs the softmin passes, the
    walls blended in with logaddexp; binary_occupancy then has no effect.
    axis_name: None, or the process group over which axis 0 is sharded,
    labels, occupancy and wall_counts (then from ``wall_counts_for(labels,
    black_border, axis_name)``) being this rank's slabs (module doc); the
    axis-0 pass rotates the labels, or the axis-0 counts when given.
    """
    dev = _resolve_device([labels, occupancy, barrier, *(wall_counts or ())],
                          device)
    lab = _labels_tensor(labels, dev)
    nd = lab.dim()
    _check_axis_name(axis_name, nd)
    anis = np.asarray(anisotropy if anisotropy is not None else (1.0,) * nd,
                      np.float32).reshape(nd)
    if barrier is None:
        barrier = default_barrier(tuple(lab.shape), anis)
    if occupancy is None:
        occ = lab != 0
        if binary_occupancy is None:
            binary_occupancy = True
    else:
        occ = _as_tensor(occupancy, dev)
    binary_occupancy = bool(binary_occupancy)
    with profiling.span("edt_tpu_torch.multilabel_edtsq", lab,
                        shape=lab.shape, temperature=temperature,
                        sharded=axis_name is not None):
        f = _heights(barrier, occ)
        for step, ax in enumerate(_pass_order(anis)):
            rotated = axis_name is not None and ax == 0
            first = binary_occupancy and step == 0
            if rotated:
                f = rotate(f, axis_name, 2, 0)
            with profiling.pass_span(f, ax, _pass_kind(temperature, first)):
                if rotated and wall_counts is not None:
                    cnt = all_to_all(_as_tensor(wall_counts[0], dev),
                                     axis_name, 2, 0)
                elif rotated:
                    cnt = _wall_counts(all_to_all(lab, axis_name, 2, 0), 0,
                                       black_border)
                elif wall_counts is not None:
                    cnt = _as_tensor(wall_counts[ax], dev)
                else:
                    # counts in the volume's own layout: the pass transpose
                    # then moves int16 counts, not labels
                    cnt = _wall_counts(lab, ax, black_border)
                fa, ca = profiling.contiguous(f.movedim(ax, -1),
                                              cnt.movedim(ax, -1))
                f = _multilabel_pass(fa, ca, float(anis[ax]), temperature,
                                     binary_heights=first,
                                     kernels=kernels).movedim(-1, ax)
            if rotated:
                f = rotate(f, axis_name, 0, 2)
        with profiling.span("edt_tpu_torch.mask", f):
            return torch.where(lab == 0, 0.0, f)
