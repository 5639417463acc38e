"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py [PHASE ...]

(with words, only the build and the phases whose names contain one of
them, for a short run on the card, and no result lines). Builds the CUDA
kernels from ``edt_tpu_torch/csrc``, holds every kernel against its plain
PyTorch version on the card (K1 and K2 bit-exact, K3 and K4 within
rtol=1e-5, atol=1e-5: the same sums in another order; K5 and K6 within
the JAX package's tolerances for its softmin kernels; K1's and K2's
outward searches on rows that stress their exact stops, K3 on links K2
never makes, K4 on zero sites at its lane boundaries and past its
register cap, K5 on rows that stress its walk in both its regimes, K6 on
DistanceFieldNet-like rows, each up to and beyond its ceiling; K1, K3,
K4, K5 and K6 launched twice to the same bits), times K5 and K6 alone on
the DistanceFieldNet step's captured passes, and drives the port's main
paths:

- slice 1, the forward multi-label EDT through the NumPy API (K1), at
  128^3 and at the 512^3 ``bench.py`` volume;
- slice 2, ``bench.py``'s workload: the gradient of
  sum(multilabel_edtsq(labels, occupancy, (6, 6, 30), black_border=True,
  binary_occupancy=True)) w.r.t. the occupancy (K2, K3, K4), and the
  general path (binary_occupancy=False), at 128^3 and 512^3;
- slice 3, the softmin path at temperature > 0 (K5, K6): the soft
  transforms at 128^3 against the plain path, ``benchmarks/run.py``'s
  smooth training cell (soft_edtsq fwd+bwd at t = 0.3 on 256^3), and the
  single-device trainers: DistanceFieldNet at 2 x 256^3 and UNet3D at
  2 x 128^3;
- slice 7, the modules on K1 (phases ``vg``, ``each`` and ``export``): the
  voxel-graph transform at 256^3 (512^3 doubled) through the NumPy API,
  bit-exact to the volume doubled on the host through the plain pass;
  the SNEMI3D-like 512 x 512 x 100 per-label cell, where the host RLE
  kit's ``each`` (native, built with g++), ``torch_api.each_device`` and
  ``extract_labels`` give equal images; and the 512^3 forward exported
  with ``torch.export`` (K1 as a custom op), saved, loaded and bit-exact
  to ``compose.edtsq``;
- slice 9 (phases ``long`` and ``export_grad``): rows past the kernels'
  shared-memory ceilings, each long-row mode (K1, K2, K3, K5 at n = 58049
  and 65536, K6 at 29025 and 40000) against its plain version and, forced
  at its ceiling, against the shared-memory mode, then the main paths that
  reach them: ``multilabel_edtsq`` fwd+bwd at bench flags on (16, 16,
  65536) and ``soft_edtsq`` at t = 0.3 on (16, 16, 40000) and (4, 4,
  65536) against ``kernels=PLAIN``, the voxel graph on (2, 8, 32768) and
  (32768, 8, 2) against the host-doubled plain reference; and the
  gradients of the 512^3 bench fwd+bwd (K2, K3, K4) and the 256^3
  softmin cell (K5, K6) exported with ``export_fn`` (every kernel a
  custom op), saved, loaded and bit-exact to the live gradient;
- slice 10 (phase ``sharded``): four gloo ranks spawned on the one card
  (NCCL takes one rank a card) run ``edtsq_sharded_auto`` and
  ``sdf_sharded`` on the 512^3 volume and on 509 x 512 x 510, both
  black_border, ``edtsq_voxel_graph_sharded`` at 256^3, and bench.py's
  fwd+bwd and the 256^3 softmin fwd+bwd with ``axis_name``, each rank's
  result bit-exact (gradients within tolerance) to its slab of the
  single-card call, every kernel's launches checked on every rank, each
  kernel alone on rank 0's first call; then the 512^3 forward and fwd+bwd
  in one NCCL rank, and over min(4, cards) NCCL ranks where there are
  more cards. The gloo ranks share one card and stage their collectives
  through the host, so their times are no scaling figure;
- slice 11 (phase ``train_sharded``): the trainers' sharded steps over a
  (dp, sp) mesh at the single-card phases' widths, each from the same
  parameters as the single-card ``make_train_step`` and held to it with
  the JAX package's tolerances, K5 and K6 counted on every rank: four
  gloo ranks on card 0 (2 x 2) run the DistanceFieldNet psum step at
  2 x 256^3 (gloo on CUDA tensors carries all_reduce, not reduce_scatter
  or send/recv); one NCCL rank (1 x 1), and four (2 x 2) where there are
  four cards, run it with SGD and Adam, the reduce-scatter step (Adam,
  two steps, against the psum step, its moments in block order
  sp * n_dp + dp) and the UNet3D step at 2 x 128^3 (the halo exchange);
- slice 12 (phase ``api_shard``): the NumPy API's auto-sharding over
  every card of one process. With two cards or more: each of K1 to K6
  launched on the last card while card 0 is current (on its default
  stream and on a stream of its own) against card 0; ``bench.py``'s
  volume at 768^3 through ``edtsq`` at the default threshold, sharded
  (``sharded_dispatches``, K1 twice on every card) and bit-equal to the
  call on card 0, then 767 x 768 x 766 with an open border, the bool
  mask and ``sdf``; the voxel graph at 320^3 (doubled 640^3); the API's
  wall ms on one card and on all of them, with the host copies in
  threads and one card after another, a staged split (upload, passes,
  rotations, gather) and each card's profile (copies, kernels, idle
  share). With one card, the 768^3 call stays on it (counter 0);
- K1 where its floor decides the walk (phase ``k1_floor``): K1 alone on
  the passes of ``binary_edtsq`` of a 512^3 ball at (1, 1, 1) and (6, 6,
  30), of bench.py's ``sdf``'s background, of bench.py's volume at 768^3
  and of a 1024 x 1024 x 128 chunk of its labels in 32-voxel blocks, each
  pass bit-exact, with the candidates a voxel and warp steps under two
  floors (binary: the row floor and 32-voxel chunk floors,
  ``k1_search(floor="chunk")``; masked: the row and the segment floor)
  and, on the masked passes, the time of the same rows with f = 0 (no
  search); ``compose.edtsq`` at 768^3 on a device tensor, timed.

Each path runs with the launch counts set to 0 just before it and checked
just after. Times come from CUDA events. Prints one JSON line with the
kernels' numbers, then as its last line ``{"ok": true, "device": {...}}``.
Exits non-zero, without that line, when there is no CUDA device or any
phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ANISO = (6.0, 6.0, 30.0)
FULL = 512
SMALL = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SMS = 132  # H100 SXM
SFU_PER_CLOCK_SM = 16  # special-function (exp) results a clock an SM
SOFT_FULL = 256  # benchmarks/run.py's smooth training cell
SOFT_T = 0.3
TRAIN_FULL = 256  # DistanceFieldNet's timed batch, 2 x 256^3
TRAIN_SMALL = 128  # the trainers' KERNELS-vs-PLAIN step; UNet3D's timed batch
UNET_SMALL = 64  # UNet3D's KERNELS-vs-PLAIN step


def make_labels(rng, size):
    """bench.py's volume: 16^3 blocks of labels 0..5, each size/16 wide."""
    return block_labels(rng, (size,) * 3, max(1, size // 16))


def block_labels(rng, shape, blk=32):
    """Labels 0..5 in blk^3 blocks (bench.py's volume at another shape)."""
    base = rng.integers(0, 6, size=tuple(s // blk for s in shape))
    return np.kron(base, np.ones((blk,) * 3, dtype=np.uint8)).astype(np.uint32)


def cuda_ms(fn, reps, warmup=1):
    """Median and all times in ms of ``fn()`` over ``reps`` runs, each
    between two CUDA events after ``warmup`` untimed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def bit_equal(got, ref):
    """Tensors of one dtype on one device with equal values (a NaN is
    equal to nothing): the checks below pass them without copying them to
    the host, where comparing whole volumes takes seconds."""
    return (isinstance(got, torch.Tensor) and isinstance(ref, torch.Tensor)
            and got.device == ref.device and got.dtype == ref.dtype
            and torch.equal(got, ref))


class Exact:
    """Bit-exact comparisons: same INF pattern, equal finite values."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.failures = []

    def check(self, name, got, ref):
        if bit_equal(got, ref):
            return
        got = torch.as_tensor(got).to("cpu")
        ref = torch.as_tensor(ref).to("cpu")
        if got.shape != ref.shape:
            self.failures.append(f"{name}: shape {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)}")
            return
        fin = torch.isfinite(ref)
        if not torch.equal(torch.isfinite(got), fin):
            self.failures.append(f"{name}: INF pattern differs")
            return
        err = float((got[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        if not torch.equal(got[fin], ref[fin]):
            self.failures.append(f"{name}: max |diff| {err}")

    def raise_if_failed(self, phase):
        if self.failures:
            raise AssertionError(f"{phase}: {len(self.failures)} mismatches: "
                                 + "; ".join(self.failures[:10]))


class Close(Exact):
    """Comparisons within rtol and atol (plus atol_rel * max |ref|): the
    same INF pattern, finite values close. For sums the kernels and their
    plain versions take in another order, and for the softmin path."""

    def __init__(self, rtol=1e-5, atol=1e-5, atol_rel=0.0):
        super().__init__()
        self.rtol, self.atol, self.atol_rel = rtol, atol, atol_rel

    def check(self, name, got, ref):
        if bit_equal(got, ref):
            return
        got = torch.as_tensor(got).to("cpu")
        ref = torch.as_tensor(ref).to("cpu")
        if got.shape != ref.shape:
            self.failures.append(f"{name}: shape {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)}")
            return
        fin = torch.isfinite(ref)
        if not torch.equal(torch.isfinite(got), fin):
            self.failures.append(f"{name}: INF pattern differs")
            return
        got, ref = got[fin], ref[fin]
        if not ref.numel():
            return
        err = float((got - ref).abs().max())
        self.max_abs_err = max(self.max_abs_err, err)
        atol = self.atol + self.atol_rel * float(ref.abs().max())
        if not torch.allclose(got, ref, rtol=self.rtol, atol=atol):
            self.failures.append(f"{name}: max |diff| {err} (atol {atol:.3g})")

    def check_sum(self, name, got, ref, rtol):
        """A scalar within rtol: sum(g * e) against the plain version's."""
        got, ref = float(got), float(ref)
        if not abs(got - ref) <= rtol * abs(ref):
            self.failures.append(f"{name}: {got} vs {ref}")


def row_radii(f, bound, w2):
    """(R, 1) pruning radii of K1 and K2: the ulp-guarded floor of
    sqrt((max_i bound_i - min_i f_i) / w2), clamped to n."""
    from edt_tpu_torch.ops import core

    n = f.shape[1]
    minf = f.amin(dim=1)
    gap = bound.amax(dim=1) - minf
    gap = torch.where(torch.isfinite(gap), gap.clamp(min=0.0),
                      torch.where(minf == float("inf"), 0.0, float("inf")))
    r = torch.sqrt(gap / core.f32(w2)) * core.f32(1.00001) + core.f32(0.01)
    return torch.clamp(r, max=float(n)).to(torch.int64)[:, None]


def k2_candidates(f, walls, w2):
    """Candidates in K2's per-row radius on these inputs, windows clipped
    to the row: what the first version scanned, and the outward search's
    cap. ``walls``: f32 squared walls or None."""
    n = f.shape[1]
    i = torch.arange(n, dtype=torch.int64, device=f.device)
    r = row_radii(f, f if walls is None else torch.minimum(f, walls), w2)
    return int((torch.clamp(i + r + 1, max=n) - torch.clamp(i - r, min=0)).sum())


def k2_search_work(f, walls, w2):
    """(candidates, steps, warp steps) of K2's outward search on these
    inputs. A target visits j = i, then for k = 1, 2, ... up to the row
    radius the j = i -+ k inside the row, until min f + w2 k^2 (rounded as
    the kernel rounds it) exceeds min(best, wall_i); a warp holds 32
    adjacent targets and runs as many steps as its slowest.
    ``walls``: f32 squared walls or None."""
    from torch.nn.functional import pad

    from edt_tpu_torch.ops import core

    R, n = f.shape
    inf = float("inf")
    w2t = torch.tensor(core.f32(w2), dtype=torch.float32, device=f.device)
    wall = torch.full_like(f, inf) if walls is None else walls
    minf = f.amin(dim=1, keepdim=True)
    i = torch.arange(n, device=f.device)
    r = row_radii(f, f if walls is None else torch.minimum(f, walls), w2)
    kmax = torch.minimum(r, torch.maximum(i, n - 1 - i))
    best = f.clone()  # j = i: f_i + w2 * 0
    lim = torch.minimum(best, wall)
    active = torch.ones_like(f, dtype=torch.bool)
    steps = torch.zeros_like(f, dtype=torch.int32)
    count = R * n
    for k in range(1, int(kmax.max()) + 1):
        kf = torch.tensor(float(k), dtype=torch.float32, device=f.device)
        q = w2t * (kf * kf)
        active &= (kmax >= k) & ~((minf + q) > lim)
        live_l, live_r = active & (i >= k), active & (i + k < n)
        nl, nr = int(live_l.sum()), int(live_r.sum())
        if nl + nr == 0:
            break
        count += nl + nr
        steps += active
        cl = pad(f[:, :n - k], (k, 0), value=inf) + q
        best = torch.where(live_l & (cl <= best) & (cl != inf), cl, best)
        cr = pad(f[:, k:], (0, k), value=inf) + q
        best = torch.where(live_r & (cr < best), cr, best)
        lim = torch.minimum(best, wall)
    warp = pad(steps, (0, -n % 32)).reshape(R, -1, 32).amax(dim=-1)
    return count, int(steps.sum()), 32 * int(warp.sum())


def k3_steps(links, live):
    """(shuffle steps, gather steps) a voxel of K3 on these links: the
    lanes of each 32-voxel chunk that join a group of two or more and are
    not its leader (one shuffle and add each), and the sources the first
    version's gather scanned (every target over the row's link range).
    ``links``: (R, n) absolute targets; ``live``: in the row and not
    inert."""
    R, n = links.shape
    pad_n = -n % 32
    lane = torch.arange(n + pad_n, device=links.device) % 32
    lk = torch.nn.functional.pad(links, (0, pad_n))
    lv = torch.nn.functional.pad(live, (0, pad_n))
    key = torch.where(lv, lk, -1 - lane).reshape(R, -1, 32).sort(dim=-1).values
    groups = 1 + (key[..., 1:] != key[..., :-1]).sum(dim=-1)
    inert = (~lv).reshape(R, -1, 32).sum(dim=-1)
    shuffles = int(live.sum()) - int((groups - inert).sum())
    o = links - torch.arange(n, device=links.device)
    lo = torch.where(live, o, 0).amin(dim=1, keepdim=True).clamp(min=-n)
    hi = torch.where(live, o, 0).amax(dim=1, keepdim=True).clamp(max=n)
    j = torch.arange(n, device=links.device)
    scans = (torch.clamp(j - lo, max=n - 1) - torch.clamp(j - hi, min=0) + 1)
    return shuffles / links.numel(), int(scans.clamp(min=0).sum()) / links.numel()


def bound_ms(nbytes, ops):
    """Least time on the card: HBM bytes or f32 operations, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_walls(f, ss, se, w2, black_border, masked):
    """Each target's wall as K1 forms it: min of the segment walls
    w2 (i - ss + 1)^2, w2 (se - i)^2 (masked; open ends INF unless
    black_border), the border parabolas (binary with black_border), else
    INF; every square f32(k) * f32(k), then times w2."""
    from edt_tpu_torch.ops import core

    n = f.shape[1]
    inf = float("inf")
    w2t = torch.tensor(core.f32(w2), dtype=torch.float32, device=f.device)
    i = torch.arange(n, dtype=torch.int32, device=f.device)
    if masked:
        lw = w2t * (i - ss + 1).to(torch.float32).square()
        rw = w2t * (se - i).to(torch.float32).square()
        if not black_border:
            lw = torch.where(ss > 0, lw, inf)
            rw = torch.where(se < n, rw, inf)
        return torch.minimum(lw, rw)
    if black_border:
        sq = torch.minimum((i + 1).to(torch.float32).square(),
                           (n - i).to(torch.float32).square())
        return (w2t * sq).expand_as(f)
    return torch.full_like(f, inf)


def k1_candidates(f, ss, se, w2, black_border, masked):
    """Candidates in K1's per-row radius on these inputs, windows clipped
    to the row and, masked, to the target's segment: what the first
    version scanned, and the outward search's cap."""
    R, n = f.shape
    i = torch.arange(n, dtype=torch.int32, device=f.device)
    bound = torch.minimum(f, k1_walls(f, ss, se, w2, black_border, masked))
    r = row_radii(f, bound, w2)
    lo = torch.clamp(i - r, min=0)
    hi = torch.clamp(i + r + 1, max=n)
    if masked:
        lo = torch.maximum(lo, ss)
        hi = torch.minimum(hi, se)
    return int((hi - lo).clamp(min=0).sum())


def k1_chunk_floors(f):
    """K1's chunk floors on these binary rows: (cmin, pre, suf), each
    (R, ceil(n / 32)): each 32-voxel chunk's min f, and the running minima
    of cmin from the row's start to the chunk and from the chunk to the
    row's end."""
    from torch.nn.functional import pad

    R, n = f.shape
    nc = (n + 31) // 32
    cmin = pad(f, (0, nc * 32 - n), value=float("inf")).reshape(R, nc, 32) \
        .amin(dim=-1)
    return (cmin, cmin.cummin(dim=1).values,
            cmin.flip(1).cummin(dim=1).values.flip(1))


def k1_search(f, ss, se, w2, black_border, masked, floor="kernel",
              by_row=False):
    """K1's outward search emulated in torch with the kernel's roundings:
    (d, candidates, steps, warp steps) on these inputs; candidates count
    each target's own voxel and every other j it loads (``by_row``: an
    (R,) tensor of each row's).

    Each target i holds lim = min(f_i, wall_i) and takes, for k = 1, 2,
    ..., the j = i - k (k <= min(r, kl), kl = i - ss) and j = i + k (k <=
    min(r, kr), kr = se - 1 - i) of its segment (binary: of the row), r
    the row radius, each lowering lim to min(lim, f_j + w2 k^2), both
    sides tested with the lim held before step k; d is the final lim. It
    stops taking a side's candidates once a floor below all of them plus
    w2 k^2 exceeds lim (row and segment floors) or reaches it (chunk
    floors):

    - ``floor="kernel"``, what K1 runs: ``"segment"`` where
      ``minplus.segment_floor`` says so, else ``"row"``.
    - ``floor="row"``: both sides stop together once lb + w2 k^2 > lim,
      lb the row's min f; ``floor="segment"``: lb the min f of the
      target's segment (binary rows are one segment: the row's).
    - ``floor="chunk"``, a search the kernel does not run, emulated to
      count what it would visit: masked rows as the kernel. On binary rows a
      warp (32 adjacent targets, one chunk of 32 voxels) votes: where
      each of its targets' f is its chunk's min f (cmin of
      ``k1_chunk_floors``), as on flat heights, and one would walk past
      a chunk under the row floor (lb + w2 32^2 < f_i), it takes the
      chunk floors, else the row floor. Under the chunk floors a side of
      a target skips the rest of a chunk c once cmin[c] + w2 k^2 >= lim
      and ends on entering c once pre[c] + w2 k^2 >= lim (suf[c] on the
      right; at k = 1 its own chunk's); a step in which it takes neither
      side jumps to the nearer of the sides' next chunks. Every j so
      skipped costs at least lim, so d is the same.

    A step is one k of a target (both sides); a warp runs as many steps
    as its slowest target. The kernel's values are these, bit for bit."""
    from edt_tpu_torch.ops import core, minplus

    R, n = f.shape
    if floor not in ("chunk", "kernel", "row", "segment"):
        raise ValueError(f"floor: {floor!r}")
    w2t = torch.tensor(core.f32(w2), dtype=torch.float32, device=f.device)
    wall = k1_walls(f, ss, se, w2, black_border, masked)
    i = torch.arange(n, device=f.device)
    kl, kr = (i - ss, se - 1 - i) if masked else (i, n - 1 - i)
    r = row_radii(f, torch.minimum(f, wall), w2)
    lim = torch.minimum(f + w2t * 0.0, wall)
    lb = f.amin(dim=1, keepdim=True)
    if masked and (floor == "segment" or floor != "row"
                   and minplus.segment_floor(n, masked)):
        # segment mins, gathered at each segment start
        lb = torch.full_like(f, float("inf")).scatter_reduce(
            1, ss.long(), f, "amin").gather(1, ss.long())
    d, count, steps = _k1_row_search(f, w2t, lb, r, kl, kr, wall, lim)
    if floor == "chunk" and not masked:
        floors = k1_chunk_floors(f)
        own = floors[0].repeat_interleave(32, dim=1)[:, :n]
        far = (lb + w2t * 1024.0) < f  # walks past a chunk under lb
        vote = (_k1_lanes(own >= f, True).all(dim=-1)
                & _k1_lanes(far, False).any(dim=-1))
        if bool(vote.any()):
            chunk = vote.repeat_interleave(32, dim=1)[:, :n]
            d2, count2, steps2 = _k1_chunk_search(f, w2t, floors, r, kl, kr,
                                                  lim)
            if not torch.equal(d2, d):
                raise AssertionError("k1_search: the two floors disagree")
            count = torch.where(chunk, count2, count)
            steps = torch.where(chunk, steps2, steps)
    warp = _k1_lanes(steps, 0).amax(dim=-1)
    count = count.sum(dim=1) + n
    return (d, count if by_row else int(count.sum()), int(steps.sum()),
            32 * int(warp.sum()))


def _k1_lanes(x, fill):
    """(R, n) -> (R, ceil(n / 32), 32): each warp's 32 adjacent targets."""
    from torch.nn.functional import pad

    return pad(x, (0, -x.shape[1] % 32), value=fill) \
        .reshape(x.shape[0], -1, 32)


def _k1_row_search(f, w2t, lb, r, kl, kr, wall, lim):
    """``k1_search`` under one floor lb (the row's or the segment's min f):
    (d, each target's candidates but its own, each target's steps)."""
    from torch.nn.functional import pad

    R, n = f.shape
    inf = float("inf")
    kmax = torch.minimum(r, torch.maximum(kl, kr))
    best = lim.clone()
    active = torch.ones_like(f, dtype=torch.bool)
    steps = torch.zeros_like(f, dtype=torch.int32)
    count = torch.zeros_like(f, dtype=torch.int64)
    for k in range(1, int(kmax.max()) + 1 if n else 1):
        kf = torch.tensor(float(k), dtype=torch.float32, device=f.device)
        q = w2t * (kf * kf)
        active &= (kmax >= k) & ~((lb + q) > lim)
        live_l, live_r = active & (kl >= k), active & (kr >= k)
        if not bool((live_l | live_r).any()):
            break
        count += live_l.long() + live_r.long()
        steps += active
        cl = pad(f[:, :n - k], (k, 0), value=inf) + q
        best = torch.where(live_l, torch.minimum(best, cl), best)
        cr = pad(f[:, k:], (0, k), value=inf) + q
        best = torch.where(live_r, torch.minimum(best, cr), best)
        lim = torch.minimum(best, wall)
    return lim, count, steps


def _k1_chunk_search(f, w2t, floors, r, kl, kr, lim):
    """``k1_search`` under the chunk floors of binary rows, every target
    at once as the kernel runs it: a target runs step k only if its last
    step took a candidate (k - 1) or jumped to k. Returns (d, each
    target's candidates but its own, each target's steps)."""
    from torch.nn.functional import pad

    R, n = f.shape
    inf = float("inf")
    cmin, pre, suf = floors
    nc = cmin.shape[1]
    i = torch.arange(n, device=f.device)
    c0 = (i // 32).expand(R, n)
    end = (torch.minimum(r, kl).expand(R, n), torch.minimum(r, kr).expand(R, n))
    nxt = [((i & 31) + 1).expand(R, n).clone(),
           (32 - (i & 31)).expand(R, n).clone()]
    own = cmin.gather(1, c0)
    flo = [own, own]
    # step 1 ends a side that its own chunk's pre (suf) bounds already
    live = [(end[0] >= 1) & ~((pre.gather(1, c0) + w2t) >= lim),
            (end[1] >= 1) & ~((suf.gather(1, c0) + w2t) >= lim)]
    tables = ((pre, -1), (suf, 1))
    kt = torch.ones_like(f, dtype=torch.int64)  # each target's next step
    big = torch.full_like(kt, 2 ** 62)
    steps = torch.zeros_like(f, dtype=torch.int32)
    count = torch.zeros_like(f, dtype=torch.int64)
    k = 1
    while True:
        on = live[0] | live[1]
        if not bool(on.any()):
            break
        k = max(k, int(kt[on].min()))
        ex = on & (kt == k)
        q = w2t * torch.tensor(float(k) * float(k), device=f.device)
        take = []
        for s, (emin, sign) in enumerate(tables):
            c = torch.div(i + sign * k, 32, rounding_mode="floor") \
                .clamp(0, nc - 1).expand(R, n)
            enter = ex & live[s] & (k == nxt[s])
            flo[s] = torch.where(enter, cmin.gather(1, c), flo[s])
            nxt[s] = torch.where(enter, nxt[s] + 32, nxt[s])
            live[s] = live[s] & ~(enter & ((emin.gather(1, c) + q) >= lim))
            take.append(ex & live[s] & ~((flo[s] + q) >= lim))
        for s, t in enumerate(take):
            cand = (pad(f[:, :n - k], (k, 0), value=inf) if s == 0
                    else pad(f[:, k:], (0, k), value=inf)) + q
            lim = torch.where(t, torch.minimum(lim, cand), lim)
            count += t.long()
        steps += ex
        jump = torch.minimum(torch.where(live[0], nxt[0], big),
                             torch.where(live[1], nxt[1], big))
        kt = torch.where(ex, torch.where(take[0] | take[1], k + 1, jump), kt)
        for s in (0, 1):
            live[s] = live[s] & ~(ex & (kt > end[s]))
        k += 1
    return lim, count, steps


def k1_bound_ms(f, masked):
    """Least time for K1 on the card: HBM bytes, f (and ss, se when
    masked) read once and d written once, 16 B a voxel masked, 8 B binary.
    It counts no search: how many candidates a search visits depends on
    its floors (``k1_search``), and the function needs none but the one
    that wins."""
    return bound_ms(f.numel() * (16 if masked else 8), 0)


def sfu_exps_per_s():
    """The card's exp rate: 16 special-function results a clock on each of
    132 SMs at the SM clock ``nvidia-smi`` reports as its maximum."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    mhz = float(smi.stdout.split()[0])
    print(f"SM clock (clocks.max.sm): {mhz:.0f} MHz; exp rate "
          f"{SFU_PER_CLOCK_SM * SMS * mhz * 1e6:.4g}/s")
    return SFU_PER_CLOCK_SM * SMS * mhz * 1e6


def bound_exp_ms(nbytes, ops, exps, exps_per_s):
    """Least time on the card: HBM bytes, f32 operations, or exps at the
    special-function rate, the largest. Returns (ms, bound_by, term)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32 operations": ops / F32_FLOPS_PER_S * 1e3,
             "exps": exps / exps_per_s * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], ("bytes" if term == "bytes" else "operations"), term


def window_terms(gap, w2):
    """Terms of the windows |k| <= r with w2 k^2 <= gap (one window a
    position, clipped to the row; a NaN or negative gap has none): K5's
    hard-min windows and K6's windows on these inputs."""
    n = gap.shape[-1]
    i = torch.arange(n, device=gap.device)
    r = torch.floor(torch.sqrt(gap.clamp(min=0.0) / w2)).clamp(max=n)
    r = torch.where(gap >= 0, r, -1.0).to(torch.int64)
    cnt = torch.clamp(i + r, max=n - 1) - torch.clamp(i - r, min=0) + 1
    return int(torch.where(r >= 0, cnt, 0).sum())


def soft_cut(t):
    """30 t as the softmin kernels form it: f32(30) * f32(t), rounded once."""
    return float(np.float32(30.0) * np.float32(t))


def k5_search(f, w2, t, floor="row"):
    """K5's walk emulated in torch with the kernel's roundings: (d, taken,
    exps, visited, steps, warp steps) on these inputs. Each target holds
    m = f_i and s = 1, then takes the steps k = 1, 2, ... in pairs
    (k, k + 1), up to max(i, n - 1 - i), each step the j = i -+ k (INF
    outside the row), until (lb + w2 k^2) - m > 30 t before a pair. A pair
    whose second least cost is inside the cut of min(m, its least) takes
    its four candidates one at a time: one at cost c below m rescales s by
    exp((c - m) / t) and adds 1 (m = c), one with m - c >= -30 t adds
    exp((c - m) / t). Any other pair takes only its least candidate, the
    same way. d = m - t log(s) (INF on all-INF rows). Taken: the
    candidates whose weight entered s, the centre's included, a superset
    of the pairs inside each target's final cut; exps: those besides the
    centre. lb is the row's min f (``floor="row"``, the kernel's), or with
    ``floor="side"`` the min f beyond i - k on the left and beyond i + k on
    the right, each side stopping on its own (a floor counted, not built).
    Visited: the candidates inside the row that the walk loads. A warp
    holds 32 adjacent targets and runs as many steps as its slowest."""
    from torch.nn.functional import pad

    from edt_tpu_torch.ops import core

    R, n = f.shape
    inf = float("inf")
    w2t = torch.tensor(core.f32(w2), dtype=torch.float32, device=f.device)
    cut, t32 = soft_cut(t), core.f32(t)
    i = torch.arange(n, device=f.device)
    kmax = torch.maximum(i, n - 1 - i)
    minf = f.amin(dim=1, keepdim=True) if n else f[:, :1]
    live = torch.isfinite(minf).expand(R, n)  # all-INF rows: no walk

    def left(x, k):
        return pad(x[:, :n - k], (k, 0), value=inf) if k < n else \
            torch.full_like(x, inf)

    def right(x, k):
        return pad(x[:, k:], (0, k), value=inf) if k < n else \
            torch.full_like(x, inf)

    if floor == "row":
        lb_l = lb_r = lambda k: minf  # noqa: E731
    else:
        pre = f.cummin(dim=1).values
        suf = f.flip(1).cummin(dim=1).values.flip(1)
        lb_l, lb_r = (lambda k: left(pre, k)), (lambda k: right(suf, k))

    def take(c, m, s):
        """One candidate at cost c against (m, s): (m, s, taken)."""
        x = m - c
        down = x > 0
        add = ~down & (x >= -cut)
        w = torch.exp(-x.abs() / t32)
        s = torch.where(down, s * w + 1, torch.where(add, s + w, s))
        return torch.where(down, c, m), s, down | add

    m, s = f.clone(), torch.ones_like(f)
    exps = 0
    go = go_l = go_r = live
    steps = live.to(torch.int32)
    visited = int(live.sum())
    for k in range(1, n, 2):
        q1 = w2t * torch.tensor(float(k * k), device=f.device)
        q2 = w2t * torch.tensor(float((k + 1) * (k + 1)), device=f.device)
        if floor == "row":
            go = go & (k <= kmax) & ~(((minf + q1) - m) > cut)
            go_l = go_r = go
        else:
            go_l = go_l & (k <= i) & ~(((lb_l(k) + q1) - m) > cut)
            go_r = go_r & (k <= n - 1 - i) & ~(((lb_r(k) + q1) - m) > cut)
            go = go_l | go_r
        if not bool(go.any()):
            break
        steps += 2 * go
        cs = []
        for g, side, kk in ((go_l, left, k), (go_r, right, k),
                            (go_l, left, k + 1), (go_r, right, k + 1)):
            inside = g & ((kk <= i) if side is left else (kk <= n - 1 - i))
            visited += int(inside.sum())
            q = q1 if kk == k else q2
            cs.append(torch.where(g, side(f, kk) + q, inf))
        a, b = torch.minimum(cs[0], cs[1]), torch.minimum(cs[2], cs[3])
        lo = torch.minimum(a, b)
        lo2 = torch.minimum(torch.maximum(a, b),
                            torch.minimum(torch.maximum(cs[0], cs[1]),
                                          torch.maximum(cs[2], cs[3])))
        mn = torch.minimum(m, lo)
        slow = go & ((mn - lo2) >= -cut)
        fast = go & ~slow
        fm, fs, ft = take(lo, m, s)
        sm, ss = m, s
        for c in cs:
            sm, ss, st = take(c, sm, ss)
            exps += int((slow & st).sum())
        exps += int((fast & ft).sum())
        m = torch.where(fast, fm, torch.where(slow, sm, m))
        s = torch.where(fast, fs, torch.where(slow, ss, s))
    d = torch.where(s > 0, m - t32 * torch.log(s), m)
    warp = (32 * int(pad(steps, (0, -n % 32)).reshape(R, -1, 32)
                     .amax(dim=-1).sum()) if n else 0)
    return d, exps + int(live.sum()), exps, visited, int(steps.sum()), warp


def k5_pairs(f, w2, t):
    """(needed, hard, visited) counts of K5 on these inputs. Needed: the
    pairs the function needs, those inside each target's own cut,
    (f_j + w2 k^2) - dmin_i <= 30 t (cost rounded as the kernel rounds it),
    one exp each. Hard: the candidates of the exact hard min's window under
    the row-min floor, w2 k^2 <= dmin_i - min f, which any walk with that
    floor must visit. Visited: the candidates K5's walk loads
    (``k5_search``)."""
    from edt_tpu_torch.ops import core

    R, n = f.shape
    cut = soft_cut(t)
    minf = f.amin(dim=1, keepdim=True)
    q = torch.arange(n, dtype=torch.float32, device=f.device)
    q = q[:, None] - q[None, :]
    wq = (q * q) * core.f32(w2)
    chunk = max(1, (1 << 28) // (n * n or 1))
    needed = 0
    dmin = torch.empty_like(f)
    for r0 in range(0, R, chunk):
        cost = f[r0:r0 + chunk, None, :] + wq
        dmin[r0:r0 + chunk] = cost.amin(dim=-1)
        needed += int(((cost - dmin[r0:r0 + chunk, :, None]) <= cut).sum())
        del cost
    visited = k5_search(f, w2, t)[3]
    return needed, window_terms(dmin - minf, w2), visited


def k5_bound_ms(f, w2, t, exps_per_s):
    """K5's least time on these inputs: 8 B a voxel (f read, d written), or
    its needed pairs at one exp each (the special-function rate) or 6 f32
    operations each (square, scale, add, sub, scale, sum), the largest.
    Returns (bound_exp_ms's triple, needed, hard, visited)."""
    needed, hard, visited = k5_pairs(f, w2, t)
    return (bound_exp_ms(8 * f.numel(), 6 * needed, needed, exps_per_s),
            needed, hard, visited)


def k6_pairs(f, d, w2, t):
    """(needed, visited) pairs of K6 on these inputs. Needed: the pairs the
    function needs, those inside each target's own cut, f_j + w2 k^2 - d_i
    <= 30 t (cost rounded as the kernel rounds it), one exp each. Visited:
    the candidates in K6's windows, w2 k^2 <= d_i + 30 t - min f, which its
    first pass walks."""
    from edt_tpu_torch.ops import core

    R, n = f.shape
    cut = core.f32(30.0 * t)
    minf = f.amin(dim=1, keepdim=True)
    q = torch.arange(n, dtype=torch.float32, device=f.device)
    q = q[:, None] - q[None, :]
    wq = (q * q) * core.f32(w2)
    needed = 0
    for r0 in range(0, R, max(1, (1 << 28) // (n * n or 1))):
        cost = f[r0:r0 + (1 << 28) // (n * n or 1), None, :] + wq
        needed += int(((d[r0:r0 + cost.shape[0], :, None] - cost) >= -cut)
                      .sum())
        del cost
    return needed, window_terms(d + cut - minf, w2)


def k6_bound_ms(f, d, w2, t, exps_per_s):
    """K6's least time on these inputs: 20 B a voxel (f, d, g read, df, e
    written), or its needed pairs at one exp each (the special-function
    rate) or 7 f32 operations each (square, scale, add, sub, scale, two
    sums), the largest. Returns (bound_exp_ms's triple, needed, visited)."""
    needed, visited = k6_pairs(f, d, w2, t)
    return (bound_exp_ms(20 * f.numel(), 7 * needed, needed, exps_per_s),
            needed, visited)


def profile(fn, label, top=8, by_op=False):
    """One run of ``fn`` under torch.profiler: wall time, device busy time
    (kernels and copies: the device-side events), idle share, and the
    device events that take the most time; ``by_op`` also ranks the host
    ops by the device time of the kernels each launched itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, ops = [], []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if ev.device_type != DeviceType.CUDA:
            # host ops, by the device time of the kernels each launched
            if by_op and us > 0:
                ops.append((us / 1e3, ev.count, ev.key))
            continue
        # "Activity Buffer Request" is the profiler's own bookkeeping
        if not ev.key.startswith("Activity Buffer"):
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    ops.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    copies = sum(r[0] for r in rows if r[2].startswith("Memcpy"))
    print(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} "
          f"ms (copies {copies:.2f} ms), idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}")
    for ms, count, key in rows[:top]:
        print(f"  {ms:9.3f} ms  {ms / max(busy, 1e-9):6.1%}  x{count:<4d} "
              f"{key[:80]}")
    if ops:
        print("  by the host op that launched them:")
        for ms, count, key in ops[:top]:
            print(f"  {ms:9.3f} ms  {ms / max(busy, 1e-9):6.1%}  x{count:<4d} "
                  f"{key[:80]}")


def phase_build():
    from edt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(report) or 'cached'})")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "entry function")):
                print(f"  {name}: {line.strip()}")


def k1_stress_rows(rng):
    """(name, f, labels, w2) rows that stress K1's outward search and its
    exact stop, w2 as it reaches the kernel: w2 in {0.7, 1, 36, 900} (at
    0.7, w2 k^2 rounds), f near 3e7 (ulp 2: neighbouring costs round
    together), heights up to 3e38 with w2 = 1e34 (w2 k^2 overflows to
    INF), partly and wholly INF rows, one-voxel segments, and INF heights
    in a walled segment."""
    cases = []
    for n in (300, 2049):
        rows = 32 if n <= 512 else 8
        for w2 in (0.7, 1.0, 36.0, 900.0):
            f = (3e7 + rng.random((rows, n)) * 200).astype(np.float32)
            f[rows // 2:, ::97] = 2.99999e7
            lab = rng.integers(0, 3, size=(rows, n)).astype(np.int32)
            cases.append((f"n={n} w2={w2} f near 3e7", f, lab, w2))
            f = (rng.random((rows, n)) * 900).astype(np.float32)
            f[rng.random((rows, n)) < 0.3] = np.inf
            f[1] = np.inf  # a wholly INF row
            f[2] = np.inf
            f[2, rng.integers(0, n)] = 5.0  # one finite height
            lab = np.repeat(rng.integers(1, 4, size=(rows, n // 50 + 1)),
                            50, axis=1)[:, :n].astype(np.int32)
            cases.append((f"n={n} w2={w2} partly INF", f, lab, w2))
            f = (rng.random((rows, n)) * 50 * w2).astype(np.float32)
            lab = (np.arange(n) % 3 + 1)[None, :].repeat(rows, 0)
            lab[rows // 2:] = rng.integers(1, 3, size=(rows - rows // 2, n))
            cases.append((f"n={n} w2={w2} one-voxel segments", f,
                          lab.astype(np.int32), w2))
        f = np.full((rows, n), np.inf, np.float32)
        f[:, ::40] = rng.random((rows, len(range(0, n, 40)))) * 100
        f[: rows // 2, 60:200] = np.inf  # INF heights in a walled segment
        lab = np.ones((rows, n), np.int32)
        lab[:, 55:205] = 2
        cases.append((f"n={n} w2=1.69 INF segment", f, lab, 1.69))
        f = (3e38 * rng.random((rows, n))).astype(np.float32)
        f[:, ::7] = 0.0
        f[rng.random((rows, n)) < 0.2] = np.inf
        cases.append((f"n={n} w2=1e34 near f32 max", f,
                      rng.integers(1, 3, size=(rows, n)).astype(np.int32),
                      1e34))
    return cases


def k1_floor_rows(rng):
    """(name, f, labels, w2) rows that stress K1's floors where background
    lies far from the targets: a single background voxel at the row's end
    (the voxel graph's zero tail), zeros exactly at 32-voxel chunk
    boundaries, a chunk min equal to the targets' limit (ties), wholly
    INF chunks, f near 3e7 with w2 = 0.7 (neighbouring costs round
    together), w2 = 1e34 (w2 k^2 overflows), at lengths about every
    mode's edges: one warp (33, 511, 512), groups of warps (513, 4096),
    parked targets (4097), the ceiling 58048 and the long-row mode
    (58049, 65536)."""
    from edt_tpu_torch.ops import minplus

    cases = []
    for n in (33, 511, 512, 513, 4096, 4097, minplus.MAX_AXIS,
              minplus.MAX_AXIS + 1, 65536):
        rows = 8 if n <= 4097 else 2
        lab = np.ones((rows, n), np.int32)
        # the zero tail: flat foreground, one background voxel at the end
        f = np.full((rows, n), 400.0, np.float32)
        f += (np.arange(rows, dtype=np.float32) * 37.0)[:, None]
        tail = lab.copy()
        tail[:, -1] = 0
        cases.append((f"n={n} zero tail", f, tail, 0.25))
        # zeros at chunk boundaries, and a chunk min equal to a limit: f
        # rises from each zero by w2 k^2, so costs tie
        b = lab.copy()
        b[::2, 32::96] = 0
        b[1::2, 31::96] = 0
        k = np.arange(n) % 96
        f = (np.minimum(k, 96 - k) ** 2).astype(np.float32)[None].repeat(rows, 0)
        cases.append((f"n={n} zeros at chunk edges, ties", f, b, 1.0))
        # wholly INF chunks between sparse finite heights, a few zeros
        f = np.full((rows, n), np.inf, np.float32)
        f[:, 5::160] = rng.random((rows, len(range(5, n, 160)))) * 50
        z = lab.copy()
        z[:, rng.integers(0, n, size=3)] = 0
        cases.append((f"n={n} INF chunks", f, z, 1.69))
        # near 3e7 and near f32 max, over labels with background
        ml = np.repeat(rng.integers(0, 4, size=(rows, n // 40 + 1)), 40,
                       axis=1)[:, :n].astype(np.int32)
        f = (3e7 + rng.random((rows, n)) * 200).astype(np.float32)
        cases.append((f"n={n} f near 3e7 w2=0.7", f, ml, 0.7))
        f = (3e38 * rng.random((rows, n))).astype(np.float32)
        f[rng.random((rows, n)) < 0.2] = np.inf
        cases.append((f"n={n} w2=1e34", f, ml, 1e34))
    return cases


def k1_segment_rows(rng):
    """(name, f, labels, w2) rows that stress the segment floor of masked
    rows held by a group of several warps, each warp a span of contiguous
    32-voxel chunks: segments that cross a chunk edge (from lane 31 to
    lane 0, and 64 voxels from lane 31) and span edges, one segment over
    the whole row and one over all of it but a voxel, one-voxel segments
    at every chunk edge, wholly INF segments across chunks, a segment over
    half the row whose min lies in another warp's span than most of its
    targets, f near 3e7 with w2 = 0.7 and w2 = 1e34 over runs across chunk
    edges; background elsewhere in the row, so that the row's floor is 0.
    Lengths about every edge:
    groups of warps (513 to 4096), parked targets (4097), the floor's
    limit ``minplus.SEGMENT_FLOOR_AXIS`` +- 1, the ceiling 58048 and the
    long-row mode (58049, 65536)."""
    from edt_tpu_torch.ops import minplus

    lim = minplus.SEGMENT_FLOOR_AXIS
    cases = []
    for n in (513, 544, 768, 1024, 2049, 4096, 4097, lim - 1, lim, lim + 1,
              minplus.MAX_AXIS, minplus.MAX_AXIS + 1, 65536):
        rows = 4 if n <= 4097 else 2
        i = np.arange(n)
        heights = lambda: (rng.random((rows, n)) * 900).astype(np.float32)  # noqa: E731
        # segments of 64 from lane 31 (over three chunks), two-voxel ones
        # from lane 31 to lane 0, and background
        lab = 1 + ((i - 31) // 64) % 3
        lab[(i % 256 == 95) | (i % 256 == 96)] = 7
        lab = np.repeat(lab[None], rows, 0)
        lab[:, 10:14] = 0
        lab[:, 31 + 64 * 9:95 + 64 * 9] = 0
        cases.append((f"n={n} segments across chunk edges", heights(),
                      lab.astype(np.int32), 2.25))
        # one segment over the row; over all of it but one voxel
        f = heights()
        f[1] = 1e4
        f[1, n // 3] = 3.0  # one low voxel, far from most targets
        cases.append((f"n={n} one segment", f, np.ones((rows, n), np.int32),
                      1.0))
        lab = np.ones((rows, n), np.int32)
        lab[np.arange(rows), [0, n - 1, n // 2, 31][:rows]] = 0
        cases.append((f"n={n} one segment but a voxel", heights(), lab, 1.0))
        # one-voxel segments at every chunk edge
        lab = np.where(i % 32 == 0, 2, np.where(i % 32 == 31, 3, 1))
        lab = np.repeat(lab[None], rows, 0).astype(np.int32)
        lab[:, 100:140] = 0
        cases.append((f"n={n} one-voxel segments at chunk edges", heights(),
                      lab, 36.0))
        # wholly INF segments across chunks (runs of 100 from voxel 20)
        run = (i + 80) // 100
        lab = np.repeat((1 + run % 4)[None], rows, 0).astype(np.int32)
        f = heights()
        f[:, run % 2 == 1] = np.inf
        lab[:, :5] = 0
        cases.append((f"n={n} INF segments across warps", f, lab, 1.69))
        # a segment over half the row from n / 8, across span edges, whose
        # min is at its far end; background after it
        a, b = n // 8, n // 8 + n // 2
        lab = np.full((rows, n), 2, np.int32)
        lab[:, a:b] = 1
        lab[:, b + 5:b + 10] = 0
        f = np.full((rows, n), 5e4, np.float32)
        f[:, b - 1] = 7.0
        f[1, a] = 2.0  # and at its near end
        cases.append((f"n={n} segment min in another warp", f, lab, 1.0))
        # f near 3e7 at w2 = 0.7 and near f32 max at w2 = 1e34, over runs
        # of 45 (across chunk edges) with background
        ml = np.repeat(rng.integers(0, 4, size=(rows, n // 45 + 1)), 45,
                       axis=1)[:, :n].astype(np.int32)
        f = (3e7 + rng.random((rows, n)) * 200).astype(np.float32)
        cases.append((f"n={n} f near 3e7 w2=0.7", f, ml, 0.7))
        f = (3e38 * rng.random((rows, n))).astype(np.float32)
        f[rng.random((rows, n)) < 0.2] = np.inf
        cases.append((f"n={n} w2=1e34", f, ml, 1e34))
    return cases


def check_k1(exact, name, f, lab, w2, dev):
    """K1 against its plain version, bit-exact, multi-label and binary,
    each with and without black_border; two launches give the same bits.
    ``f`` is zeroed where ``lab`` is background, as a pass receives it."""
    from edt_tpu_torch.ops import core, minplus

    plain = minplus.minplus_walls_plain

    for binary in (False, True):
        lb = (lab != 0).astype(np.int32) if binary else lab
        ff = np.where(lb == 0, np.float32(0), f).astype(np.float32)
        ft = torch.from_numpy(ff).to(dev)
        ss, se = core.segment_bounds(torch.from_numpy(lb).to(dev))
        for bb in (False, True):
            got = minplus.minplus_walls(ft, ss, se, w2, bb, not binary)
            ref = plain(ft, ss, se, w2, bb, not binary)
            exact.check(f"{name} binary={binary} bb={bb}", got, ref)
            again = minplus.minplus_walls(ft, ss, se, w2, bb, not binary)
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                exact.failures.append(f"{name} binary={binary} bb={bb}: two "
                                      "launches differ")
    return 4


def phase_kernel_cases(exact, dev):
    """K1 against its plain version, bit-exact, over the regimes it has,
    the rows that stress its outward search, and rows at its ceiling; two
    launches give the same bits; rows one past the ceiling take its
    long-row mode (the ``long`` phase holds that mode in full)."""
    from edt_tpu_torch.ops import core, minplus

    rng = np.random.default_rng(7)
    cases = []
    for n in (1, 127, 300, 512, 2049):
        for w in (1.3, 6.0, 30.0):
            rows = 96 if n <= 512 else 24
            f = rng.random((rows, n)).astype(np.float32) * 25 * w * w
            lab = rng.integers(0, 3, size=(rows, n)).astype(np.int32)
            if n >= 300:  # a long run: large radii beside small ones
                f[: rows // 2, 100:260] = 500.0 * w * w
                lab[: rows // 2, 100:260] = 1
            cases.append((f"n={n} w={w}", f, lab, core.f32(core.f32(w) ** 2)))
    # the mixed band/large-radius field of the JAX kernel tests
    f = rng.random((10, 300)).astype(np.float32) * 25
    lab = rng.integers(0, 3, size=(10, 300)).astype(np.int32)
    f[:, 100:260] = 500.0
    lab[:, 100:260] = 1
    cases.append(("mixed", f, lab, core.f32(core.f32(1.1) ** 2)))
    # constant rows: radius 0
    i = np.arange(300, dtype=np.float32)
    cases.append(("constant", np.repeat((i ** 2)[:, None], 40, axis=1),
                  np.ones((300, 40), np.int32), 1.0))
    # all-INF rows beside finite ones
    f = rng.random((64, 200)).astype(np.float32) * 50
    f[::2] = np.inf
    cases.append(("all-inf rows", f, np.ones((64, 200), np.int32),
                  core.f32(core.f32(1.3) ** 2)))
    # one source per row, INF elsewhere: every row scans in full
    f = np.full((8, 2049), np.inf, np.float32)
    f[np.arange(8), rng.integers(0, 2049, size=8)] = 0.0
    lab = np.ones((8, 2049), np.int32)
    lab[f == 0] = 0
    cases.append(("full-row radius", f, lab, core.f32(core.f32(1.3) ** 2)))
    cases += k1_stress_rows(np.random.default_rng(19))
    cases += k1_floor_rows(np.random.default_rng(23))
    cases += k1_segment_rows(np.random.default_rng(29))
    # rows at the ceiling: random heights over runs of labels, and one
    # source a row, INF elsewhere
    n = minplus.MAX_AXIS
    f = (rng.random((2, n)) * 900).astype(np.float32)
    lab = np.repeat(rng.integers(0, 4, size=(2, n // 64 + 1)), 64,
                    axis=1)[:, :n].astype(np.int32)
    cases.append((f"n={n}", f, lab, 36.0))
    f = np.full((2, n), np.inf, np.float32)
    f[0, rng.integers(0, n)] = 0.0
    f[1, [3, n - 9]] = 0.0
    cases.append((f"n={n} sparse sources", f, np.ones((2, n), np.int32), 0.7))

    n_cases = sum(check_k1(exact, name, f, lab, w2, dev)
                  for name, f, lab, w2 in cases)
    # the longest row of each mode, one source: d = w2 i^2 exactly
    n = minplus.MAX_AXIS
    w2 = core.f32(1.69)
    for m in (n, n + 1):
        ft = torch.full((4, m), float("inf"), device=dev)
        ft[:, 0] = 0.0
        idx = torch.arange(m, dtype=torch.float32, device=dev)
        got = minplus.minplus_walls(ft, None, None, w2, False, False)
        exact.check(f"n={m} one source", got, ((idx * idx) * w2).expand(4, m))
    exact.raise_if_failed("kernel vs plain")
    longest = max(f.shape[1] for _, f, _, _ in cases)
    print(f"kernel vs plain: {n_cases + 2} cases bit-exact up to "
          f"n={longest} (past n={n} in the long-row mode), each of the "
          f"first {n_cases} launched twice to the same bits")


def phase_slice_small(exact, dev):
    """The slice at 128^3 through the API against the plain path."""
    import edt_tpu_torch as et
    from edt_tpu_torch.ops import compose, minplus
    from edt_tpu_torch.utils import host_reference

    plain = minplus.make_parabolic_fn(minplus.minplus_walls_plain)
    labels = make_labels(np.random.default_rng(3), 128)
    lt = torch.from_numpy(labels.view(np.int32)).to(dev)
    order = (2, 1, 0)
    for bb in (False, True):
        exact.check(f"128^3 edtsq bb={bb}",
                    et.edtsq(labels, ANISO, bb, device=dev),
                    compose.edtsq(lt, ANISO, bb, parabolic_fn=plain,
                                  axis_order=order))
    exact.check("128^3 sdf", et.sdf(labels, ANISO, True, device=dev),
                torch.sqrt(compose.edtsq(lt, ANISO, True, parabolic_fn=plain,
                                         axis_order=order))
                - torch.sqrt(compose.edtsq((lt == 0).to(torch.uint8), ANISO,
                                           True, binary=True,
                                           parabolic_fn=plain,
                                           axis_order=order)))
    occ = labels != 0
    exact.check("128^3 bool edtsq", et.edtsq(occ, ANISO, True, device=dev),
                compose.edtsq(torch.from_numpy(occ.view(np.uint8)).to(dev),
                              ANISO, True, binary=True, parabolic_fn=plain,
                              axis_order=order))
    # the JAX package's default backends by name: K1 on the card
    for name, kw in (("default_minplus_fn",
                      {"minplus_fn": compose.default_minplus_fn()}),
                     ("default_parabolic_fn",
                      {"parabolic_fn": compose.default_parabolic_fn()})):
        if None in kw.values():
            raise AssertionError(f"{name}() is None with a card")
        for bb in (False, True):
            minplus.launches = 0
            got = compose.edtsq(lt, ANISO, bb, axis_order=order, **kw)
            if minplus.launches != 2:
                raise AssertionError(f"{name}: K1 launches {minplus.launches}")
            exact.check(f"128^3 edtsq {name} bb={bb}", got,
                        compose.edtsq(lt, ANISO, bb, parabolic_fn=plain,
                                      axis_order=order))
    exact.raise_if_failed("slice at 128^3")
    # an independent oracle: the host FH implementation (f64 intercepts)
    small = make_labels(np.random.default_rng(4), 64)
    got = et.edtsq(small, ANISO, True, device=dev)
    ref = host_reference.edtsq_host(small, ANISO, True)
    if got.shape != ref.shape or not np.allclose(got, ref, rtol=1e-5):
        raise AssertionError("64^3 edtsq disagrees with the host oracle")
    print("slice at 128^3: bit-exact to the plain path, through the default "
          "backends too; 64^3 matches the host oracle")


def phase_slice_full(exact, kernels, dev):
    """The 512^3 bench.py volume through the API: exactness, times, counts."""
    import edt_tpu_torch as et
    from edt_tpu_torch.ops import compose, core, minplus

    labels = make_labels(np.random.default_rng(42), FULL)
    vox = labels.size
    order = (2, 1, 0)
    plain = minplus.make_parabolic_fn(minplus.minplus_walls_plain)

    # the main path, counted
    torch.cuda.reset_peak_memory_stats()
    minplus.launches = 0
    out = et.edtsq(labels, ANISO, black_border=True, device=dev)
    launches = minplus.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != 2:
        raise AssertionError(f"512^3 edtsq launched K1 {launches} times, "
                             "expected 2")
    if out.shape != labels.shape or out.dtype != np.float32 \
            or not np.isfinite(out).all():
        raise AssertionError("512^3 edtsq: wrong shape, dtype or non-finite")

    lt = torch.from_numpy(labels.view(np.int32)).to(dev)
    ref = compose.edtsq(lt, ANISO, True, parabolic_fn=plain, axis_order=order)
    exact.check("512^3 edtsq vs plain", out, ref)
    del ref
    exact.raise_if_failed("slice at 512^3")

    api_ms, api_all = cuda_ms(
        lambda: et.edtsq(labels, ANISO, black_border=True, device=dev),
        reps=5)
    dev_ms, dev_all = cuda_ms(
        lambda: compose.edtsq(lt, ANISO, True, axis_order=order), reps=7)
    minplus.launches = 0
    sdf_ms, _ = cuda_ms(lambda: et.sdf(labels, ANISO, True, device=dev), reps=5, warmup=0)
    sdf_launches = minplus.launches
    occ = labels != 0
    minplus.launches = 0
    bool_ms, _ = cuda_ms(lambda: et.edtsq(occ, ANISO, True, device=dev), reps=5, warmup=0)
    bool_launches = minplus.launches
    if sdf_launches != 4 * 5 or bool_launches != 2 * 5:
        raise AssertionError(f"launch counts: sdf {sdf_launches}, bool "
                             f"{bool_launches}")

    # K1 alone on each parabolic pass's inputs: axis 1 (w = 6) after the
    # closed form along axis 2, then axis 0 (w = 6) on its output
    f = compose._along_last(lambda lab: core.rp_pass_sq(lab, ANISO[2], True),
                            2, lt)
    w2 = core.f32(ANISO[1] ** 2)
    k1_rows = []
    for axis in (1, 0):
        f2 = f.movedim(axis, -1).contiguous().reshape(-1, FULL)
        l2 = lt.movedim(axis, -1).contiguous().reshape(-1, FULL)
        ss, se = core.segment_bounds(l2)
        del l2
        k1 = lambda: minplus.minplus_walls(f2, ss, se, w2, True, True)  # noqa: E731
        ms, _ = cuda_ms(k1, reps=20, warmup=2)
        pl = lambda: minplus.minplus_walls_plain(f2, ss, se, w2, True, True)  # noqa: E731
        pms, _ = cuda_ms(pl, reps=3)
        d2 = k1()
        exact.check(f"512^3 K1 pass axis {axis} vs plain", d2, pl())
        if not torch.equal(d2.view(torch.int32), k1().view(torch.int32)):
            exact.failures.append(f"512^3 K1 pass axis {axis}: two launches "
                                  "differ")
        emul, visited, steps, warp_steps = k1_search(f2, ss, se, w2, True, True)
        exact.check(f"512^3 K1 pass axis {axis} vs its emulated search", d2,
                    emul)
        del emul
        radius = k1_candidates(f2, ss, se, w2, True, True)
        k1_rows.append((axis, ms, pms, k1_bound_ms(f2, True),
                        visited, radius, steps, warp_steps))
        f = d2.reshape(f.movedim(axis, -1).shape).movedim(-1, axis)
        del f2, ss, se, d2
    exact.raise_if_failed("K1 at 512^3")
    del f
    k1_ms, plain_ms, (bound_ms, bound_by) = k1_rows[0][1:4]

    profile(lambda: compose.edtsq(lt, ANISO, True, axis_order=order),
            f"{FULL}^3 edtsq (compose, device tensor)")
    profile(lambda: et.edtsq(labels, ANISO, black_border=True, device=dev),
            f"{FULL}^3 edtsq (API, host copies in)")

    print(f"{FULL}^3 edtsq (API, host copies in): {api_ms:.2f} ms median "
          f"of {[round(t, 2) for t in api_all]}, {vox / api_ms / 1e3:.1f} Mvox/s")
    print(f"{FULL}^3 edtsq (compose, device tensor): {dev_ms:.2f} ms median of "
          f"{[round(t, 2) for t in dev_all]}, {vox / dev_ms / 1e3:.1f} Mvox/s")
    print(f"{FULL}^3 sdf (API): {sdf_ms:.2f} ms; bool edtsq (API): "
          f"{bool_ms:.2f} ms")
    print(f"{FULL}^3 K1 launches: edtsq {launches}, sdf {sdf_launches // 5}, "
          f"bool {bool_launches // 5}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    for axis, ms, pms, (bms, by), visited, radius, steps, warp_steps in k1_rows:
        print(f"K1 pass along axis {axis} {(vox // FULL, FULL)}: {ms:.3f} ms, "
              f"plain {pms:.1f} ms, bound {bms:.3f} ms ({by}); "
              f"{visited / vox:.2f} candidates a voxel visited (rows of 512 "
              f"take the segment floor; the row radius holds "
              f"{radius / vox:.1f}) in {steps / vox:.2f} steps a target, "
              f"{warp_steps / vox:.2f} a warp's (its slowest of 32)")
    kernels.append({
        "name": "minplus_walls", "route": "cuda",
        "source": "edt_tpu_torch/csrc/minplus.cu",
        "replaces": "edt_tpu/ops/pallas_kernels.py:311",
        "launches": launches, "max_abs_err": exact.max_abs_err,
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    })


def grad_rows(rng, rows, n, w):
    """Rows of the regimes K2 has, with int16 wall counts: source-rich,
    barrier with sparse sources, equal-cost ties (sources every 10, walls
    at the same distance), walls everywhere, one all-INF row."""
    q = max(1, rows // 4)
    f = (rng.random((rows, n)) * 25 * w * w).astype(np.float32)
    f[rng.random((rows, n)) > 0.6] = 0.0
    cnt = rng.integers(1, 40, size=(rows, n)).astype(np.int16)
    cnt[rng.random((rows, n)) > 0.9] = 30000  # open sides
    f[q:2 * q] = 2.7e5 * w * w
    f[q:2 * q, ::70] = 0.0
    i = np.arange(n)
    f[2 * q:3 * q] = 1000.0 * w * w
    f[2 * q:3 * q, ::10] = 0.0
    cnt[2 * q:3 * q] = np.maximum(np.minimum(i % 10, 10 - i % 10), 1)
    cnt[3 * q:] = rng.integers(1, 4, size=cnt[3 * q:].shape)
    f[-1] = np.inf
    return f, cnt


def k2_stress_rows(rng):
    """(name, f, int16 counts, w) rows that stress K2's outward search and
    its exact stop: w2 < 1 and not dyadic, f near 3e7 (where f32 rounding
    makes neighbouring costs non-monotone), integer costs full of ties at
    both sides, equal costs at i - k and i + k far out, partly INF rows,
    and unwalled rows of barrier heights with sparse zeros."""
    cases = []

    def counts(rows, n):
        cnt = rng.integers(1, 40, size=(rows, n)).astype(np.int16)
        cnt[rng.random((rows, n)) > 0.9] = 30000  # open sides
        return cnt

    for n in (300, 2049):
        rows = 32 if n <= 512 else 8
        f = (3e7 + rng.random((rows, n)) * 200).astype(np.float32)
        f[rows // 2:, ::97] = 2.99999e7
        for w in (0.4, 1.3):
            cases.append((f"n={n} w={w} f near 3e7", f, counts(rows, n), w))
        f = rng.integers(0, 400, size=(rows, n)).astype(np.float32)
        f[rows // 2:] = 1e4  # sparse sources: ties far out
        f[rows // 2:, ::53] = rng.integers(0, 400, size=f[rows // 2:, ::53].shape)
        for w in (1.0, 2.0):
            cases.append((f"n={n} w={w} integer ties", f, counts(rows, n), w))
        # two equal sources at p - k and p + k, k up to n / 3
        f = np.full((rows, n), 1e6, np.float32)
        p = rng.integers(n // 3, 2 * n // 3, size=rows)
        k = rng.integers(1, n // 3, size=rows)
        f[np.arange(rows), p - k] = 7.0
        f[np.arange(rows), p + k] = 7.0
        cases.append((f"n={n} w=1.3 mirror ties", f, counts(rows, n), 1.3))
        f = (rng.random((rows, n)) * 900).astype(np.float32)
        f[rng.random((rows, n)) < 0.3] = np.inf
        f[1] = np.inf
        f[1, rng.integers(0, n)] = 5.0  # one finite source
        cases.append((f"n={n} w=0.4 partly INF", f, counts(rows, n), 0.4))
        f = np.full((rows, n), 2.5e8, np.float32)
        f[rng.random((rows, n)) < 0.02] = 0.0
        f[0] = 2.5e8  # no zero: radius 0
        f[2, :] = 2.5e8
        f[2, -1] = 0.0  # one zero at the end: every search crosses the row
        for w in (6.0, 30.0):
            cases.append((f"n={n} w={w} barrier sparse zeros", f,
                          counts(rows, n), w))
    return cases


def check_k3_cases(close3, dev, rng):
    """K3 against its plain version on links K2 never makes: random and
    non-monotone, every live link to one voxel, links that leave the row,
    absolute int32 argj; n = 1, 33, 300, 16001 (int32 offsets) and the
    ceiling. Rows of 16001 and more take cotangents in multiples of 1/16,
    whose sums are exact in any order. Two launches give the same bits.
    Returns the number of cases."""
    from edt_tpu_torch.ops import grad

    n_cases = 0
    for n in (1, 33, 300, 16001, grad.MAX_AXIS):
        rows = 64 if n <= 300 else (4 if n <= 16001 else 2)
        idt = torch.int16 if n <= 16000 else torch.int32
        sent = torch.iinfo(idt).min
        i = np.arange(n)
        if n <= 300:
            g = rng.uniform(-1, 1, (rows, n)).astype(np.float32)
        else:
            g = (rng.integers(-64, 64, size=(rows, n)) / 16).astype(np.float32)
        inert = rng.random((rows, n)) < 0.1
        one = rng.integers(0, n, size=(rows, 1)) - i  # every link to one voxel
        leave = np.where(rng.random((rows, n)) < 0.5, -i - 1, n - i)
        leave = np.where(rng.random((rows, n)) < 0.5, leave,
                         rng.integers(-n, n, size=(rows, n)))
        gt = torch.from_numpy(g).to(dev)
        for name, o in (("random", rng.integers(-n - 5, n + 5, size=(rows, n))),
                        ("one target", one), ("leaving the row", leave)):
            o = torch.from_numpy(np.where(inert, sent, o)).to(idt).to(dev)
            got = grad.minplus_grad(gt, offsets=o, off_sent=sent)
            close3.check(f"K3 n={n} {name}", got,
                         grad.minplus_grad_plain(gt, offsets=o, off_sent=sent))
            if not torch.equal(got, grad.minplus_grad(gt, offsets=o,
                                                      off_sent=sent)):
                close3.failures.append(f"K3 n={n} {name}: two launches differ")
            n_cases += 1
        argj = torch.from_numpy(rng.integers(-n, 2 * n, size=(rows, n))
                                .astype(np.int32)).to(dev)
        close3.check(f"K3 n={n} absolute argj", grad.minplus_grad(gt, argj=argj),
                     grad.minplus_grad_plain(gt, argj=argj))
        n_cases += 1
    return n_cases


def check_past_ceilings(exact, close3, dev):
    """K2 and K3 on rows one longer than their ceilings, in their long-row
    modes: one source a row, d = w2 k^2 and its offsets exactly; one link
    target, df = the row's sum (cotangents in multiples of 1/16: exact)."""
    from edt_tpu_torch.ops import argmin, grad

    n = argmin.MAX_AXIS + 1
    f = torch.full((2, n), float("inf"), device=dev)
    f[:, 5] = 0.0
    k = (torch.arange(n, device=dev) - 5).to(torch.float32)
    d, o = argmin.minplus_argmin(f, 1.69, None, True)
    exact.check(f"K2 n={n} one source d", d, (1.69 * (k * k)).expand(2, n))
    exact.check(f"K2 n={n} one source offsets", o,
                (5 - torch.arange(n, device=dev)).to(o.dtype).expand(2, n))
    g = torch.randint(-64, 64, (2, n), device=dev) / 16.0
    ref = torch.zeros_like(g)
    ref[:, 5] = g.sum(dim=1)
    close3.check(f"K3 n={n} one target", grad.minplus_grad(g, offsets=o), ref)


def k4_lanes(n):
    """V, the voxels a lane of K4 holds on rows a warp holds (n <= 1024):
    the least power of two with 32 V >= n."""
    v = 1
    while 32 * v < n:
        v *= 2
    return v


def k4_blocked(g, offsets, off_sent=None):
    """K4's lane-blocked scan emulated in torch: df of the closed-form
    binary pass with lane l of a warp holding the V contiguous voxels
    [l V, l V + V) of its row (``k4_lanes``). Each lane sums its own
    forward values g [o0 > 0] after its last zero site and its backward
    values g [o0 < 0] before its first; an exclusive segmented scan of the
    32 lane sums in each direction (the kernel's five shuffle steps) gives
    each lane its carry; each lane then walks its voxels in order, a zero
    site taking the running sum, forward then backward."""
    from torch.nn.functional import pad

    R, n = g.shape
    v = k4_lanes(n)
    if off_sent is not None:
        live = offsets != off_sent
        g = torch.where(live, g, 0.0)
        offsets = torch.where(live, offsets, 0)
    z = offsets == torch.iinfo(offsets.dtype).max
    o0 = torch.where(z, 0, offsets)
    extra = 32 * v - n
    gm = pad(g, (0, extra)).reshape(R, 32, v)
    zz = pad(z, (0, extra)).reshape(R, 32, v)
    oo = pad(o0, (0, extra)).reshape(R, 32, v)
    vf = torch.where(oo > 0, gm, 0.0)
    vb = torch.where(oo < 0, gm, 0.0)
    cols = list(torch.where(oo == 0, gm, 0.0).unbind(-1))
    fwd = torch.zeros_like(gm[..., 0])
    bwd = torch.zeros_like(fwd)
    for e in range(v):
        fwd = torch.where(zz[..., e], 0.0, fwd + vf[..., e])
        r = v - 1 - e
        bwd = torch.where(zz[..., r], 0.0, bwd + vb[..., r])
    flag = zz.any(dim=-1)

    def carry(val, fl):  # lanes in scan order; exclusive, reset at zeros
        s = 1
        while s < 32:
            vs, fs = pad(val[:, :-s], (s, 0)), pad(fl[:, :-s], (s, 0))
            val, fl = torch.where(fl, val, vs + val), fl | fs
            s *= 2
        return pad(val[:, :-1], (1, 0))

    run = carry(fwd, flag)
    for e in range(v):
        cols[e] = torch.where(zz[..., e], cols[e] + run, cols[e])
        run = torch.where(zz[..., e], 0.0, run + vf[..., e])
    run = carry(bwd.flip(-1), flag.flip(-1)).flip(-1)
    for r in range(v - 1, -1, -1):
        cols[r] = torch.where(zz[..., r], cols[r] + run, cols[r])
        run = torch.where(zz[..., r], 0.0, run + vb[..., r])
    return torch.stack(cols, dim=-1).reshape(R, 32 * v)[:, :n]


def k4_stress_cases(rng):
    """(name, g, offsets, off_sent) rows that stress K4's lane blocks and
    its two sweeps: zero sites on lane boundaries (every multiple of V and
    the voxel before it), on the first and last voxel only, rows with no
    zero site, rows of zero sites only, random offsets with 10 % zero
    sites and 10 % wall wins (off_sent), int16 and int32 offsets; n in
    {1, 7, 31, 33, 512, 513} (a warp a row, in registers) and 1025, 3000
    (past the register cap: the two sweeps)."""
    cases = []
    for n in (1, 7, 31, 33, 512, 513, 1025, 3000):
        rows = 24 if n <= 513 else 8
        v = k4_lanes(n) if n <= 1024 else 32
        for idt in (torch.int16, torch.int32):
            top, sent = torch.iinfo(idt).max, torch.iinfo(idt).min
            o = rng.integers(-6, 7, size=(rows, n)).astype(np.int64)
            i = np.arange(n)
            k = rows // 6
            o[:k, (i % v == 0) | (i % v == v - 1)] = top  # lane boundaries
            o[k:2 * k][rng.random((k, n)) < 0.1] = top
            # rows 2k to 3k: no zero site
            o[3 * k:4 * k] = top  # zero sites only
            o[4 * k:5 * k, [0, n - 1]] = top  # the first and last voxel
            o[5 * k:][rng.random((rows - 5 * k, n)) < 0.3] = top
            walls = rng.random((rows, n)) < 0.1
            walls[3 * k:4 * k] = False
            g = rng.uniform(-1, 1, (rows, n)).astype(np.float32)
            name = f"K4 n={n} {str(idt)[6:]}"
            cases.append((name, g, torch.from_numpy(o).to(idt), None))
            cases.append((name + " off_sent walls", g, torch.from_numpy(
                np.where(walls, sent, o)).to(idt), sent))
    return cases


def check_k4_cases(close4, dev, rng):
    """K4 against its plain version on ``k4_stress_cases``, each launched
    twice to the same bits. Returns the number of cases."""
    from edt_tpu_torch.ops import grad

    cases = k4_stress_cases(rng)
    for name, g, o, sent in cases:
        gt, ot = torch.from_numpy(g).to(dev), o.to(dev)
        got = grad.binary_grad_scan(gt, ot, off_sent=sent)
        close4.check(name, got, grad.binary_grad_scan_plain(gt, ot, sent))
        again = grad.binary_grad_scan(gt, ot, off_sent=sent)
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            close4.failures.append(f"{name}: two launches differ")
    return len(cases)


def check_grads(close3, close4, name, ft, o, w2, walls_f32, dev, rng):
    """K3 on K2's residual ``o`` and K4 on the closed-form binary pass's
    residual of the same rows, each against its plain version."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import grad

    g = torch.from_numpy(rng.uniform(-1, 1, ft.shape).astype(np.float32)).to(dev)
    sent = torch.iinfo(o.dtype).min
    close3.check(f"K3 {name}", grad.minplus_grad(g, offsets=o, off_sent=sent),
                 grad.minplus_grad_plain(g, offsets=o, off_sent=sent))
    fb = torch.where(ft <= 0, 0.0, 5e4)
    d, argj = soft._minplus_hard_binary_with_arg(fb, w2)
    for win in (None, d <= walls_f32):
        ob = soft._binary_offsets(fb, argj, win)
        s = None if win is None else sent
        close4.check(f"K4 {name} walled={win is not None}",
                     grad.binary_grad_scan(g, ob, off_sent=s),
                     grad.binary_grad_scan_plain(g, ob, off_sent=s))


def phase_grad_kernel_cases(exact, close3, close4, dev):
    """K2 against its plain version, bit-exact, over its regimes, wall
    kinds and arg encodings, the search's stress rows and its ceiling; K3
    and K4 on the residuals, within tolerance; K3 on links K2 never makes,
    and run to run; both ceilings raise beyond."""
    from edt_tpu_torch.ops import argmin, core

    rng = np.random.default_rng(11)
    cases = []
    for n in (1, 127, 300, 512, 2049):
        for w in (1.3, 6.0, 30.0):
            f, cnt = grad_rows(rng, 64 if n <= 512 else 16, n, w)
            cases.append((f"n={n} w={w}", f, cnt, w))
    rng_new = np.random.default_rng(13)
    for n in (1, 127, 300, 512, 2049):  # w2 < 1
        f, cnt = grad_rows(rng_new, 64 if n <= 512 else 16, n, 0.4)
        cases.append((f"n={n} w=0.4", f, cnt, 0.4))
    cases += k2_stress_rows(rng_new)
    n_k2 = 0
    for name, f, cnt, w in cases:
        w2 = core.f32(core.f32(w) ** 2)
        ft = torch.from_numpy(f).to(dev)
        ct = torch.from_numpy(cnt).to(dev)
        wf = argmin.walls_from_counts(ct, w2)
        c32 = torch.where(ct >= 30000, 1 << 30, ct.to(torch.int32))
        for wname, walls in (("none", None), ("f32", wf), ("int16", ct),
                             ("int32", c32)):
            for emit in (False, True):
                d, a = argmin.minplus_argmin(ft, w2, walls, emit)
                rd, ra = argmin.minplus_argmin_plain(ft, w2, walls, emit)
                exact.check(f"K2 {name} walls={wname} offsets={emit} d", d, rd)
                exact.check(f"K2 {name} walls={wname} offsets={emit} arg", a, ra)
                n_k2 += 1
        _, o = argmin.minplus_argmin(ft, w2, ct, True)
        check_grads(close3, close4, name, ft, o, w2, wf, dev, rng)
    # rows beyond int16: int32 counts and int32 offsets
    n = 16001
    f, cnt = grad_rows(rng, 4, n, 6.0)
    ft = torch.from_numpy(f).to(dev)
    c32 = torch.from_numpy(np.where(cnt >= 30000, 1 << 30,
                                    cnt.astype(np.int32))).to(dev)
    d, o = argmin.minplus_argmin(ft, 36.0, c32, True)
    rd, ro = argmin.minplus_argmin_plain(ft, 36.0, c32, True)
    exact.check("K2 n=16001 int32 d", d, rd)
    exact.check("K2 n=16001 int32 offsets", o, ro)
    if o.dtype != torch.int32:
        raise AssertionError(f"n=16001 offsets are {o.dtype}, not int32")
    check_grads(close3, close4, "n=16001", ft, o, 36.0,
                argmin.walls_from_counts(c32, 36.0), dev, rng)
    try:
        argmin.minplus_argmin(ft, 36.0, torch.from_numpy(cnt).to(dev), True)
    except ValueError:
        pass
    else:
        raise AssertionError("int16 wall counts on rows of 16001 did not raise")
    # the ceiling: one source a row, every search crosses up to the row
    n = argmin.MAX_AXIS
    f = np.full((2, n), np.inf, np.float32)
    f[0, rng_new.integers(0, n)] = 3.0
    f[1, [0, n - 2]] = 0.0  # the middle target ties far out
    ft = torch.from_numpy(f).to(dev)
    c32 = torch.full((2, n), 1 << 30, dtype=torch.int32, device=dev)
    c32[:, ::1000] = 7
    for wname, walls in (("none", None), ("int32", c32)):
        d, o = argmin.minplus_argmin(ft, 1.69, walls, True)
        rd, ro = argmin.minplus_argmin_plain(ft, 1.69, walls, True)
        exact.check(f"K2 n={n} walls={wname} d", d, rd)
        exact.check(f"K2 n={n} walls={wname} offsets", o, ro)
        n_k2 += 1
    n_k3 = check_k3_cases(close3, dev, rng_new)
    n_k4 = check_k4_cases(close4, dev, np.random.default_rng(29))
    check_past_ceilings(exact, close3, dev)
    exact.raise_if_failed("K2 vs plain")
    close3.raise_if_failed("K3 vs plain")
    close4.raise_if_failed("K4 vs plain")
    print(f"K2 vs plain: {n_k2 + 1} cases bit-exact, up to n={n}; K3 and K4 "
          f"vs plain on {len(cases) + 1} residuals, and K3 on {n_k3} more link "
          f"sets up to n={n}, each launched twice to the same bits; K4 on "
          f"{n_k4} stress cases up to n=3000 (past its register cap), each "
          f"launched twice to the same bits; within "
          f"rtol={close3.rtol}, atol={close3.atol}: max abs err K3 "
          f"{close3.max_abs_err}, K4 {close4.max_abs_err}; K2 and K3 exact "
          f"on one-source rows of {n + 1} in their long-row modes")


def fwd_bwd(labels, occ, binary_occupancy, barrier, kernels=None,
            axis_name=None):
    """bench.py's step on the port: multilabel_edtsq and the gradient of
    its sum w.r.t. the occupancy (with ``axis_name``, of a rank's slab)."""
    from edt_tpu_torch.models import soft

    occ = occ.detach().requires_grad_()
    out = soft.multilabel_edtsq(labels, occ, ANISO, black_border=True,
                                barrier=barrier, axis_name=axis_name,
                                binary_occupancy=binary_occupancy,
                                kernels=kernels or soft.KERNELS)
    (g,) = torch.autograd.grad(out.sum(), occ)
    return out.detach(), g


def grad_launches():
    from edt_tpu_torch.ops import argmin, grad

    return (argmin.launches, grad.minplus_grad_launches,
            grad.binary_grad_scan_launches)


def zero_grad_launches():
    from edt_tpu_torch.ops import argmin, grad

    argmin.launches = 0
    grad.minplus_grad_launches = 0
    grad.binary_grad_scan_launches = 0


def check_soft_slice(exact, close, dev, size, seed):
    """multilabel_edtsq fwd+bwd through the kernels against the same path
    through the plain versions, both flag sets; the forward against the
    hard edtsq. Returns the launch counts of the bench and general runs."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import compose

    labels = make_labels(np.random.default_rng(seed), size)
    lt = torch.from_numpy(labels.view(np.int32)).to(dev)
    occ = (lt != 0).to(torch.float32)
    barrier = float(np.sum((np.asarray(ANISO) * size) ** 2))
    counts = {}
    for flags, binocc in (("bench", True), ("general", False)):
        zero_grad_launches()
        out, g = fwd_bwd(lt, occ, binocc, barrier)
        counts[flags] = grad_launches()
        ref, rg = fwd_bwd(lt, occ, binocc, barrier, soft.PLAIN)
        exact.check(f"{size}^3 {flags} forward vs plain", out, ref)
        close.check(f"{size}^3 {flags} gradient vs plain", g, rg)
        print(f"  {size}^3 {flags}: gradient vs the plain path max abs err "
              f"{float((g - rg).abs().max())}, bit-equal {torch.equal(g, rg)}")
        if not (torch.isfinite(out).all() and torch.isfinite(g).all()):
            raise AssertionError(f"{size}^3 {flags}: non-finite values")
        del ref, rg
    exact.check(f"{size}^3 forward vs hard edtsq", out,
                compose.edtsq(lt, ANISO, True, axis_order=(1, 0, 2)))
    exact.raise_if_failed(f"soft slice at {size}^3")
    close.raise_if_failed(f"soft slice at {size}^3")
    return counts, labels, lt, occ, barrier


def phase_soft_small(exact, close, dev):
    counts, *_ = check_soft_slice(exact, close, dev, SMALL, 3)
    print(f"soft slice at {SMALL}^3: forward bit-exact to the plain path and to "
          f"the hard edtsq, gradients within tolerance; launches "
          f"(K2, K3, K4) bench {counts['bench']}, general {counts['general']}")


def bench_pass_inputs(lt, occ, barrier):
    """The inputs of bench.py's fwd+bwd passes at their pass shapes: step
    0's K4 offsets o0 (axis 1, closed form), and step 1's heights f1, int16
    wall counts c0 and w2 (axis 0, K2 + K3), rows (n^2, n)."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import argmin, core

    n = lt.shape[0]
    with torch.no_grad():
        f0 = (core.f32(barrier) * occ).movedim(1, -1).contiguous().reshape(-1, n)
        c1 = soft._wall_counts(lt, 1, True).movedim(1, -1).contiguous()
        c1 = c1.reshape(-1, n)
        w2 = core.f32(ANISO[1] ** 2)
        d0, argj0 = soft._minplus_hard_binary_with_arg(f0, w2)
        win0 = d0 <= argmin.walls_from_counts(c1, w2)
        o0 = soft._binary_offsets(f0, argj0, win0)
        step0 = torch.where(win0, d0, argmin.walls_from_counts(c1, w2))
        del d0, argj0, win0, f0, c1
        f1 = (step0.reshape(n, n, n).movedim(-1, 1).movedim(0, -1)
              .contiguous().reshape(-1, n))
        c0 = soft._wall_counts(lt, 0, True).movedim(0, -1).contiguous()
        c0 = c0.reshape(-1, n)
    return o0, f1, c0, core.f32(ANISO[0] ** 2)


def phase_soft_full(exact, close, close3, close4, kernels, dev):
    """bench.py's workload at 512^3: exactness, launch counts, times, each
    new kernel alone at its pass shape, and a profile."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import argmin, core, grad

    counts, labels, lt, occ, barrier = check_soft_slice(exact, close, dev,
                                                       FULL, 42)
    if counts["bench"] != (2, 2, 1) or counts["general"] != (3, 3, 0):
        raise AssertionError(f"launches (K2, K3, K4): bench {counts['bench']} "
                             f"(expected (2, 2, 1)), general "
                             f"{counts['general']} (expected (3, 3, 0))")
    vox = labels.size
    torch.cuda.reset_peak_memory_stats()
    fb_ms, fb_all = cuda_ms(lambda: fwd_bwd(lt, occ, True, barrier), reps=7)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        fwd_ms, fwd_all = cuda_ms(lambda: soft.multilabel_edtsq(
            lt, occ, ANISO, True, barrier=barrier, binary_occupancy=True),
            reps=7)
    gen_ms, gen_all = cuda_ms(lambda: fwd_bwd(lt, occ, False, barrier), reps=5)
    metric = f"{FULL}^3 multi-label anisotropic EDT fwd+bwd (1 chip)"
    print(f"bench.py metric '{metric}': {vox / fb_ms * 1e3:.1f} voxels/s")
    print(f"{FULL}^3 fwd+bwd (bench flags): {fb_ms:.2f} ms median of "
          f"{[round(t, 2) for t in fb_all]}, {vox / fb_ms / 1e3:.1f} Mvox/s; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    print(f"{FULL}^3 forward only: {fwd_ms:.2f} ms median of "
          f"{[round(t, 2) for t in fwd_all]}")
    print(f"{FULL}^3 fwd+bwd (general path): {gen_ms:.2f} ms median of "
          f"{[round(t, 2) for t in gen_all]}, {vox / gen_ms / 1e3:.1f} Mvox/s")

    # each kernel alone at its pass shape: step 0 (axis 1, closed form +
    # K4) feeds step 1 (axis 0, K2 + K3)
    o0, f1, c0, w2 = bench_pass_inputs(lt, occ, barrier)
    R = f1.shape[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    g = torch.rand((R, FULL), generator=gen, device=dev) * 2 - 1

    k2 = lambda: argmin.minplus_argmin(f1, w2, c0, True)  # noqa: E731
    k2_plain = lambda: argmin.minplus_argmin_plain(f1, w2, c0, True)  # noqa: E731
    d1, o1 = k2()
    rd, ro = k2_plain()
    exact.check("512^3 K2 pass d", d1, rd)
    exact.check("512^3 K2 pass offsets", o1, ro)
    exact.raise_if_failed("K2 at 512^3")
    del rd, ro
    k2_ms, _ = cuda_ms(k2, reps=20, warmup=2)
    k2_plain_ms, _ = cuda_ms(k2_plain, reps=3)
    walls1 = argmin.walls_from_counts(c0, w2)
    cands, steps, warp_steps = k2_search_work(f1, walls1, w2)
    radius_cands = k2_candidates(f1, walls1, w2)
    del walls1
    k2_bound = bound_ms(12 * f1.numel(), 4 * cands)
    # the same launch with no search: f = 0 gives radius 0, the same bytes
    zeros = torch.zeros_like(f1)
    k2_fixed_ms, _ = cuda_ms(lambda: argmin.minplus_argmin(zeros, w2, c0, True),
                             reps=20, warmup=2)
    del zeros

    sent = torch.iinfo(o1.dtype).min
    k3 = lambda: grad.minplus_grad(g, offsets=o1, off_sent=sent)  # noqa: E731
    k3_plain = lambda: grad.minplus_grad_plain(g, offsets=o1, off_sent=sent)  # noqa: E731
    df1 = k3()
    close3.check("512^3 K3 pass", df1, k3_plain())
    if not torch.equal(df1, k3()):
        close3.failures.append("512^3 K3 pass: two launches differ")
    del df1
    idx = torch.arange(FULL, device=dev)
    live = o1 != sent
    links = torch.where(live, idx + o1.to(torch.int64), idx)
    gm = torch.where(live, g, 0.0)
    k3_ms, _ = cuda_ms(k3, reps=20, warmup=2)
    k3_plain_ms, _ = cuda_ms(k3_plain, reps=5)
    k3_lib_ms, _ = cuda_ms(lambda: torch.zeros_like(g).scatter_add_(1, links, gm),
                           reps=20, warmup=2)
    k3_bound = bound_ms(10 * g.numel(), int(live.sum()))
    shuffles, gather_steps = k3_steps(links, live)
    del links, gm, live
    # K3 off the main path: random links (no chunk ascends: the match
    # fallback) and one target a row (31 shuffle steps a chunk)
    o_rand = torch.randint(-FULL, FULL, (R, FULL), generator=gen, device=dev,
                           dtype=torch.int16)
    k3_rand_ms, _ = cuda_ms(lambda: grad.minplus_grad(g, offsets=o_rand),
                            reps=10, warmup=1)
    o_one = (torch.randint(0, FULL, (R, 1), generator=gen, device=dev)
             - idx).to(torch.int16)
    k3_one_ms, _ = cuda_ms(lambda: grad.minplus_grad(g, offsets=o_one),
                           reps=10, warmup=1)
    del o_rand, o_one

    # K2 on unwalled rows of barrier heights (soft_edtsq without
    # black_border): the first version's radius is the whole row
    fb = (core.f32(barrier) * occ).reshape(-1, FULL)
    wb = core.f32(ANISO[2] ** 2)
    k2b = lambda: argmin.minplus_argmin(fb, wb, None, True)  # noqa: E731
    db, ob = k2b()
    rdb, rob = argmin.minplus_argmin_plain(fb, wb, None, True)
    exact.check("512^3 K2 barrier rows d", db, rdb)
    exact.check("512^3 K2 barrier rows offsets", ob, rob)
    exact.raise_if_failed("K2 on barrier rows at 512^3")
    del db, ob, rdb, rob
    k2b_ms, _ = cuda_ms(k2b, reps=10, warmup=1)
    cands_b, steps_b, warp_steps_b = k2_search_work(fb, None, wb)
    radius_b = k2_candidates(fb, None, wb)
    k2b_bound, k2b_by = bound_ms(12 * fb.numel(), 4 * cands_b)
    del fb

    k4 = lambda: grad.binary_grad_scan(g, o0, off_sent=sent)  # noqa: E731
    k4_plain = lambda: grad.binary_grad_scan_plain(g, o0, off_sent=sent)  # noqa: E731
    close4.check("512^3 K4 pass", k4(), k4_plain())
    close3.raise_if_failed("K3 at 512^3")
    close4.raise_if_failed("K4 at 512^3")
    k4_ms, _ = cuda_ms(k4, reps=20, warmup=2)
    k4_plain_ms, _ = cuda_ms(k4_plain, reps=5)
    # bytes; the scans' adds (two a voxel) are far below them
    k4_bound = bound_ms(10 * g.numel(), 2 * g.numel())

    vox1 = f1.numel()
    for name, ms, pms, (bms, by), lib, work in (
            ("K2", k2_ms, k2_plain_ms, k2_bound, None,
             f"{cands / vox1:.2f} candidates a voxel visited (the row radius "
             f"holds {radius_cands / vox1:.1f}) in {steps / vox1:.2f} steps a "
             f"target, {warp_steps / vox1:.2f} a warp's (its slowest of 32); "
             f"{k2_fixed_ms:.3f} ms with no search (f = 0)"),
            ("K3", k3_ms, k3_plain_ms, k3_bound, k3_lib_ms,
             f"{shuffles:.3f} shuffle steps a voxel (the first version's "
             f"gather scanned {gather_steps:.1f} sources a voxel); "
             f"{k3_rand_ms:.3f} ms on random links, {k3_one_ms:.3f} ms on "
             f"one target a row"),
            ("K4", k4_ms, k4_plain_ms, k4_bound, None, "two scans a voxel")):
        print(f"{name} one pass {(R, FULL)}: {ms:.3f} ms, plain {pms:.1f} ms, "
              f"bound {bms:.3f} ms ({by})"
              + (f", library scatter_add_ {lib:.3f} ms" if lib else
                 ", no one-call library equivalent") + f"; {work}")
    print(f"K2 on unwalled barrier rows {(R, FULL)} (w2 {wb:g}): {k2b_ms:.3f} "
          f"ms, bound {k2b_bound:.3f} ms ({k2b_by}), {cands_b / vox1:.2f} "
          f"candidates a voxel visited (the row radius holds "
          f"{radius_b / vox1:.1f}) in {steps_b / vox1:.2f} steps a target, "
          f"{warp_steps_b / vox1:.2f} a warp's")
    del f1, c0, o1, o0, g

    profile(lambda: fwd_bwd(lt, occ, True, barrier),
            f"{FULL}^3 multilabel_edtsq fwd+bwd (bench flags)", top=12,
            by_op=True)

    src = "edt_tpu_torch/csrc/"
    rep = "edt_tpu/ops/pallas_kernels.py:"
    for name, file, line, n, err, ms, pms, (bms, by), lib in (
            ("minplus_argmin", "argmin.cu", 1275, counts["bench"][0],
             exact.max_abs_err, k2_ms, k2_plain_ms, k2_bound, None),
            ("minplus_grad", "grad.cu", 1616, counts["bench"][1],
             close3.max_abs_err, k3_ms, k3_plain_ms, k3_bound, k3_lib_ms),
            ("binary_grad_scan", "grad.cu", 1751, counts["bench"][2],
             close4.max_abs_err, k4_ms, k4_plain_ms, k4_bound, None)):
        kernels.append({
            "name": name, "route": "cuda", "source": src + file,
            "replaces": rep + str(line), "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib})


# ---------------- slice 3: the softmin path (K5, K6) and the trainers


def softmin_rows(rng, rows, n, w2):
    """Rows of the regimes K5 and K6 have: random heights with sources, a
    plateau over sparse sources (long radii beside short ones), one all-INF
    row last."""
    q = max(1, rows // 4)
    f = (rng.random((rows, n)) * 25 * w2).astype(np.float32)
    f[rng.random((rows, n)) > 0.6] = 0.0
    if n >= 300:
        f[:q, 100:260] = 500.0 * w2
        f[:q, ::70] = 0.0
    f[-1] = np.inf
    return f


def check_k6(close6, name, f, d, g, w2, t):
    """K6 against its plain version on the same (f, d, g): df, and
    sum(g * e) within rtol=1e-3; a second launch gives the same bits."""
    from edt_tpu_torch.ops import softmin

    df, e = softmin.softmin_grad(f, d, g, w2, t)
    rdf, re = softmin.softmin_grad_plain(f, d, g, w2, t)
    close6.check(f"K6 df {name}", df, rdf)
    close6.check_sum(f"K6 sum(g e) {name}", (g * e).sum(), (g * re).sum(),
                     1e-3)
    df2, e2 = softmin.softmin_grad(f, d, g, w2, t)
    if not (torch.equal(df.view(torch.int32), df2.view(torch.int32))
            and torch.equal(e.view(torch.int32), e2.view(torch.int32))):
        close6.failures.append(f"K6 {name}: two launches differ")


def distance_net_rows(rng, rows, n, scale):
    """DistanceFieldNet-like heights: an untrained head's sigmoid
    occupancy times the barrier ``scale`` (S^2 / 2), with the smooth
    variation and the per-voxel noise of its logits, and one row of
    sigmoid(+-large) plateaus."""
    z = rng.normal(0, 1, (rows, n)) * 0.4
    z += np.cumsum(rng.normal(0, 0.05, (rows, n)), axis=1)
    z[-1] = np.where(np.arange(n) % 64 < 32, -8.0, 8.0)
    return (scale / (1 + np.exp(-z))).astype(np.float32)


def k5_stress_rows(rng):
    """(name, f, w2, t) rows that stress K5's walks and its cut: t in
    {0.01, 0.3, 1}, w2 in {0.7, 900}, heights near 3e7 (ulp 2: neighbouring
    costs round together), partly INF rows with a wholly INF row and a row
    of one finite height, and DistanceFieldNet-like rows (w2 = 1, heights
    of n^2 / 2, long windows); n in {1, 31, 33, 256, 257, 2048} (a warp a
    row) and 2049 (a block a row)."""
    cases = []
    for n in (1, 31, 33, 256, 257, 2048, 2049):
        rows = 16 if n <= 257 else 4
        for t in (0.01, 0.3, 1.0):
            for w2 in (0.7, 900.0):
                f = (3e7 + rng.random((rows, n)) * 200).astype(np.float32)
                f[rows // 2:, ::97] = 2.99999e7
                cases.append((f"n={n} t={t} w2={w2} f near 3e7", f, w2, t))
                f = (rng.random((rows, n)) * 900).astype(np.float32)
                f[rng.random((rows, n)) < 0.3] = np.inf
                f[1] = np.inf  # a wholly INF row
                f[2] = np.inf
                f[2, rng.integers(0, n)] = 5.0  # one finite height
                cases.append((f"n={n} t={t} w2={w2} partly INF", f, w2, t))
            cases.append((f"n={n} t={t} DistanceFieldNet-like",
                          distance_net_rows(rng, rows, n, n * n / 2), 1.0, t))
    return cases


def check_k5(close5, name, ft, w2, t, ref):
    """K5 against ``ref`` within close5; a second launch gives the same
    bits."""
    from edt_tpu_torch.ops import softmin

    got = softmin.softmin(ft, w2, t)
    close5.check(f"K5 {name}", got, ref)
    again = softmin.softmin(ft, w2, t)
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        close5.failures.append(f"K5 {name}: two launches differ")


def phase_softmin_kernel_cases(close5, close6, dev):
    """K5 and K6 against their plain versions over their regimes, with the
    JAX package's tolerances for its softmin kernels (close5, close6)."""
    from edt_tpu_torch.ops import softmin

    rng = np.random.default_rng(17)
    n_cases = 0
    for n in (1, 127, 300, 2049):
        rows = 48 if n <= 512 else 12
        for w2 in (1.0, 36.0, 900.0):
            for t in (0.01, 0.3, 1.0):
                name = f"n={n} w2={w2} t={t}"
                ft = torch.from_numpy(softmin_rows(rng, rows, n, w2)).to(dev)
                rd = softmin.softmin_plain(ft, w2, t)
                check_k5(close5, name, ft, w2, t, rd)
                # K6 on the finite rows: an all-INF row is NaN in the plain
                # version (INF - INF), as in the JAX package
                g = torch.from_numpy(rng.uniform(-1, 1, (rows - 1, n))
                                     .astype(np.float32)).to(dev)
                check_k6(close6, name, ft[:-1], rd[:-1], g, w2, t)
                n_cases += 1
    # DistanceFieldNet-like rows: heights of thousands, long windows
    for t in (0.01, 0.3, 1.0):
        ft = torch.from_numpy(distance_net_rows(rng, 24, 256, 256 * 256 / 2)).to(dev)
        rd = softmin.softmin_plain(ft, 1.0, t)
        check_k5(close5, f"DistanceFieldNet-like t={t}", ft, 1.0, t, rd)
        g = torch.from_numpy(rng.uniform(-1, 1, ft.shape)
                             .astype(np.float32)).to(dev)
        check_k6(close6, f"DistanceFieldNet-like t={t}", ft, rd, g, 1.0, t)
        n_cases += 1
    # one source a row, INF elsewhere: every window spans the row, and
    # d = w2 k^2, df = sum(g) at the source, e = k^2, exactly
    for n in (2049, softmin.GRAD_MAX_AXIS, softmin.MAX_AXIS):
        rows = 4 if n <= 2049 else 2
        src = rng.integers(0, n, size=rows)
        ft = torch.full((rows, n), float("inf"), device=dev)
        ft[torch.arange(rows), torch.from_numpy(src)] = 0.0
        k = (torch.arange(n, device=dev)[None, :]
             - torch.from_numpy(src).to(dev)[:, None]).to(torch.float32)
        check_k5(close5, f"one source n={n}", ft, 36.0, 0.3, 36.0 * (k * k))
        d = softmin.softmin(ft, 36.0, 0.3)
        if n > softmin.GRAD_MAX_AXIS:
            continue
        g = torch.from_numpy(rng.uniform(-1, 1, (rows, n))
                             .astype(np.float32)).to(dev)
        df, e = softmin.softmin_grad(ft, d, g, 36.0, 0.3)
        again = softmin.softmin_grad(ft, d, g, 36.0, 0.3)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip((df, e), again)):
            close6.failures.append(f"K6 one source n={n}: two launches differ")
        ref_df = torch.zeros_like(g)
        ref_df[torch.arange(rows), torch.from_numpy(src)] = g.sum(dim=1)
        close6.check(f"K6 df one source n={n}", df, ref_df)
        close6.check(f"K6 e one source n={n}", e, k * k)
    n_stress = 0
    for name, f, w2, t in k5_stress_rows(np.random.default_rng(23)):
        ft = torch.from_numpy(f).to(dev)
        check_k5(close5, name, ft, w2, t, softmin.softmin_plain(ft, w2, t))
        n_stress += 1
    # random rows at the ceiling
    n = softmin.MAX_AXIS
    ft = torch.from_numpy((rng.random((2, n)) * 900).astype(np.float32)).to(dev)
    ft[1, ::3] = float("inf")
    for w2, t in ((36.0, 0.3), (0.7, 0.01)):
        check_k5(close5, f"n={n} w2={w2} t={t}", ft, w2, t,
                 softmin.softmin_plain(ft, w2, t))
        n_stress += 1
    # one past each ceiling, in the long-row modes: K5 against the plain
    # version, K6 on one source a row
    n = softmin.MAX_AXIS + 1
    ft = torch.from_numpy((rng.random((2, n)) * 900).astype(np.float32)).to(dev)
    check_k5(close5, f"n={n} (long rows)", ft, 36.0, 0.3,
             softmin.softmin_plain(ft, 36.0, 0.3))
    n = softmin.GRAD_MAX_AXIS + 1
    ft = torch.full((2, n), float("inf"), device=dev)
    ft[:, 40] = 0.0
    k = (torch.arange(n, device=dev) - 40).to(torch.float32)
    g = torch.from_numpy(rng.uniform(-1, 1, (2, n)).astype(np.float32)).to(dev)
    df, e = softmin.softmin_grad(ft, softmin.softmin(ft, 36.0, 0.3), g, 36.0, 0.3)
    ref_df = torch.zeros_like(g)
    ref_df[:, 40] = g.sum(dim=1)
    close6.check(f"K6 df one source n={n} (long rows)", df, ref_df)
    close6.check(f"K6 e one source n={n} (long rows)", e, (k * k).expand(2, n))
    close5.raise_if_failed("K5 vs plain")
    close6.raise_if_failed("K6 vs plain")
    print(f"K5-K6 vs plain: {n_cases} cases and 3 one-source rows up to "
          f"n={softmin.MAX_AXIS} (K6 up to its ceiling n="
          f"{softmin.GRAD_MAX_AXIS}), and {n_stress} K5 stress cases up to "
          f"n={softmin.MAX_AXIS}; every case launched twice to the same "
          f"bits; both exact or within tolerance one past their ceilings, "
          f"in their long-row modes; K5 within rtol={close5.rtol}, "
          f"atol={close5.atol}: max abs err {close5.max_abs_err}; K6 df "
          f"within rtol={close6.rtol}, atol={close6.atol_rel} max|df|, "
          f"sum(g e) within rtol=1e-3: max abs err {close6.max_abs_err}")


def soft_launches():
    from edt_tpu_torch.ops import softmin

    return softmin.launches, softmin.grad_launches


def zero_soft_launches():
    from edt_tpu_torch.ops import softmin

    softmin.launches = 0
    softmin.grad_launches = 0


def value_and_grad(fn, occ, kernels):
    """fn(occ, kernels) and the gradient of its sum w.r.t. occ."""
    occ = occ.detach().requires_grad_()
    out = fn(occ, kernels)
    (g,) = torch.autograd.grad(out.sum(), occ)
    return out.detach(), g


def phase_softmin_small(close_f, close_g, dev):
    """The soft transforms at t > 0 at 128^3, forward and gradient,
    through the kernels against the plain path; launch counts."""
    from edt_tpu_torch.models import soft

    labels = make_labels(np.random.default_rng(3), SMALL)
    lt = torch.from_numpy(labels.view(np.int32)).to(dev)
    occ = (lt != 0).to(torch.float32)
    cases = (
        ("soft_edtsq t=0.3 (1, 1, 1)", (3, 3), lambda o, k: soft.soft_edtsq(
            o, (1.0, 1.0, 1.0), True, temperature=0.3, kernels=k)),
        ("multilabel_edtsq t=0.5 (6, 6, 30)", (3, 3),
         lambda o, k: soft.multilabel_edtsq(lt, o, ANISO, True,
                                            temperature=0.5, kernels=k)),
        ("soft_sdfsq t=0.3 (1, 1, 1)", (6, 6), lambda o, k: soft.soft_sdfsq(
            o, (1.0, 1.0, 1.0), True, temperature=0.3, kernels=k)),
    )
    for name, want, fn in cases:
        zero_soft_launches()
        out, g = value_and_grad(fn, occ, soft.KERNELS)
        counts = soft_launches()
        ref, rg = value_and_grad(fn, occ, soft.PLAIN)
        close_f.check(f"{SMALL}^3 {name} forward", out, ref)
        close_g.check(f"{SMALL}^3 {name} gradient", g, rg)
        if not (torch.isfinite(out).all() and torch.isfinite(g).all()):
            raise AssertionError(f"{SMALL}^3 {name}: non-finite values")
        if counts != want:
            raise AssertionError(f"{name}: launches (K5, K6) {counts}, "
                                 f"expected {want}")
        print(f"  {SMALL}^3 {name}: forward max abs err "
              f"{float((out - ref).abs().max()):.3g} (max |d| "
              f"{float(ref.abs().max()):.4g}), gradient max abs err "
              f"{float((g - rg).abs().max()):.3g} (max |grad| "
              f"{float(rg.abs().max()):.4g}); launches (K5, K6) {counts}")
    # reported, not held to K6's tolerance: at (6, 6, 30) the background
    # transform of soft_sdfsq reaches d of millions, where the f32 weights
    # exp((d - cost) / t) carry ulp(d) / t of round-off in either path
    fn = lambda o, k: soft.soft_sdfsq(o, ANISO, True, temperature=0.3,  # noqa: E731
                                      kernels=k)
    (out, g), (ref, rg) = (value_and_grad(fn, occ, k)
                           for k in (soft.KERNELS, soft.PLAIN))
    big = rg.abs() > 1e-4 * rg.abs().max()
    print(f"  {SMALL}^3 soft_sdfsq t=0.3 (6, 6, 30), reported only: forward "
          f"max rel err {float(((out - ref) / ref.abs().clamp(min=1)).abs().max()):.3g}, "
          f"gradient max rel err {float(((g - rg) / rg)[big].abs().max()):.3g} "
          f"where |grad| > 1e-4 max|grad|")
    close_f.raise_if_failed(f"softmin slice at {SMALL}^3")
    close_g.raise_if_failed(f"softmin slice at {SMALL}^3")
    print(f"softmin slice at {SMALL}^3: forward within rtol={close_f.rtol}, "
          f"atol={close_f.atol}; gradients within rtol={close_g.rtol}, "
          f"atol={close_g.atol_rel} max|grad| of the plain path")


def phase_softmin_full(close5, close6, kernels, dev):
    """benchmarks/run.py's smooth training cell: soft_edtsq fwd+bwd at
    t = 0.3 on 256^3 random occupancy; launch counts, times, each kernel
    alone at its pass shape, and a profile."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import softmin

    S = SOFT_FULL
    occ = torch.from_numpy((np.random.default_rng(42).random((S,) * 3) > 0.5)
                           .astype(np.float32)).to(dev)
    barrier = float(3 * S ** 2)
    fn = lambda o, k: soft.soft_edtsq(  # noqa: E731
        o, (1.0, 1.0, 1.0), True, barrier, SOFT_T, kernels=k)
    step = lambda: value_and_grad(fn, occ, soft.KERNELS)  # noqa: E731

    # the main path, counted
    zero_soft_launches()
    out, g = step()
    counts = soft_launches()
    if counts != (3, 3):
        raise AssertionError(f"{S}^3 softmin fwd+bwd launches (K5, K6) "
                             f"{counts}, expected (3, 3)")
    if not (torch.isfinite(out).all() and torch.isfinite(g).all()):
        raise AssertionError(f"{S}^3 softmin fwd+bwd: non-finite values")
    del out, g
    torch.cuda.reset_peak_memory_stats()
    ms, all_ms = cuda_ms(step, reps=7)
    peak = torch.cuda.max_memory_allocated()
    vox = S ** 3
    print(f"{S}^3 soft_edtsq t={SOFT_T} fwd+bwd: {ms:.2f} ms median of "
          f"{[round(x, 2) for x in all_ms]}, {vox / ms / 1e3:.1f} Mvox/s; "
          f"peak device memory {peak / 2**30:.2f} GiB")

    # each kernel alone at the second pass (axis 1), rows (S^2, S)
    with torch.no_grad():
        step0 = soft._soft_pass(barrier * occ, 1.0, True, SOFT_T)
        f1 = step0.movedim(1, -1).contiguous().reshape(-1, S)
        del step0
    gen = torch.Generator(device=dev).manual_seed(5)
    gk = torch.rand(f1.shape, generator=gen, device=dev) * 2 - 1
    k5 = lambda: softmin.softmin(f1, 1.0, SOFT_T)  # noqa: E731
    k5_plain = lambda: softmin.softmin_plain(f1, 1.0, SOFT_T)  # noqa: E731
    d1 = k5_plain()
    close5.check(f"{S}^3 K5 pass", k5(), d1)
    check_k6(close6, f"{S}^3 pass", f1, d1, gk, 1.0, SOFT_T)
    close5.raise_if_failed(f"K5 at {S}^3")
    close6.raise_if_failed(f"K6 at {S}^3")
    k6 = lambda: softmin.softmin_grad(f1, d1, gk, 1.0, SOFT_T)  # noqa: E731
    k6_plain = lambda: softmin.softmin_grad_plain(f1, d1, gk, 1.0, SOFT_T)  # noqa: E731
    k5_ms, _ = cuda_ms(k5, reps=20, warmup=2)
    k5_plain_ms, _ = cuda_ms(k5_plain, reps=3)
    k6_ms, _ = cuda_ms(k6, reps=20, warmup=2)
    k6_plain_ms, _ = cuda_ms(k6_plain, reps=3)
    exps_per_s = sfu_exps_per_s()
    k5_bound, needed5, hard5, visited5 = k5_bound_ms(f1, 1.0, SOFT_T,
                                                     exps_per_s)
    k6_bound, needed6, visited6 = k6_bound_ms(f1, d1, 1.0, SOFT_T,
                                              exps_per_s)
    vox1 = f1.numel()
    for name, ms_, pms, (bms, by, term), work in (
            ("K5", k5_ms, k5_plain_ms, k5_bound,
             f"{needed5 / vox1:.2f} pairs a voxel inside the cut (the "
             f"bound's exps), {hard5 / vox1:.1f} hard-min candidates under "
             f"the row-min floor, {visited5 / vox1:.1f} candidates a voxel "
             "visited by the kernel's walk"),
            ("K6", k6_ms, k6_plain_ms, k6_bound,
             f"{needed6 / vox1:.2f} pairs a voxel inside the cut (the bound's "
             f"exps), {visited6 / vox1:.1f} candidates a voxel in the "
             "kernel's windows")):
        print(f"{name} one pass {tuple(f1.shape)}: {ms_:.3f} ms, plain "
              f"{pms:.1f} ms, bound {bms:.3f} ms ({by}: {term}), {work}; "
              "no one-call library equivalent")
    del f1, d1, gk

    profile(step, f"{S}^3 soft_edtsq t={SOFT_T} fwd+bwd", top=12, by_op=True)

    rep = "edt_tpu/ops/pallas_kernels.py:"
    for name, line, n, err, ms_, pms, (bms, by, _) in (
            ("softmin", 2103, counts[0], close5.max_abs_err, k5_ms,
             k5_plain_ms, k5_bound),
            ("softmin_grad", 2346, counts[1], close6.max_abs_err, k6_ms,
             k6_plain_ms, k6_bound)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "edt_tpu_torch/csrc/softmin.cu",
            "replaces": rep + str(line), "launches": n, "max_abs_err": err,
            "ms": ms_, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})


def train_steps(step, feats, target, n, label):
    """n steps of ``step``; each step launches K5 and K6 three times.
    Returns the losses and the step times in ms (CUDA events)."""
    losses, times = [], []
    for i in range(n):
        zero_soft_launches()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step(feats, target)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        losses.append(float(loss))
        if soft_launches() != (3, 3):
            raise AssertionError(f"{label} step {i}: launches (K5, K6) "
                                 f"{soft_launches()}, expected (3, 3)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    return losses, times


def check_kernels_vs_plain_step(close, make, make_step, feats, target, label):
    """One training step from the same parameters through the kernels and
    through the plain path: the same loss (rtol 1e-4), the same gradients
    (rtol 1e-4, atol 1e-4 max|grad|, K6's tolerance) and the same
    parameters after the update (rtol 1e-4, atol 1e-2 lr: Adam's first
    step moves each coordinate by lr g / (|g| + eps), so a coordinate
    whose gradient is near eps moves by another fraction of lr)."""
    from edt_tpu_torch.models import soft

    results = []
    for kernels in (soft.KERNELS, soft.PLAIN):
        model, step = make_step(make(), kernels)
        zero_soft_launches()
        loss = float(step(feats, target))
        results.append((loss, soft_launches(), {
            k: (p.detach().clone(), p.grad.detach().clone())
            for k, p in model.named_parameters()}))
    (loss, counts, params), (rloss, _, rparams) = results
    if counts != (3, 3):
        raise AssertionError(f"{label}: launches (K5, K6) {counts}")
    grads = Close(1e-4, atol=0.0, atol_rel=1e-4)
    if not abs(loss - rloss) <= 1e-4 * abs(rloss):
        close.failures.append(f"{label} loss {loss} vs plain {rloss}")
    for k, (p, g) in params.items():
        grads.check(f"{label} grad {k}", g, rparams[k][1])
        close.check(f"{label} {k}", p, rparams[k][0])
    grads.raise_if_failed(label)
    close.raise_if_failed(label)
    print(f"{label}: loss {loss} (plain {rloss}); gradients max abs err "
          f"{grads.max_abs_err}; parameters within rtol={close.rtol}, "
          f"atol={close.atol}: max abs err {close.max_abs_err}")


def phase_distance_net(close, close5, close6, dev):
    """DistanceFieldNet at the widths of examples/train_distance_net.py:
    one step through the kernels against the plain path at 2 x 128^3, 5
    timed steps at 2 x 256^3 on one synthetic batch, and K5 and K6 alone on
    that step's three passes."""
    from edt_tpu_torch.models import distance_net, soft

    def make():
        gen = torch.Generator().manual_seed(0)
        return distance_net.DistanceFieldNet(8, 32, generator=gen, device=dev)

    def make_step(model, kernels, size):
        opt = torch.optim.Adam(model.parameters(), lr=3e-3,
                               betas=(0.9, 0.999), eps=1e-8)
        return model, distance_net.make_train_step(
            model, opt, temperature=SOFT_T, barrier=size * size / 2,
            kernels=kernels)

    S = TRAIN_SMALL
    feats, target = distance_net.synthetic_batch(
        np.random.default_rng(0), 2, (S,) * 3, 8, device=dev)
    check_kernels_vs_plain_step(
        close, make, lambda m, k: make_step(m, k, S), feats, target,
        f"DistanceFieldNet 2 x {S}^3 step")

    S = TRAIN_FULL
    feats, target = distance_net.synthetic_batch(
        np.random.default_rng(1), 2, (S,) * 3, 8, device=dev)
    model, step = make_step(make(), soft.KERNELS, S)
    torch.cuda.reset_peak_memory_stats()
    losses, times = train_steps(step, feats, target, 5,
                                f"DistanceFieldNet 2 x {S}^3")
    peak = torch.cuda.max_memory_allocated()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"DistanceFieldNet: loss did not drop {losses}")
    print(f"DistanceFieldNet 2 x {S}^3 (c_in 8, hidden 32, Adam 3e-3, "
          f"t={SOFT_T}, barrier {S * S / 2:g}): step {statistics.median(times[1:]):.2f} "
          f"ms median after the first, {[round(x, 2) for x in times]}; losses "
          f"{losses}; peak device memory {peak / 2**30:.2f} GiB")
    profile(lambda: step(feats, target), f"DistanceFieldNet 2 x {S}^3 step",
            top=12, by_op=True)
    distance_net_k5(close5, make_step, model, feats, target)
    distance_net_k6(close6, make_step, model, feats, target)


def distance_net_k5(close5, make_step, model, feats, target):
    """K5 alone on the DistanceFieldNet step's own three pass inputs,
    captured by a step through a recording soft.Kernels: each launch's ms,
    its bound (the pairs inside the cut), its needed, hard and visited
    counts a voxel, and its plain-version check."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import softmin

    seen = []

    def recording(f, w2, t):
        seen.append((f.clone(), w2, t))
        return softmin.softmin(f, w2, t)

    _, step = make_step(model, soft.Kernels(softmin=recording), TRAIN_FULL)
    step(feats, target)
    if len(seen) != 3:
        raise AssertionError(f"DistanceFieldNet step recorded {len(seen)} "
                             "K5 inputs, expected 3")
    exps_per_s = sfu_exps_per_s()
    times = []
    for k, (f, w2, t) in enumerate(seen):
        ref = softmin.softmin_plain(f, w2, t)
        check_k5(close5, f"DistanceFieldNet pass {k}", f, w2, t, ref)
        del ref
        ms, _ = cuda_ms(lambda: softmin.softmin(f, w2, t), reps=10,  # noqa: B023
                        warmup=2)
        pms, _ = cuda_ms(lambda: softmin.softmin_plain(f, w2, t), reps=2)  # noqa: B023
        (bms, by, term), needed, hard, visited = k5_bound_ms(f, w2, t,
                                                             exps_per_s)
        side, side_warp = k5_search(f, w2, t, floor="side")[3::2]
        _, taken, exps, _, steps, warp_steps = k5_search(f, w2, t)
        times.append(ms)
        vox = f.numel()
        print(f"K5 DistanceFieldNet pass {k} {tuple(f.shape)} (w2 {w2:g}, "
              f"t {t:g}): {ms:.3f} ms, plain {pms:.1f} ms, bound {bms:.3f} ms "
              f"({by}: {term}); a voxel: {needed / vox:.2f} pairs inside the "
              f"cut, {hard / vox:.1f} hard-min candidates under the row-min "
              f"floor, {visited / vox:.1f} visited by the walk in "
              f"{steps / vox:.1f} steps a target, {warp_steps / vox:.1f} a "
              f"warp's, {taken / vox:.2f} taken into the sum ({exps / vox:.2f} "
              f"exps); with side floors {side / vox:.1f} visited, "
              f"{side_warp / vox:.1f} warp steps")
    close5.raise_if_failed("K5 on the DistanceFieldNet passes")
    print(f"K5 on the DistanceFieldNet step's passes: mean {np.mean(times):.3f} "
          f"ms a launch, within rtol={close5.rtol}, atol={close5.atol} of the "
          "plain version, two launches the same bits")


def distance_net_k6(close6, make_step, model, feats, target):
    """K6 alone on the DistanceFieldNet step's own three pass inputs,
    captured by a step through a recording soft.Kernels: each launch's ms,
    its bound (the pairs inside the cut) and its plain-version check."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import softmin

    S = TRAIN_FULL
    seen = []

    def recording_grad(f, d, g, w2, t):
        seen.append((f.clone(), d.clone(), g.clone(), w2, t))
        return softmin.softmin_grad(f, d, g, w2, t)

    _, step = make_step(model, soft.Kernels(softmin_grad=recording_grad), S)
    step(feats, target)
    if len(seen) != 3:
        raise AssertionError(f"DistanceFieldNet step recorded {len(seen)} "
                             "K6 inputs, expected 3")
    exps_per_s = sfu_exps_per_s()
    times = []
    for k, (f, d, g, w2, t) in enumerate(seen):
        check_k6(close6, f"DistanceFieldNet pass {k}", f, d, g, w2, t)
        ms, _ = cuda_ms(lambda: softmin.softmin_grad(f, d, g, w2, t),  # noqa: B023
                        reps=10, warmup=2)
        pms, _ = cuda_ms(lambda: softmin.softmin_grad_plain(f, d, g, w2, t),  # noqa: B023
                         reps=2)
        (bms, by, term), needed, visited = k6_bound_ms(f, d, w2, t, exps_per_s)
        times.append(ms)
        print(f"K6 DistanceFieldNet pass {k} {tuple(f.shape)} (w2 {w2:g}, "
              f"t {t:g}): {ms:.3f} ms, plain {pms:.1f} ms, bound {bms:.3f} ms "
              f"({by}: {term}); {needed / f.numel():.2f} pairs a voxel inside "
              f"the cut, {visited / f.numel():.1f} candidates a voxel in the "
              "kernel's windows")
    close6.raise_if_failed("K6 on the DistanceFieldNet passes")
    print(f"K6 on the DistanceFieldNet step's passes: mean {np.mean(times):.3f} "
          f"ms a launch, within rtol={close6.rtol}, atol={close6.atol_rel} "
          "max|df| of the plain version, two launches the same bits")


def phase_unet3d(close, dev):
    """UNet3D (c_in 4, c0 8, levels 2): one step through the kernels
    against the plain path at 2 x 64^3, 3 timed steps at 2 x 128^3, and a
    bf16 forward."""
    from edt_tpu_torch.models import distance_net, soft, unet3d

    def make():
        gen = torch.Generator().manual_seed(0)
        return unet3d.UNet3D(4, 8, 2, generator=gen, device=dev)

    def make_step(model, kernels, size):
        opt = torch.optim.Adam(model.parameters(), lr=3e-3)
        return model, unet3d.make_train_step(
            model, opt, temperature=SOFT_T, barrier=size * size / 2,
            kernels=kernels)

    S = UNET_SMALL
    feats, target = distance_net.synthetic_batch(
        np.random.default_rng(2), 2, (S,) * 3, 4, device=dev)
    check_kernels_vs_plain_step(
        close, make, lambda m, k: make_step(m, k, S), feats, target,
        f"UNet3D 2 x {S}^3 step")

    S = TRAIN_SMALL
    feats, target = distance_net.synthetic_batch(
        np.random.default_rng(3), 2, (S,) * 3, 4, device=dev)
    model, step = make_step(make(), soft.KERNELS, S)
    torch.cuda.reset_peak_memory_stats()
    losses, times = train_steps(step, feats, target, 3, f"UNet3D 2 x {S}^3")
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        bf16 = unet3d.loss_fn(model, feats, target, temperature=SOFT_T,
                              barrier=S * S / 2,
                              compute_dtype=torch.bfloat16)
    if not torch.isfinite(bf16):
        raise AssertionError(f"UNet3D bf16 forward: loss {float(bf16)}")
    print(f"UNet3D 2 x {S}^3 (c_in 4, c0 8, levels 2, Adam 3e-3, "
          f"t={SOFT_T}): step {statistics.median(times[1:]):.2f} ms median "
          f"after the first, {[round(x, 2) for x in times]}; losses {losses}; "
          f"bf16 forward loss {float(bf16)}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    profile(lambda: step(feats, target), f"UNet3D 2 x {S}^3 step", top=12,
            by_op=True)
    # a yardstick, not the cell: the same steps with TF32 convolutions
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_ms, _ = cuda_ms(lambda: step(feats, target), reps=3)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    print(f"UNet3D 2 x {S}^3 step with TF32 convolutions: {tf32_ms:.2f} ms "
          "median of 3")


VG_FULL = 256  # benchmarks/run.py's voxel-graph cell, doubled to 512^3
OMNI = 0b111111


def vg_graph(rng, shape):
    """An omni graph with about 10 % of each of its +x/+y/+z bits cleared."""
    g = np.full(shape, OMNI, np.uint8)
    for bit in (0b1, 0b100, 0b10000):
        g[rng.random(shape) < 0.1] &= np.uint8(~bit & 0xFF)
    return g


K1_SAMPLE = 1 << 22  # voxels of a pass that k1_alone_on_passes emulates


def k1_alone_on_passes(exact, label, lt, aniso, bb, binary):
    """K1 alone on each parabolic pass of ``compose.edtsq``'s default order
    (the closed form along axis 2, K1 along axes 1 then 0): each pass
    bit-exact to the plain version and, on its rows or past ``K1_SAMPLE``
    voxels on evenly spaced rows, to the emulated search (``k1_search``);
    ms a pass (median and range of 10), the byte bound, the floor the
    kernel takes, and the candidates a voxel visited and the steps a
    target and a warp's on those rows under two floors: binary, the row
    floor K1 takes and the chunk floors it does not
    (``k1_search(floor="chunk")``); masked, the row floor and the segment
    floor, and the ms of the same rows and labels with f = 0 (every
    target stops at k = 1: the pass with no search)."""
    from edt_tpu_torch.ops import compose, core, minplus

    f = compose._along_last(
        lambda lab: core.rp_pass_sq(lab, aniso[2], bb), 2, lt)
    for axis in (1, 0):
        n = lt.shape[axis]
        f2 = f.movedim(axis, -1).contiguous().reshape(-1, n)
        ss = se = None
        if not binary:
            ss, se = core.segment_bounds(
                lt.movedim(axis, -1).contiguous().reshape(-1, n))
        w = core.f32(aniso[axis])
        w2 = core.f32(w * w)
        k1 = lambda: minplus.minplus_walls(f2, ss, se, w2, bb, not binary)  # noqa: E731
        ms, runs = cuda_ms(k1, reps=10)
        d2 = k1()
        exact.check(f"{label} K1 pass axis {axis} vs plain", d2,
                    minplus.minplus_walls_plain(f2, ss, se, w2, bb,
                                                not binary))
        every = max(1, f2.numel() // K1_SAMPLE)
        x = [None if t is None else t[::every].contiguous()
             for t in (f2, ss, se)]
        floors = ("row", "chunk") if binary else ("row", "segment")
        emul = [k1_search(*x, w2, bb, not binary, floor=fl) for fl in floors]
        for fl, run in zip(floors, emul):
            exact.check(f"{label} K1 pass axis {axis} vs its emulated search "
                        f"({fl} floor)", d2[::every], run[0])
        took = ("segment" if minplus.segment_floor(n, not binary) else "row")
        extra = ""
        if not binary:  # the same rows and labels with no search
            z = torch.zeros_like(f2)
            zms, zruns = cuda_ms(
                lambda: minplus.minplus_walls(z, ss, se, w2, bb, True), reps=10)
            extra = (f"; f = 0 (no search) {zms:.3f} ms "
                     f"[{min(zruns):.3f}-{max(zruns):.3f}]")
            del z
        bms, by = k1_bound_ms(f2, not binary)
        vox = x[0].numel()
        (a, b) = emul
        print(f"{label}: K1 pass along axis {axis} {tuple(f2.shape)}: "
              f"{ms:.3f} ms [{min(runs):.3f}-{max(runs):.3f}], bound "
              f"{bms:.3f} ms ({by}){extra}; the kernel takes the {took} "
              f"floor; {floors[0]} ({floors[1]}) floor: {a[1] / vox:.2f} "
              f"({b[1] / vox:.2f}) candidates a voxel visited, "
              f"{a[2] / vox:.2f} ({b[2] / vox:.2f}) steps a target, "
              f"{a[3] / vox:.2f} ({b[3] / vox:.2f}) a warp's"
              + (f" (one row in {every})" if every > 1 else ""))
        f = d2.reshape(f.movedim(axis, -1).shape).movedim(-1, axis)
        del f2, d2, emul, x, ss, se
    return f


def phase_voxel_graph(exact, dev):
    """The voxel-graph transform at 256^3 (512^3 doubled) through the
    NumPy API, bit-exact against the volume doubled on the host, run
    through the plain parabolic pass on the card and subsampled; K1
    launched twice a transform."""
    import edt_tpu_torch as et
    from edt_tpu_torch.ops import compose, minplus
    from edt_tpu_torch.ops import voxel_graph as vg

    S = VG_FULL
    plain = minplus.make_parabolic_fn(minplus.minplus_walls_plain)
    rng = np.random.default_rng(11)
    cases = [("omni ones", np.ones((S,) * 3, np.uint8),
              np.full((S,) * 3, OMNI, np.uint8), (1.0, 1.0, 1.0)),
             ("multi-label, random graph", make_labels(rng, S),
              vg_graph(rng, (S,) * 3), ANISO)]
    for name, data, graph, aniso in cases:
        label = f"{S}^3 voxel graph, {name}, {aniso}"
        torch.cuda.reset_peak_memory_stats()
        minplus.launches = 0
        out = et.edtsq(data, aniso, True, voxel_graph=graph, device=dev)
        launches = minplus.launches
        peak = torch.cuda.max_memory_allocated()
        if launches != 2:
            raise AssertionError(f"{label}: K1 launched {launches} times, "
                                 "expected 2")
        if out.shape != data.shape or out.dtype != np.float32 \
                or not np.isfinite(out).all():
            raise AssertionError(f"{label}: wrong shape, dtype or non-finite")
        D = torch.from_numpy(vg._doubled_3d((data != 0).astype(np.uint8),
                                            graph, True)).to(dev)
        half = [a / 2 for a in aniso]
        ref = compose.edtsq(D, half, True, binary=True,
                            parabolic_fn=plain)[::2, ::2, ::2]
        k1_alone_on_passes(exact, label, D, half, True, True)
        del D
        exact.check(label, out, ref)
        lt = torch.from_numpy(data.view(np.int32) if data.dtype == np.uint32
                              else data).to(dev)
        gt = torch.from_numpy(graph).to(dev)
        native = lambda: vg.edtsq_voxel_graph_torch(lt, gt, aniso, True)  # noqa: E731
        exact.check(f"{label}, device-native", native(), ref)
        del ref
        api_ms, api_all = cuda_ms(
            lambda: et.edtsq(data, aniso, True, voxel_graph=graph,
                             device=dev), reps=3)
        dev_ms, dev_all = cuda_ms(native, reps=5)
        print(f"{label}: API {api_ms:.2f} ms median of "
              f"{[round(t, 2) for t in api_all]}; device tensors "
              f"(edtsq_voxel_graph_torch) {dev_ms:.2f} ms median of "
              f"{[round(t, 2) for t in dev_all]}; K1 launches {launches}; "
              f"peak device memory {peak / 2**30:.2f} GiB")
        profile(native, f"{label} (device tensors)")
        profile(lambda: et.edtsq(data, aniso, True, voxel_graph=graph,
                                 device=dev), f"{label} (API)")
    exact.raise_if_failed("voxel graph")
    print(f"vg: {S}^3 bit-exact to the host-doubled plain reference")


K1_FLOOR_BALL = 240  # binary_edtsq's cell: a solid ball of this radius in FULL^3
K1_FLOOR_BENCH = 768  # bench.py's volume at 768^3: rows past 512 on one card
K1_FLOOR_CHUNK = (1024, 1024, 128)  # a connectomics task chunk: rows of 1024


def phase_k1_floor(exact, dev):
    """K1 on the rows where its floor decides the walk (``k1_alone_on_
    passes``: each pass bit-exact, its ms, bound and both floors' counts):
    ``binary_edtsq`` of a FULL^3 solid ball at (1, 1, 1) and ANISO (the
    scipy drop-in case), the background pass of bench.py's ``sdf`` at
    FULL^3, bench.py's volume at 768^3 (rows of 768: groups of two warps)
    and a 1024 x 1024 x 128 chunk of its labels in 32-voxel blocks (rows
    of 1024), both masked with the f = 0 yardstick; the API's
    ``binary_edtsq`` on the ball and ``compose.edtsq`` on the 768^3 device
    tensor, timed, their K1 launches counted, the latter bit-exact to the
    passes checked one by one."""
    import edt_tpu_torch as et
    from edt_tpu_torch.ops import compose, minplus

    S, r = FULL, K1_FLOOR_BALL
    i = torch.arange(S, device=dev, dtype=torch.float32) - S // 2
    ball = ((i[:, None, None] ** 2 + i[None, :, None] ** 2
             + i[None, None, :] ** 2) < r * r).to(torch.uint8)
    for aniso in ((1.0, 1.0, 1.0), ANISO):
        k1_alone_on_passes(exact, f"{S}^3 ball r={r} {aniso}", ball, aniso,
                           True, True)
    occ = ball.bool().cpu().numpy()
    del ball
    minplus.launches = 0
    out = et.binary_edtsq(occ, ANISO, True, device=dev)
    if minplus.launches != 2 or not np.isfinite(out).all():
        raise AssertionError(f"ball binary_edtsq: K1 launched "
                             f"{minplus.launches} times or non-finite")
    api_ms, api_all = cuda_ms(
        lambda: et.binary_edtsq(occ, ANISO, True, device=dev), reps=3)
    print(f"{S}^3 ball binary_edtsq (API) {ANISO}: {api_ms:.2f} ms median "
          f"of {[round(t, 2) for t in api_all]}, K1 launches 2")
    del occ, out
    labels = make_labels(np.random.default_rng(42), S)
    lt = torch.from_numpy(labels.view(np.int32)).to(dev)
    k1_alone_on_passes(exact, f"{S}^3 sdf background", (lt == 0).to(
        torch.uint8), ANISO, True, True)
    del labels, lt
    B = K1_FLOOR_BENCH
    lt = torch.from_numpy(make_labels(np.random.default_rng(42), B)
                          .view(np.int32)).to(dev)
    ref = k1_alone_on_passes(exact, f"{B}^3 bench volume", lt, ANISO, True,
                             False)
    minplus.launches = 0
    out = compose.edtsq(lt, ANISO, True)
    if minplus.launches != 2:
        raise AssertionError(f"{B}^3 compose.edtsq: K1 launched "
                             f"{minplus.launches} times, expected 2")
    exact.check(f"{B}^3 compose.edtsq vs its passes", out, ref)
    del out, ref
    dms, druns = cuda_ms(lambda: compose.edtsq(lt, ANISO, True), reps=5)
    print(f"{B}^3 bench volume, compose.edtsq on a device tensor: "
          f"{dms:.2f} ms median of {[round(t, 2) for t in druns]}, K1 "
          f"launches 2")
    del lt
    torch.cuda.empty_cache()
    shape = K1_FLOOR_CHUNK
    lt = torch.from_numpy(block_labels(np.random.default_rng(42), shape)
                          .view(np.int32)).to(dev)
    k1_alone_on_passes(exact, "x".join(map(str, shape)) + " chunk, 32-voxel "
                       "blocks", lt, ANISO, True, False)
    del lt
    torch.cuda.empty_cache()
    exact.raise_if_failed("k1_floor")
    print("k1_floor: every pass bit-exact to the plain version and to the "
          "emulated search")


def snemi_labels(rng):
    """benchmarks/run.py's per-label cell: 512 x 512 x 100 uint16, labels
    1..334 in 32 x 32 x 20 blocks (SNEMI3D-like)."""
    nl = rng.integers(1, 335, size=(512 // 32, 512 // 32, 100 // 20))
    return np.kron(nl, np.ones((32, 32, 20), np.int16)).astype(np.uint16)


def phase_each(exact, dev):
    """Per-label extraction of the SNEMI3D-like cell: edt on the card, then
    the host RLE kit's each (native), torch_api.each_device and
    extract_labels in chunks of 32 on the card; every label's image equal
    across the three."""
    import edt_tpu_torch as et
    from edt_tpu_torch import api, rle, torch_api
    from edt_tpu_torch.ops import minplus

    aniso = (6.0, 6.0, 30.0)
    lab = snemi_labels(np.random.default_rng(0))
    minplus.launches = 0
    mdt = et.edt(lab, aniso, True, device=dev)
    launches = minplus.launches
    if launches != 2:
        raise AssertionError(f"each: edt launched K1 {launches} times")
    if not np.isfinite(mdt).all():
        raise AssertionError("each: edt is not finite")
    edt_ms, _ = cuda_ms(lambda: et.edt(lab, aniso, True, device=dev), reps=3)
    backend = rle.backend()
    print(f"each: RLE backend {backend}")
    if backend != "native":
        raise AssertionError("each: the native RLE kit did not build")
    t0 = time.perf_counter()
    count = sum(1 for _ in et.each(lab, mdt, in_place=True))
    host_s = time.perf_counter() - t0

    lab_d = torch.from_numpy(api._as_device_labels(lab)).to(dev)
    dt_d = torch.from_numpy(mdt).to(dev)
    ids = [u for u in torch.unique(lab_d).tolist() if u != 0]
    if len(ids) != count:
        raise AssertionError(f"each: {count} host labels, {len(ids)} device")

    def device_each():
        last = None
        for _, img in torch_api.each_device(lab_d, dt_d):
            last = img
        return last

    def batched():
        for c0 in range(0, len(ids), 32):
            stack = torch_api.extract_labels(lab_d, dt_d, ids[c0:c0 + 32])
        return stack

    dev_ms, _ = cuda_ms(device_each, reps=2)
    batch_ms, _ = cuda_ms(batched, reps=2)
    host_it = iter(et.each(lab, mdt, in_place=True))
    dev_it = torch_api.each_device(lab_d, dt_d)
    for c0 in range(0, len(ids), 32):
        stack = torch_api.extract_labels(lab_d, dt_d, ids[c0:c0 + 32])
        for k, slab in zip(ids[c0:c0 + 32], stack):
            hk, himg = next(host_it)
            dk, dimg = next(dev_it)
            if not hk == dk == k:
                raise AssertionError(f"each: labels {hk}, {dk}, {k} differ")
            himg = torch.tensor(himg, device=dev)  # a copy of the buffer
            if not (torch.equal(himg, dimg) and torch.equal(himg, slab)):
                exact.failures.append(f"each: label {k} differs")
    exact.raise_if_failed("each")
    print(f"each {'x'.join(map(str, lab.shape))} uint16, {count} labels, "
          f"{aniso}: edt (API) "
          f"{edt_ms:.2f} ms (K1 launches {launches}); host each (native "
          f"RLE, in place) {host_s * 1e3:.1f} ms; each_device "
          f"{dev_ms:.2f} ms; extract_labels in chunks of 32 {batch_ms:.2f} "
          "ms; every label's image equal across the three")


def phase_export(exact, dev):
    """export_transform of the 512^3 forward, serialized and loaded, run on
    bench.py's labels: bit-equal to compose.edtsq, K1 launched twice."""
    from edt_tpu_torch.ops import compose, minplus
    from edt_tpu_torch.utils import export as edt_export
    from edt_tpu_torch.utils import profiling

    shape = (FULL,) * 3
    t0 = time.perf_counter()
    data = edt_export.serialize_transform(shape, np.uint32, anisotropy=ANISO,
                                          black_border=True, device=dev)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = edt_export.load(data)
    load_s = time.perf_counter() - t0
    labels = make_labels(np.random.default_rng(42), FULL)
    lt = torch.from_numpy(labels.view(np.int32)).to(dev)
    minplus.launches = 0
    out = run(lt)
    launches = minplus.launches
    if launches != 2:
        raise AssertionError(f"export: K1 launched {launches} times")
    exact.check("exported 512^3 edtsq", out, compose.edtsq(lt, ANISO, True))
    exact.raise_if_failed("export")
    run_ms, run_all = cuda_ms(lambda: run(lt), reps=5)
    ref_ms, ref_all = cuda_ms(lambda: compose.edtsq(lt, ANISO, True), reps=5)
    tp = profiling.throughput(lambda x: compose.edtsq(x, ANISO, True), lt,
                              iters=5)
    print(f"export {FULL}^3 edtsq: export and serialize {export_s:.2f} s "
          f"({len(data)} bytes), load {load_s:.2f} s, run {run_ms:.2f} ms "
          f"median of {[round(t, 2) for t in run_all]} (K1 launches "
          f"{launches}), bit-equal to compose.edtsq: {ref_ms:.2f} ms median "
          f"of {[round(t, 2) for t in ref_all]}; profiling.throughput of "
          f"compose.edtsq {tp['seconds_per_call'] * 1e3:.2f} ms a call, "
          f"{tp['voxels_per_second'] / 1e6:.1f} Mvox/s")


# ---------------- slice 9: rows past the shared-memory ceilings (B5) and
# the exported gradient (A5b)

LONG_N = (58049, 65536)  # K1, K2, K3, K5: one past their ceiling, and 2^16
LONG_N6 = (29025, 40000)  # K6: one past its ceiling, and the soft volume's
LONG_ROWS = 8
LONG_MANY = 256  # the rows of LONG_VOLUME's and LONG_SOFT[0]'s long passes
LONG_VOLUME = (16, 16, 65536)  # multilabel_edtsq, bench flags
LONG_SOFT = ((16, 16, 40000), (4, 4, 65536))  # soft_edtsq at t = SOFT_T
LONG_VG = ((2, 8, 32768), (32768, 8, 2))  # doubled axis 65536
SRC = "edt_tpu_torch/csrc/"
REP = "edt_tpu/ops/pallas_kernels.py:"


def long_launches():
    """Launches in the long-row modes: K1, K2, K5 (their second
    instantiations), K3 and K6 (their row-split kernels, each followed by
    one launch of the one-warp kernel: ``one_warp``)."""
    from edt_tpu_torch.ops import argmin, grad, minplus, softmin

    return {"K1": minplus.long_launches, "K2": argmin.long_launches,
            "K3": grad.minplus_grad_split_launches,
            "K5": softmin.long_launches, "K6": softmin.grad_split_launches}


def zero_long_launches():
    from edt_tpu_torch.ops import argmin, grad, minplus, softmin

    minplus.long_launches = argmin.long_launches = 0
    grad.minplus_grad_split_launches = grad.minplus_grad_long_launches = 0
    softmin.long_launches = 0
    softmin.grad_split_launches = softmin.grad_long_launches = 0


def one_warp(k):
    """K3's or K6's last long-row call: (one-warp launches since the
    counts were zeroed, rows of that call the one-warp mode took, its
    rows). The rest took the row-split mode."""
    from edt_tpu_torch.ops import grad, softmin

    mod, launches = ((grad, grad.minplus_grad_long_launches) if k == "K3"
                     else (softmin, softmin.grad_long_launches))
    marks = mod.last_one_warp_rows
    return launches, int(marks.sum()), marks.numel()


def mode_shares(k):
    """The share of the last long-row call's rows each mode took."""
    _, marked, rows = one_warp(k)
    return (f"{k} rows: row-split {rows - marked} of {rows}, one-warp "
            f"{marked}")


def long_label_rows(rng, rows, n, run=32):
    """(f, labels): heights 0..900 over runs of labels 0..5, ``run`` voxels
    each (make_labels' block width at 512^3), f zeroed at background as a
    pass receives it."""
    lab = np.repeat(rng.integers(0, 6, size=(rows, n // run + 1)), run,
                    axis=1)[:, :n].astype(np.int32)
    f = (rng.random((rows, n)) * 900).astype(np.float32)
    return np.where(lab == 0, np.float32(0), f), lab


def long_soft_rows(rng, rows, n):
    """Heights 0..900 with 30 % zeros (sources)."""
    f = (rng.random((rows, n)) * 900).astype(np.float32)
    f[rng.random((rows, n)) < 0.3] = 0.0
    return f


def soft_needed(f, w2, t, d=None):
    """Pairs inside each target's cut over ``minplus.plain_chunks`` (rows of
    any length): K5's, cost - dmin_i <= 30 t with dmin the chunk's hard
    min; K6's, d_i - cost >= -30 t, when ``d`` is given."""
    from edt_tpu_torch.ops import minplus

    R, n = f.shape
    cut = soft_cut(t)
    needed = 0
    for r0, r1, i0, i1 in minplus.plain_chunks(R, n):
        cost = f[r0:r1, None, :] + minplus.quad_rows(i0, i1, n, w2, f.device)
        if d is None:
            needed += int(((cost - cost.amin(dim=-1, keepdim=True)) <= cut)
                          .sum())
        else:
            needed += int(((d[r0:r1, i0:i1, None] - cost) >= -cut).sum())
        del cost
    return needed


# csrc/grad.cu kSplitTile: sources a tile of K3's row-split mode, at most
# (the kernel halves it on few rows, which changes no value)
K3_TILE = 1024
K6_TILE = K6_HALO = 256  # csrc/softmin.cu kTile6, kHalo6


def k3_targets(offsets, off_sent):
    """K3's targets i + o of int16/int32 link offsets, -1 where a source is
    inert (``off_sent``) or its link leaves the row."""
    n = offsets.shape[-1]
    o = offsets.to(torch.int64)
    t = torch.arange(n, device=offsets.device) + o
    return torch.where((o != off_sent) & (t >= 0) & (t < n), t, -1)


def _k3_split_row(g, t, tile):
    """One row of ``k3_split``; None where a tile finds a descent."""
    n = t.shape[0]
    df = np.zeros(n, np.float32)
    live_at = np.nonzero(t >= 0)[0]
    for a in range(0, n, tile):
        b = min(n, a + tile)
        live = live_at[(live_at >= a) & (live_at < b)]
        if not live.size:
            continue
        before = live_at[live_at < a]  # the run open before the tile
        tc, sc, own = (int(t[before[-1]]) if before.size else -1), None, False
        for i in live:
            if t[i] < tc:
                return None
            if t[i] == tc:
                sc = np.float32(sc + g[i]) if own else sc
                continue
            if own:
                df[tc] = sc
            tc, sc, own = int(t[i]), np.float32(np.float32(0) + g[i]), True
        if not own:
            continue
        for i in live_at[live_at >= b]:  # the owned run, on past the tile
            if t[i] != tc:
                if t[i] < tc:
                    return None
                break
            sc = np.float32(sc + g[i])
        df[tc] = sc
    return df


def k3_split(g, targets, tile=K3_TILE):
    """K3's row-split mode emulated on the host: (df, marks). Each tile of
    ``tile`` sources sums the runs of equal targets whose first live
    source it holds, in ascending i onto 0.0 in f32, reading on past its
    end for the last one, and skips the run open before it (the target of
    the nearest live source before it); a descent, from that source to the
    first live one after the tile's own last run, marks the row, which
    then takes the one-warp mode: every target's sources summed onto 0.0
    in ascending i. ``targets``: ``k3_targets``."""
    gn = g.detach().cpu().numpy()
    tn = targets.cpu().numpy()
    R, n = tn.shape
    df = np.zeros((R, n), np.float32)
    marks = np.zeros(R, np.int32)
    for r in range(R):
        row = _k3_split_row(gn[r], tn[r], tile)
        if row is None:
            marks[r] = 1
            row = np.zeros(n, np.float32)
            for i in np.nonzero(tn[r] >= 0)[0]:
                row[tn[r, i]] = np.float32(row[tn[r, i]] + gn[r, i])
        df[r] = row
    return torch.from_numpy(df), torch.from_numpy(marks)


def k3_split_rows(rng, n, tile=K3_TILE):
    """(g, int32 offsets, off_sent, marks K3's row-split mode must give) of
    eight rows that stress it at tiles of ``tile`` sources: (0) runs of
    0.7 tile crossing tile ends; (1) one target for the whole row, a run
    longer than a tile; (2) runs of 1 to 8 with inert sources around every
    tile end and links that leave the row at both ends; (3) ascending but
    one descent just past a tile end; (4) random targets; (5) every source
    inert; (6) one live source, mid-row; (7) a run that starts a tile
    before a stretch of two inert tiles and goes on after it. Cotangents
    of magnitudes 1e-4 to 1e4, so a sum in another order shows."""
    i = np.arange(n)
    run = max(1, int(0.7 * tile))
    t = np.empty((8, n), np.int64)
    live = np.ones((8, n), bool)
    t[0] = np.minimum(n - 1, (i // run) * run + run // 2)
    t[1] = n // 2
    t[2] = np.minimum(n - 1, np.cumsum(rng.integers(0, 8, n) == 0))
    live[2] = (rng.random(n) < 0.8) & (np.abs((i + 4) % tile - 4) > 3)
    t[2, :5] = -3  # links leave the row
    t[2, -5:] = n + 2
    t[3] = np.minimum(n - 1, i // 3)
    t[3, tile + 2] = max(0, t[3, tile + 2] - 50)
    t[4] = rng.integers(0, n, n)
    live[5] = False
    t[6] = n // 3
    live[6] = i == n // 2
    t[7] = np.minimum(n - 1, i // 2 + 1)
    live[7] &= (i < tile + tile // 2) | (i >= 3 * tile + tile // 2)
    t[7, tile: 4 * tile] = t[7, tile]
    off_sent = np.iinfo(np.int32).min
    o = np.where(live, t - i, off_sent).astype(np.int32)
    g = (rng.uniform(-1, 1, (8, n))
         * 10.0 ** rng.uniform(-4, 4, (8, n))).astype(np.float32)
    marks = np.array([0, 0, 0, 1, 1, 0, 0, 0], np.int32)
    return g, o, off_sent, marks


def k6_split(f, d, g, w2, t, tile=K6_TILE, halo=K6_HALO):
    """K6's row-split mode emulated with torch on the host: (df, e, marks).
    Each tile of ``tile`` targets takes the row's min f, bounds its windows
    by its largest gap d_i + 30 t - min f (reach = floor(sqrt(gap / w2)) +
    2, staged halo hw = min(reach, ``halo``)), sums Z_i and e_i over the
    pairs inside each window's cut (f32 tests as the kernel rounds them,
    exact exps), and scatters (g_i / Z_i) p_ij onto its span; a pair past
    hw marks the row, which takes the plain version (the one-warp mode's
    values). The tile keeps its own targets' df and a halo on each side as
    wide as its farthest pair; each tile then adds the right halo of the
    tile before it and the left halo of the tile after it, as far as they
    reach."""
    from edt_tpu_torch.ops import core, softmin

    f, d, g = (x.detach().cpu() for x in (f, d, g))
    R, n = f.shape
    w2, t = core.f32(w2), core.f32(t)
    cut = torch.tensor(30.0 * t, dtype=torch.float32)
    scale = torch.tensor(1.4426950408889634 / t, dtype=torch.float32)
    w2t = torch.tensor(w2, dtype=torch.float32)
    df = torch.zeros(R, n)
    e = torch.zeros(R, n)
    marks = torch.zeros(R, dtype=torch.int32)
    j = torch.arange(n)
    tiles = -(-n // tile)
    for r in range(R):
        minf = f[r].min()
        own, left, right, width = [], [], [], []
        for a in range(0, n, tile):
            b = min(n, a + tile)
            i = torch.arange(a, b)
            gap = (d[r, a:b] + cut) - minf
            ratio = float(torch.nan_to_num(gap, nan=-1.0).max() / w2t)
            reach = (0 if not ratio >= 0 else n if ratio >= float(n) * n
                     else int(ratio ** 0.5) + 2)
            hw = min(reach, halo)
            k = (i[:, None] - j[None, :]).abs()
            q = w2t * (k * k).to(torch.float32)
            x = d[r, a:b, None] - (f[r][None, :] + q)
            pair = (q <= gap[:, None]) & (x >= -cut)
            p = torch.where(pair, torch.exp2(x * scale).double(), 0.0)
            kin = torch.where(pair, k, -1).amax(dim=1)
            if int(kin.max()) > hw:
                marks[r] = 1
                break
            z = p.sum(dim=1)
            gz = torch.where(z > 0, g[r, a:b].double() / z, 0.0)
            e[r, a:b] = torch.where(z > 0, (p * (k * k)).sum(dim=1) / z,
                                    0.0).float()
            part = (gz[:, None] * p).sum(dim=0).float()
            h = max(0, int(kin.max()))
            own.append(part[a:b])
            left.append(part[max(0, a - h):a])
            right.append(part[b:b + h])
            width.append(h)
        if marks[r]:
            df[r], e[r] = (v[0] for v in softmin.softmin_grad_plain(
                f[r:r + 1], d[r:r + 1], g[r:r + 1], w2, t))
            continue
        for s in range(tiles):
            a, b = s * tile, min(n, s * tile + tile)
            row = own[s].clone()
            if s > 0:
                hl = min(width[s - 1], b - a)
                row[:hl] += right[s - 1][:hl]
            if s + 1 < tiles:
                hr = min(width[s + 1], b - a)
                if hr:
                    row[b - a - hr:] += left[s + 1][-hr:]
            df[r, a:b] = row
    return df, e, marks


def long_kernel_cases(exact, close3, close5, close6, dev):
    """Each long-row mode against its plain version past its ceiling (K1
    and K2 bit-exact, K3, K5 and K6 within the kernel phases' tolerances),
    each mode forced at its ceiling against the shared-memory mode on the
    same rows, and the times a voxel of both. Returns the JSON rows'
    numbers at n = 65536 (K6: 40000)."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import argmin, core, grad, minplus, softmin

    rng = np.random.default_rng(31)
    R, w2, t = LONG_ROWS, 36.0, SOFT_T
    exps_per_s = sfu_exps_per_s()
    rows = {}
    for n in (minplus.MAX_AXIS,) + LONG_N:
        f, lab = long_label_rows(rng, R, n)
        if n > minplus.MAX_AXIS:  # K1, both layouts, both borders
            check_k1(exact, f"K1 long rows n={n}", f, lab, w2, dev)
        ft = torch.from_numpy(f).to(dev)
        lt = torch.from_numpy(lab).to(dev)
        ss, se = core.segment_bounds(lt)
        cnt = soft._wall_counts(lt, 1, True).contiguous()
        if cnt.dtype != torch.int32:  # past I16_MAX_AXIS, counts and
            raise AssertionError(f"n={n}: wall counts {cnt.dtype}")  # links int32
        g = torch.from_numpy(rng.uniform(-1, 1, (R, n)).astype(np.float32)).to(dev)
        fs = torch.from_numpy(long_soft_rows(rng, R, n)).to(dev)
        k1 = lambda lr: minplus.minplus_walls(  # noqa: E731
            ft, ss, se, w2, True, True, _long_rows=lr)
        k2 = lambda lr: argmin.minplus_argmin(  # noqa: E731
            ft, w2, cnt, True, _long_rows=lr)
        d2, o2 = k2(True)
        if o2.dtype != torch.int32:
            raise AssertionError(f"K2 n={n}: offsets {o2.dtype}")
        sent = torch.iinfo(o2.dtype).min
        k3 = lambda lr: grad.minplus_grad(  # noqa: E731
            g, offsets=o2, off_sent=sent, _long_rows=lr)
        k5 = lambda lr: softmin.softmin(fs, w2, t, _long_rows=lr)  # noqa: E731
        if n == minplus.MAX_AXIS:  # the two modes on the same rows
            for name, fn, chk in (("K1", k1, exact), ("K2", k2, exact),
                                  ("K3", k3, exact), ("K5", k5, close5)):
                outs = zip(*(o if isinstance(o, tuple) else (o,)
                             for o in (fn(True), fn(False))))
                for a, b in outs:
                    chk.check(f"{name} n={n} long mode vs shared memory", a, b)
                short_ms, _ = cuda_ms(lambda: fn(False), reps=5)
                long_ms, _ = cuda_ms(lambda: fn(True), reps=5)
                vox = R * n
                print(f"{name} n={n} {(R, n)}: shared-memory mode {short_ms:.3f} "
                      f"ms ({short_ms / vox * 1e6:.3f} ns a voxel), long-row "
                      f"mode {long_ms:.3f} ms ({long_ms / vox * 1e6:.3f} ns a "
                      "voxel)" + (f"; {mode_shares('K3')}" if name == "K3"
                                  else ""))
            check_k3_split_rows(exact, n, dev)
            continue
        rd, ro = argmin.minplus_argmin_plain(ft, w2, cnt, True)
        exact.check(f"K2 long rows n={n} d", d2, rd)
        exact.check(f"K2 long rows n={n} offsets", o2, ro)
        del rd, ro
        close3.check(f"K3 long rows n={n}", k3(True),
                     grad.minplus_grad_plain(g, offsets=o2, off_sent=sent))
        print(f"K3 long rows {(R, n)}: {mode_shares('K3')}")
        check_k5(close5, f"long rows n={n}", fs, w2, t,
                 softmin.softmin_plain(fs, w2, t))
        if n != LONG_N[-1]:
            continue
        # times and bounds at (LONG_ROWS, 65536)
        vox = R * n
        walls = argmin.walls_from_counts(cnt, w2)
        k2_cands, _, _ = k2_search_work(ft, walls, w2)
        live = o2 != sent
        idx = torch.arange(n, device=dev)
        links = torch.where(live, idx + o2.to(torch.int64), idx)
        gm = torch.where(live, g, 0.0)
        needed5 = soft_needed(fs, w2, t)
        for name, fn, plain, bnd, lib in (
                ("K1", k1, lambda: minplus.minplus_walls_plain(
                    ft, ss, se, w2, True, True),
                 k1_bound_ms(ft, True), None),
                ("K2", k2, lambda: argmin.minplus_argmin_plain(ft, w2, cnt, True),
                 bound_ms(16 * vox, 4 * k2_cands), None),
                ("K3", k3, lambda: grad.minplus_grad_plain(
                    g, offsets=o2, off_sent=sent),
                 bound_ms(12 * vox, int(live.sum())),
                 lambda: torch.zeros_like(g).scatter_add_(1, links, gm)),
                ("K5", k5, lambda: softmin.softmin_plain(fs, w2, t),
                 bound_exp_ms(8 * vox, 6 * needed5, needed5, exps_per_s)[:2],
                 None)):
            ms, all_ms = cuda_ms(lambda: fn(True), reps=5)
            pms, _ = cuda_ms(plain, reps=1, warmup=0)
            lms = cuda_ms(lib, reps=5)[0] if lib else None
            rows[name] = (ms, pms, bnd[0], bnd[1], lib and lms)
            print(f"{name} long rows {(R, n)}: {ms:.3f} ms ({ms / vox * 1e6:.3f} "
                  f"ns a voxel; runs {[round(x, 4) for x in all_ms]}), plain "
                  f"{pms:.1f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
                  + (f", library scatter_add_ {lms:.3f} ms" if lib else ""))
        del walls, links, gm
        rows["K3"] = k3_many_rows(close3, n, rng, dev)
    # K6: forced at its ceiling, then past it, on LONG_ROWS rows and (the
    # long cell's rows) LONG_MANY
    for n, R in ((softmin.GRAD_MAX_AXIS, LONG_ROWS),
                 *((n, LONG_ROWS) for n in LONG_N6), (LONG_N6[-1], LONG_MANY)):
        fs = torch.from_numpy(long_soft_rows(rng, R, n)).to(dev)
        d = softmin.softmin(fs, w2, t)
        g = torch.from_numpy(rng.uniform(-1, 1, (R, n)).astype(np.float32)).to(dev)
        k6 = lambda lr: softmin.softmin_grad(fs, d, g, w2, t, _long_rows=lr)  # noqa: E731
        vox = R * n
        if n == softmin.GRAD_MAX_AXIS:
            # the row-split mode sums df tile by tile, then the halos: within
            # tolerance of the shared-memory mode, no longer bit-equal; e's
            # sums are that mode's
            (a, ea), (b, eb) = k6(True), k6(False)
            close6.check(f"K6 df n={n} long mode vs shared memory", a, b)
            exact.check(f"K6 e n={n} long mode vs shared memory", ea, eb)
            short_ms, _ = cuda_ms(lambda: k6(False), reps=5)
            long_ms, _ = cuda_ms(lambda: k6(True), reps=5)
            print(f"K6 n={n} {(R, n)}: shared-memory mode {short_ms:.3f} ms "
                  f"({short_ms / vox * 1e6:.3f} ns a voxel), long-row mode "
                  f"{long_ms:.3f} ms ({long_ms / vox * 1e6:.3f} ns a voxel); "
                  f"{mode_shares('K6')}")
            continue
        check_k6(close6, f"long rows {(R, n)}", fs, d, g, w2, t)
        print(f"K6 long rows {(R, n)}: {mode_shares('K6')}")
        if n != LONG_N6[-1]:
            continue
        needed6 = soft_needed(fs, w2, t, d)
        bms, by, _ = bound_exp_ms(20 * vox, 7 * needed6, needed6, exps_per_s)
        ms, all_ms = cuda_ms(lambda: k6(True), reps=5)
        pms, _ = cuda_ms(lambda: softmin.softmin_grad_plain(fs, d, g, w2, t),
                         reps=1, warmup=0)
        rows["K6"] = (ms, pms, bms, by, None)
        print(f"K6 long rows {(R, n)}: {ms:.3f} ms ({ms / vox * 1e6:.3f} ns a "
              f"voxel; runs {[round(x, 4) for x in all_ms]}), plain {pms:.1f} "
              f"ms, bound {bms:.4f} ms ({by}), {needed6 / vox:.2f} pairs a "
              "voxel inside the cut")
    return rows


# (rows, n): few rows of each length, then rows of 2048 to 32768 that fill
# a 512^3-sized volume (134M voxels) and some between
K3_MODE_SHAPES = tuple((r, n) for r in (8, 64, 256, 1024)
                       for n in (2048, 8192, 32768)) + (
    (4096, 2048), (16384, 2048), (65536, 2048), (8192, 4096),
    (32768, 4096), (4096, 8192), (16384, 8192), (4096, 32768))


def k3_modes(dev):
    """K3's two modes forced on K2's links of label rows at shapes below
    its ceiling (K3_MODE_SHAPES): ms of each, bit-equal, and the mode the
    wrapper takes by itself."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import argmin, grad

    rng = np.random.default_rng(53)
    bad = []
    for R, n in K3_MODE_SHAPES:
        f, lab = long_label_rows(rng, R, n)
        cnt = soft._wall_counts(torch.from_numpy(lab).to(dev), 1,
                                True).contiguous()
        _, o = argmin.minplus_argmin(torch.from_numpy(f).to(dev), 36.0,
                                     cnt, True)
        del f, lab, cnt
        sent = torch.iinfo(o.dtype).min
        g = torch.from_numpy(rng.uniform(-1, 1, (R, n)).astype(
            np.float32)).to(dev)
        k3 = lambda lr: grad.minplus_grad(  # noqa: E731
            g, offsets=o, off_sent=sent, _long_rows=lr)
        if not bit_equal(k3(True), k3(False)):
            bad.append((R, n))
        shared, _ = cuda_ms(lambda: k3(False), reps=5)
        split, _ = cuda_ms(lambda: k3(True), reps=5)
        before = grad.minplus_grad_split_launches
        k3(None)
        auto = ("row-split" if grad.minplus_grad_split_launches > before
                else "shared-memory")
        print(f"K3 {(R, n)}: shared-memory mode {shared:.4f} ms, "
              f"row-split mode {split:.4f} ms ({shared / split:.2f}x); "
              f"the wrapper takes the {auto} mode")
        del o, g
    if bad:
        raise AssertionError(f"K3 modes differ at {bad}")


def split_profiles(dev):
    """Device ms by kernel of one call of K3's and K6's long-row modes and
    of ``scatter_add_`` on K3's inputs, at (LONG_ROWS, n) and (LONG_MANY,
    n), n = 65536 (K6: 40000). Run only when named, alone in its process:
    in a whole run, or after a long unprofiled stretch that follows a
    profile, the profiler keeps none or only the last of the few device
    events of such a call."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import argmin, grad, softmin

    rng = np.random.default_rng(59)
    n, n6, w2 = LONG_N[-1], LONG_N6[-1], 36.0
    for R in (LONG_ROWS, LONG_MANY):
        f, lab = long_label_rows(rng, R, n)
        cnt = soft._wall_counts(torch.from_numpy(lab).to(dev), 1,
                                True).contiguous()
        _, o = argmin.minplus_argmin(torch.from_numpy(f).to(dev), w2, cnt, True)
        sent = torch.iinfo(o.dtype).min
        g = torch.from_numpy(rng.uniform(-1, 1, (R, n)).astype(np.float32)).to(dev)
        live = o != sent
        idx = torch.arange(n, device=dev)
        links = torch.where(live, idx + o.to(torch.int64), idx)
        gm = torch.where(live, g, 0.0)
        for label, fn in (
                ("K3", lambda: grad.minplus_grad(g, offsets=o, off_sent=sent)),
                ("scatter_add_",
                 lambda: torch.zeros_like(g).scatter_add_(1, links, gm))):
            fn()
            profile(fn, f"{label} long rows {(R, n)}")
        fs = torch.from_numpy(long_soft_rows(rng, R, n6)).to(dev)
        d = softmin.softmin(fs, w2, SOFT_T)
        g6 = torch.from_numpy(rng.uniform(-1, 1, (R, n6)).astype(np.float32)).to(dev)
        k6 = lambda: softmin.softmin_grad(fs, d, g6, w2, SOFT_T)  # noqa: E731
        k6()
        profile(k6, f"K6 long rows {(R, n6)}")


def check_k3_split_rows(exact, n, dev):
    """K3's long-row mode on ``k3_split_rows`` at n (runs across tile ends,
    a run longer than a tile, inert sources at tile ends, links that leave
    the row, two rows whose links descend): bit-equal to the shared-memory
    mode and to the host twin ``k3_split``, the marks the twin's."""
    from edt_tpu_torch.ops import grad

    g, o, sent, marks = k3_split_rows(np.random.default_rng(47), n, K3_TILE)
    g, o = torch.from_numpy(g).to(dev), torch.from_numpy(o).to(dev)
    df = grad.minplus_grad(g, offsets=o, off_sent=sent, _long_rows=True)
    got = grad.last_one_warp_rows.cpu()
    exact.check(f"K3 n={n} stress rows, long mode vs shared memory", df,
                grad.minplus_grad(g, offsets=o, off_sent=sent,
                                  _long_rows=False))
    twin, twin_marks = k3_split(g, k3_targets(o, sent), K3_TILE)
    exact.check(f"K3 n={n} stress rows vs the host twin", df.cpu(), twin)
    if not (torch.equal(got, twin_marks)
            and torch.equal(got, torch.from_numpy(marks))):
        exact.failures.append(f"K3 n={n} stress rows: marks {got.tolist()}")
    print(f"K3 n={n} stress rows {tuple(g.shape)}: bit-equal to the "
          f"shared-memory mode and the host twin; {mode_shares('K3')}")


def k3_many_rows(close3, n, rng, dev):
    """K3's long-row mode at (LONG_MANY, n), the long fwd+bwd's rows, on
    K2's links of label rows: against its plain version, its time beside
    its bound and ``scatter_add_``'s. Returns the JSON row's numbers."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import argmin, grad

    R = LONG_MANY
    f, lab = long_label_rows(rng, R, n)
    cnt = soft._wall_counts(torch.from_numpy(lab).to(dev), 1, True).contiguous()
    _, o = argmin.minplus_argmin(torch.from_numpy(f).to(dev), 36.0, cnt, True)
    del cnt
    sent = torch.iinfo(o.dtype).min
    g = torch.from_numpy(rng.uniform(-1, 1, (R, n)).astype(np.float32)).to(dev)
    k3 = lambda: grad.minplus_grad(g, offsets=o, off_sent=sent)  # noqa: E731
    close3.check(f"K3 long rows {(R, n)}", k3(),
                 grad.minplus_grad_plain(g, offsets=o, off_sent=sent))
    shares = mode_shares("K3")
    live = o != sent
    idx = torch.arange(n, device=dev)
    links = torch.where(live, idx + o.to(torch.int64), idx)
    gm = torch.where(live, g, 0.0)
    vox = R * n
    bms, by = bound_ms(12 * vox, int(live.sum()))
    ms, all_ms = cuda_ms(k3, reps=5)
    pms, _ = cuda_ms(lambda: grad.minplus_grad_plain(g, offsets=o,
                                                     off_sent=sent),
                     reps=1, warmup=0)
    lms, _ = cuda_ms(lambda: torch.zeros_like(g).scatter_add_(1, links, gm),
                     reps=5)
    print(f"K3 long rows {(R, n)}: {ms:.3f} ms ({ms / vox * 1e6:.4f} ns a "
          f"voxel; runs {[round(x, 4) for x in all_ms]}), plain {pms:.1f} ms, "
          f"bound {bms:.4f} ms ({by}), library scatter_add_ {lms:.3f} ms; "
          f"{shares}")
    return ms, pms, bms, by, lms


def long_multilabel(exact, close, dev):
    """multilabel_edtsq fwd+bwd at bench flags on LONG_VOLUME (K2 and K3
    in their long-row modes along the long axis) against kernels=PLAIN:
    forward bit-exact, gradient within rtol=1e-5. Returns its long
    launches."""
    from edt_tpu_torch.models import soft

    rng = np.random.default_rng(37)
    s0, s1, s2 = LONG_VOLUME
    labels = np.kron(rng.integers(0, 6, size=(s0 // 4, s1 // 4, s2 // 32)),
                     np.ones((4, 4, 32), np.uint8)).astype(np.uint32)
    lt = torch.from_numpy(labels.view(np.int32)).to(dev)
    occ = (lt != 0).float()
    barrier = float(np.sum((np.asarray(ANISO) * np.asarray(LONG_VOLUME)) ** 2))
    zero_grad_launches()
    zero_long_launches()
    out, g = fwd_bwd(lt, occ, True, barrier)
    counts, longs = grad_launches(), long_launches()
    if (counts != (2, 2, 1) or (longs["K2"], longs["K3"]) != (1, 1)
            or one_warp("K3")[0] != 1):
        raise AssertionError(f"{LONG_VOLUME} fwd+bwd: launches (K2, K3, K4) "
                             f"{counts}, long rows {longs}, K3 one-warp "
                             f"{one_warp('K3')}")
    shares = mode_shares("K3")
    rout, rg = fwd_bwd(lt, occ, True, barrier, kernels=soft.PLAIN)
    exact.check(f"{LONG_VOLUME} multilabel_edtsq forward vs PLAIN", out, rout)
    close.check(f"{LONG_VOLUME} multilabel_edtsq gradient vs PLAIN", g, rg)
    del rout, rg
    ms, all_ms = cuda_ms(lambda: fwd_bwd(lt, occ, True, barrier), reps=3)
    pms, _ = cuda_ms(lambda: fwd_bwd(lt, occ, True, barrier, soft.PLAIN),
                     reps=1, warmup=0)
    vox = labels.size
    print(f"{LONG_VOLUME} multilabel_edtsq fwd+bwd (bench flags): {ms:.2f} ms "
          f"median of {[round(x, 2) for x in all_ms]} ({ms / vox * 1e6:.3f} ns "
          f"a voxel), kernels=PLAIN {pms:.1f} ms; launches (K2, K3, K4) "
          f"{counts}, long rows K2 {longs['K2']}, K3 {longs['K3']}; "
          f"{shares}")
    profile(lambda: fwd_bwd(lt, occ, True, barrier),
            f"{LONG_VOLUME} multilabel_edtsq fwd+bwd (bench flags)", top=10,
            by_op=True)
    return longs


def long_soft(close_f, close_g, dev):
    """soft_edtsq fwd+bwd at t = SOFT_T on LONG_SOFT (the softmin cell's
    flags; K6 in its long-row mode on both, K5 on the second) against
    kernels=PLAIN within the softmin slice's tolerances. Returns the
    long launches."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import softmin

    total = dict.fromkeys(("K5", "K6"), 0)
    for shape in LONG_SOFT:
        rng = np.random.default_rng(41)
        occ = torch.from_numpy((rng.random(shape) > 0.5)
                               .astype(np.float32)).to(dev)
        barrier = float(3 * SOFT_FULL ** 2)
        fn = lambda o, k: soft.soft_edtsq(  # noqa: E731
            o, (1.0, 1.0, 1.0), True, barrier, SOFT_T, kernels=k)
        zero_soft_launches()
        zero_long_launches()
        out, g = value_and_grad(fn, occ, soft.KERNELS)
        counts, longs = soft_launches(), long_launches()
        want = (int(shape[2] > softmin.MAX_AXIS),
                int(shape[2] > softmin.GRAD_MAX_AXIS))
        if (counts != (3, 3) or (longs["K5"], longs["K6"]) != want
                or one_warp("K6")[0] != want[1]):
            raise AssertionError(f"{shape} soft_edtsq: launches (K5, K6) "
                                 f"{counts}, long rows {longs}, K6 one-warp "
                                 f"{one_warp('K6')}")
        shares = mode_shares("K6")
        total["K5"] += longs["K5"]
        total["K6"] += longs["K6"]
        rout, rg = value_and_grad(fn, occ, soft.PLAIN)
        close_f.check(f"{shape} soft_edtsq t={SOFT_T} forward vs PLAIN", out,
                      rout)
        close_g.check(f"{shape} soft_edtsq t={SOFT_T} gradient vs PLAIN", g,
                      rg)
        del rout, rg
        ms, all_ms = cuda_ms(lambda: value_and_grad(fn, occ, soft.KERNELS),
                             reps=3)
        vox = occ.numel()
        print(f"{shape} soft_edtsq t={SOFT_T} fwd+bwd: {ms:.2f} ms median of "
              f"{[round(x, 2) for x in all_ms]} ({ms / vox * 1e6:.3f} ns a "
              f"voxel); launches (K5, K6) {counts}, long rows K5 "
              f"{longs['K5']}, K6 {longs['K6']}; {shares}")
        profile(lambda: value_and_grad(fn, occ, soft.KERNELS),
                f"{shape} soft_edtsq t={SOFT_T} fwd+bwd", by_op=True)
    return total


def long_voxel_graph(exact, dev):
    """The voxel-graph transform on LONG_VG through the NumPy API,
    bit-exact to the volume doubled on the host, run through the plain
    parabolic pass on the card and subsampled, as the ``vg`` phase holds
    it. On the second shape the doubled long axis goes through K1's
    long-row mode (the first axis of the default order takes the closed
    form). Returns K1's long launches."""
    import edt_tpu_torch as et
    from edt_tpu_torch.ops import compose, minplus
    from edt_tpu_torch.ops import voxel_graph as vg

    plain = minplus.make_parabolic_fn(minplus.minplus_walls_plain)
    rng = np.random.default_rng(43)
    total = 0
    for shape in LONG_VG:
        data = (rng.random(shape) < 0.9).astype(np.uint8)
        graph = vg_graph(rng, shape)
        minplus.launches = 0
        zero_long_launches()
        out = et.edtsq(data, ANISO, True, voxel_graph=graph, device=dev)
        launches, longs = minplus.launches, long_launches()
        if launches != 2 or longs["K1"] != int(2 * shape[0] > minplus.MAX_AXIS):
            raise AssertionError(f"{shape} voxel graph: K1 launches "
                                 f"{launches}, long rows {longs['K1']}")
        total += longs["K1"]
        D = torch.from_numpy(vg._doubled_3d(data, graph, True)).to(dev)
        ref = compose.edtsq(D, [a / 2 for a in ANISO], True, binary=True,
                            parabolic_fn=plain)[::2, ::2, ::2]
        del D
        exact.check(f"{shape} voxel graph vs host-doubled plain", out, ref)
        ms, _ = cuda_ms(lambda: et.edtsq(data, ANISO, True, voxel_graph=graph,
                                         device=dev), reps=3)
        print(f"{shape} voxel graph (API, doubled {tuple(2 * s for s in shape)}"
              f"): {ms:.2f} ms; K1 launches {launches}, long rows "
              f"{longs['K1']}")
        profile(lambda: et.edtsq(data, ANISO, True, voxel_graph=graph,
                                 device=dev), f"{shape} voxel graph (API)",
                by_op=True)
    return total


def phase_long(exact, close, close3, close5, close6, soft_f, soft_g, kernels,
               dev):
    """Rows past the shared-memory ceilings: each long-row mode against
    its plain version and against the shared-memory mode, then the main
    paths that reach them (multilabel_edtsq on a 65536-voxel axis,
    soft_edtsq at t > 0 on axes of 40000 and 65536, the voxel graph with a
    doubled axis of 65536), each counted and held to its plain path."""
    rows = long_kernel_cases(exact, close3, close5, close6, dev)
    longs = long_multilabel(exact, close, dev)
    longs.update(long_soft(soft_f, soft_g, dev))
    longs["K1"] = long_voxel_graph(exact, dev)
    for chk, phase in ((exact, "long: K1, K2, forwards"), (close3, "long: K3"),
                       (close, "long: gradients"), (close5, "long: K5"),
                       (close6, "long: K6"), (soft_f, "long: soft forward"),
                       (soft_g, "long: soft gradient")):
        chk.raise_if_failed(phase)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"long: every long-row mode exact or within tolerance, on {smi}; "
          f"long-row launches on the main paths {longs}")
    for k, name, file, line in (
            ("K1", "minplus_walls", "minplus.cu", 84),
            ("K2", "minplus_argmin", "argmin.cu", 771),
            ("K3", "minplus_grad", "grad.cu", 1363),
            ("K5", "softmin", "softmin.cu", 1796),
            ("K6", "softmin_grad", "softmin.cu", 2307)):
        ms, pms, bms, by, lib = rows[k]
        err = {"K1": exact, "K2": exact, "K3": close3, "K5": close5,
               "K6": close6}[k].max_abs_err
        kernels.append({
            "name": f"{name} (long rows)", "route": "cuda",
            "source": SRC + file, "replaces": REP + str(line),
            "launches": longs[k], "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib})


def grad_program(fn, *args):
    """export_fn of the gradient of sum(fn(*args)) w.r.t. the last
    argument, saved to bytes and loaded: (loaded callable, program, the
    live gradient function, export s, bytes)."""
    from edt_tpu_torch.utils import export as edt_export

    def gfn(*a):
        *rest, x = a
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            return torch.autograd.grad(fn(*rest, x).sum(), x)[0]

    t0 = time.perf_counter()
    program = edt_export.export_fn(gfn, *args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    export_s = time.perf_counter() - t0
    return edt_export.load(data), program, gfn, export_s, len(data)


def op_nodes(program):
    """{op: nodes} of the kernels' custom ops in an exported graph."""
    counts = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("edt_tpu_torch."):
            key = name.split(".")[1]
            counts[key] = counts.get(key, 0) + 1
    return counts


def phase_export_grad(exact, dev):
    """The gradient of multilabel_edtsq at bench.py's 512^3 volume and
    flags (K2, K3, K4) and of soft_edtsq at t = SOFT_T on the 256^3
    softmin cell (K5, K6), each exported with export_fn, saved, loaded and
    run on the card: bit-exact to the live gradient, the kernels' ops
    nodes of the graph, their launches counted in the loaded run, timed
    beside the live call."""
    from edt_tpu_torch.models import soft

    labels = make_labels(np.random.default_rng(42), FULL)
    lt = torch.from_numpy(labels.view(np.int32)).to(dev)
    occ = (lt != 0).float()
    barrier = float(np.sum((np.asarray(ANISO) * FULL) ** 2))
    S = SOFT_FULL
    socc = torch.from_numpy((np.random.default_rng(42).random((S,) * 3) > 0.5)
                            .astype(np.float32)).to(dev)
    cases = (
        (f"{FULL}^3 multilabel_edtsq (bench flags)",
         lambda lab, o: soft.multilabel_edtsq(lab, o, ANISO, True,
                                              barrier=barrier,
                                              binary_occupancy=True),
         (lt, occ), {"minplus_argmin": 2, "minplus_grad": 2,
                     "binary_grad_scan": 1},
         zero_grad_launches, grad_launches, (2, 2, 1)),
        (f"{S}^3 soft_edtsq t={SOFT_T}",
         lambda o: soft.soft_edtsq(o, (1.0, 1.0, 1.0), True, float(3 * S ** 2),
                                   SOFT_T),
         (socc,), {"softmin": 3, "softmin_grad": 3},
         zero_soft_launches, soft_launches, (3, 3)))
    for label, fn, args, nodes, zero, count, want in cases:
        run, program, gfn, export_s, nbytes = grad_program(fn, *args)
        if op_nodes(program) != nodes:
            raise AssertionError(f"export_grad {label}: op nodes "
                                 f"{op_nodes(program)}, expected {nodes}")
        zero()
        got = run(*args)
        launches = count()
        if launches != want:
            raise AssertionError(f"export_grad {label}: the loaded program "
                                 f"launched {launches}, expected {want}")
        exact.check(f"export_grad {label} vs the live gradient", got,
                    gfn(*args))
        run_ms, run_all = cuda_ms(lambda: run(*args), reps=5)
        live_ms, live_all = cuda_ms(lambda: gfn(*args), reps=5)
        print(f"export_grad {label}: export and save {export_s:.2f} s "
              f"({nbytes} bytes), op nodes {nodes}; loaded run "
              f"{run_ms:.2f} ms median of {[round(x, 2) for x in run_all]} "
              f"(launches {launches}), bit-equal to the live gradient: "
              f"{live_ms:.2f} ms median of {[round(x, 2) for x in live_all]}")
        del got
    exact.raise_if_failed("export_grad")


# ---------------- slice 10: the sharded transforms and soft passes


SHARD_RANKS = 4  # gloo ranks sharing the one card
SHARD_ODD = (509, 512, 510)  # divides no axis by SHARD_RANKS
SHARD_TIMEOUT_S = 600
# (K, module of ops, wrapper, plain version, name, source, TPU kernel line)
SHARD_KERNELS = (
    ("K1", "minplus", "minplus_walls", "minplus_walls_plain",
     "minplus_walls", "minplus.cu", 311),
    ("K2", "argmin", "minplus_argmin", "minplus_argmin_plain",
     "minplus_argmin", "argmin.cu", 1275),
    ("K3", "grad", "minplus_grad", "minplus_grad_plain", "minplus_grad",
     "grad.cu", 1616),
    ("K4", "grad", "binary_grad_scan", "binary_grad_scan_plain",
     "binary_grad_scan", "grad.cu", 1751),
    ("K5", "softmin", "softmin", "softmin_plain", "softmin", "softmin.cu",
     2103),
    ("K6", "softmin", "softmin_grad", "softmin_grad_plain", "softmin_grad",
     "softmin.cu", 2346))


def all_launches():
    """The launch counts of K1 to K6."""
    from edt_tpu_torch.ops import minplus, softmin

    return dict(zip(("K1", "K2", "K3", "K4", "K5", "K6"),
                    (minplus.launches, *grad_launches(), softmin.launches,
                     softmin.grad_launches)))


def zero_all_launches():
    from edt_tpu_torch.ops import minplus

    minplus.launches = 0
    minplus.card_launches.clear()
    zero_grad_launches()
    zero_soft_launches()


def counted(report, case, expect, fn):
    """fn() with every kernel's count set to 0 just before and checked just
    after: ``expect`` maps K to its launches on this rank, the rest 0."""
    zero_all_launches()
    out = fn()
    got = all_launches()
    want = {k: expect.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{case}: launches {got}, expected {want}")
    for k, n in got.items():
        report["launches"][k] = report["launches"].get(k, 0) + n
    return out


def slab_of(ref, out, rank, world):
    """This rank's slab of a whole-volume ``ref``, laid out as the DTensor
    ``out``'s local tensor (its Shard dim, DTensor's uneven chunks)."""
    dim = out.placements[0].dim
    c = -(-ref.shape[dim] // world)
    start = min(rank * c, ref.shape[dim])
    return ref.narrow(dim, start, out.to_local().shape[dim])


class Capture:
    """Within the block, records the first call of each kernel wrapper
    (the custom ops call the wrappers by their module names)."""

    def __init__(self):
        self.calls, self.saved = {}, []

    def __enter__(self):
        import importlib

        for k, mod, attr, *_ in SHARD_KERNELS:
            m = importlib.import_module(f"edt_tpu_torch.ops.{mod}")
            orig = getattr(m, attr)

            def wrap(*a, _k=k, _orig=orig, **kw):
                self.calls.setdefault(_k, (a, kw))
                return _orig(*a, **kw)

            self.saved.append((m, attr, orig))
            setattr(m, attr, wrap)
        return self

    def __exit__(self, *exc):
        for m, attr, orig in self.saved:
            setattr(m, attr, orig)


def shard_kernel_entry(k, call, exps_per_s):
    """One kernel alone on its captured call from the sharded path: ms,
    plain ms, max |err| against the plain version, bound and library ms."""
    import importlib
    import inspect

    from edt_tpu_torch.ops import argmin

    _, mod, attr, plain_attr, name, src, line = next(
        e for e in SHARD_KERNELS if e[0] == k)
    m = importlib.import_module(f"edt_tpu_torch.ops.{mod}")
    a, kw = call
    bound = inspect.signature(getattr(m, plain_attr)).bind(*a, **kw)
    bound.apply_defaults()
    x = bound.arguments  # the call's arguments by name
    kern = lambda: getattr(m, attr)(*a, **kw)  # noqa: E731
    plain = lambda: getattr(m, plain_attr)(*a, **kw)  # noqa: E731
    chk = {"K1": Exact(), "K2": Exact(), "K3": Close(), "K4": Close(),
           "K5": Close(1e-5, atol=1e-4),
           "K6": Close(1e-4, atol=0.0, atol_rel=1e-4)}[k]
    got, ref = kern(), plain()
    if k == "K6":
        chk.check("K6 df", got[0], ref[0])
        chk.check_sum("K6 sum(g e)", (x["g"] * got[1]).sum(),
                      (x["g"] * ref[1]).sum(), 1e-3)
    else:
        for i, (y, r) in enumerate(zip(*(t if isinstance(t, tuple) else (t,)
                                         for t in (got, ref)))):
            chk.check(f"{k} output {i}", y, r)
    chk.raise_if_failed(f"{k} on the sharded path")
    del got, ref
    ms, _ = cuda_ms(kern, reps=10, warmup=2)
    pms, _ = cuda_ms(plain, reps=2)
    lib = None
    f = x.get("f", x.get("g"))
    if k == "K1":
        bms, by = k1_bound_ms(f, x["masked"])
    elif k == "K2":
        walls = (None if x["walls"] is None
                 else argmin.walls_from_counts(x["walls"], x["w2"]))
        cands = k2_search_work(f, walls, x["w2"])[0]
        bms, by = bound_ms(12 * f.numel(), 4 * cands)
    elif k == "K3":
        o, sent = x["offsets"], x["off_sent"]
        live = o != sent
        idx = torch.arange(f.shape[1], device=f.device)
        links = torch.where(live, idx + o.to(torch.int64), idx)
        gm = torch.where(live, f, 0.0)
        lib, _ = cuda_ms(lambda: torch.zeros_like(f).scatter_add_(1, links, gm),
                         reps=10, warmup=2)
        bms, by = bound_ms(10 * f.numel(), int(live.sum()))
    elif k == "K4":
        bms, by = bound_ms(10 * f.numel(), 2 * f.numel())
    elif k == "K5":
        (bms, by, _), *_ = k5_bound_ms(f, x["w2"], x["t"], exps_per_s)
    else:
        (bms, by, _), *_ = k6_bound_ms(x["f"], x["d"], x["w2"], x["t"],
                                       exps_per_s)
    return {"name": name, "route": "cuda", "source": SRC + src,
            "replaces": REP + str(line), "max_abs_err": chk.max_abs_err,
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "shape": list(f.shape)}


def sharded_cases(rank, world, full, dev):
    """One rank's cases (every rank runs them in step). ``full``: every
    case; else the 512^3 forward and the bench fwd+bwd. Each holds this
    rank's slab against the same slab of the single-card call, bit-exact
    (gradients within tolerance), with every kernel's launches on this
    rank checked; then times, and on rank 0 each kernel alone on its first
    call of the cases."""
    import torch.distributed as dist

    from edt_tpu_torch.parallel import sharded

    mesh = sharded.default_mesh(device=dev)
    group = mesh.get_group("sp")
    report = {"rank": rank, "launches": {}, "ms": {}, "s": {}}
    lt = torch.from_numpy(make_labels(np.random.default_rng(42), FULL)
                          .view(np.int32)).to(dev)
    with Capture() as cap:
        ml, sm = checked_cases(report, rank, world, full, dev, mesh, lt)

    # times on every rank, all ranks in step (the cases warmed them up)
    t = time.perf_counter()
    f = torch.rand((FULL // world, FULL, FULL), device=dev)
    rot = lambda: sharded.all_to_all(  # noqa: E731
        sharded.all_to_all(f, group, 2, 0), group, 0, 2)
    report["ms"][f"rotation there and back, {tuple(f.shape)} f32"] = \
        cuda_ms(rot, reps=2, warmup=0)[0]
    del f
    report["ms"][f"edtsq_sharded_auto {FULL}^3"] = cuda_ms(
        lambda: sharded.edtsq_sharded_auto(lt, ANISO, True, mesh=mesh),
        reps=2, warmup=0)[0]
    report["ms"][f"multilabel_edtsq fwd+bwd {FULL}^3"] = cuda_ms(
        ml, reps=2, warmup=0)[0]
    if full:
        report["ms"][f"soft_edtsq fwd+bwd {SOFT_FULL}^3"] = cuda_ms(
            sm, reps=2, warmup=0)[0]
    report["s"]["times"] = time.perf_counter() - t

    if full:
        # each kernel alone on rank 0 while the other ranks wait
        t = time.perf_counter()
        if rank == 0:
            exps_per_s = sfu_exps_per_s()
            with torch.no_grad():
                report["kernels"] = [shard_kernel_entry(k, call, exps_per_s)
                                     for k, call in sorted(cap.calls.items())]
        del cap
        dist.barrier(group)
        report["s"]["kernels alone"] = time.perf_counter() - t
    return report


def checked_cases(report, rank, world, full, dev, mesh, lt):
    """The cases of ``sharded_cases``, each counted and checked; returns
    the fwd+bwd calls (multilabel, softmin) to time."""
    import torch.distributed as dist

    from edt_tpu_torch import api
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import compose
    from edt_tpu_torch.ops import voxel_graph as vg
    from edt_tpu_torch.parallel import sharded

    group = mesh.get_group("sp")
    exact, close = Exact(), Close()
    close5, close6 = Close(1e-5, atol=1e-4), Close(1e-4, atol=0.0,
                                                     atol_rel=1e-4)
    order = api._sorted_axis_order(np.asarray(ANISO, np.float32))
    t = time.perf_counter()

    # the forward transforms: K1 twice a rank an edtsq, four times an sdf
    vols = [(f"{FULL}^3", lt)]
    if full:
        vols.append(("x".join(map(str, SHARD_ODD)),
                     lt[tuple(slice(0, s) for s in SHARD_ODD)].contiguous()))
    for vname, vol in vols:
        for bb in ((True, False) if full else (True,)):
            case = f"edtsq_sharded_auto {vname} bb={bb}"
            out = counted(report, case, {"K1": 2},
                          lambda: sharded.edtsq_sharded_auto(vol, ANISO, bb,
                                                             mesh=mesh))
            ref = compose.edtsq(vol, ANISO, bb, axis_order=order)
            exact.check(case, out.to_local(), slab_of(ref, out, rank, world))
            if vol is lt and bb and dist.get_backend(group) == "nccl":
                # gloo's functional collectives on CUDA tensors crash in
                # torch 2.11 (the all-gather of full_tensor); NCCL only
                exact.check(case + " (full_tensor)", out.full_tensor(), ref)
            del out, ref
            if not full:
                continue
            case = f"sdf_sharded {vname} bb={bb}"
            out = counted(report, case, {"K1": 4},
                          lambda: sharded.sdf_sharded(vol, ANISO, bb,
                                                      mesh=mesh))
            ref = compose.sdf(vol, ANISO, bb)
            exact.check(case, out.to_local(), slab_of(ref, out, rank, world))
            del out, ref
    exact.raise_if_failed(f"rank {rank}: sharded transforms")
    report["s"]["transforms"] = time.perf_counter() - t

    if full:
        t = time.perf_counter()
        S = VG_FULL
        data = make_labels(np.random.default_rng(11), S)
        vlt = torch.from_numpy(data.view(np.int32)).to(dev)
        vgt = torch.from_numpy(vg_graph(np.random.default_rng(12),
                                        data.shape)).to(dev)
        for bb in (True, False):
            case = f"edtsq_voxel_graph_sharded {S}^3 bb={bb}"
            out = counted(report, case, {"K1": 2},
                          lambda: sharded.edtsq_voxel_graph_sharded(
                              vlt, vgt, ANISO, bb, mesh=mesh))
            ref = vg.edtsq_voxel_graph_torch(vlt, vgt, ANISO, bb)
            exact.check(case, out.to_local(), slab_of(ref, out, rank, world))
            del out, ref
        exact.raise_if_failed(f"rank {rank}: sharded voxel graph")
        del vlt, vgt
        report["s"]["voxel graph"] = time.perf_counter() - t

    # bench.py's fwd+bwd with axis_name, on this rank's slab
    t = time.perf_counter()
    c = FULL // world
    sl = slice(rank * c, (rank + 1) * c)
    occ = (lt != 0).to(torch.float32)
    barrier = float(np.sum((np.asarray(ANISO) * FULL) ** 2))
    ml = lambda: fwd_bwd(lt[sl], occ[sl], True, barrier, axis_name=group)  # noqa: E731
    out, g = counted(report, "multilabel_edtsq fwd+bwd",
                     {"K2": 2, "K3": 2, "K4": 1}, ml)
    ref, rg = fwd_bwd(lt, occ, True, barrier)
    for name, chk, mine, whole in (("forward", exact, out, ref),
                                   ("gradient", close, g, rg)):
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine.contiguous(), group=group)
        chk.check(f"multilabel_edtsq {name} (gathered)", torch.cat(parts),
                  whole)
        del parts
    del out, g, ref, rg
    exact.raise_if_failed(f"rank {rank}: sharded multilabel forward")
    close.raise_if_failed(f"rank {rank}: sharded multilabel gradient")
    report["s"]["multilabel fwd+bwd"] = time.perf_counter() - t

    sm = None
    if full:
        t = time.perf_counter()
        S = SOFT_FULL
        socc = torch.from_numpy((np.random.default_rng(42).random((S,) * 3)
                                 > 0.5).astype(np.float32)).to(dev)
        sbar = float(3 * S ** 2)
        s_sl = slice(rank * (S // world), (rank + 1) * (S // world))
        fn = lambda o, k, a=None: soft.soft_edtsq(  # noqa: E731
            o, (1.0, 1.0, 1.0), True, sbar, SOFT_T, a, kernels=k)
        sm = lambda: value_and_grad(  # noqa: E731
            lambda o, k: fn(o, k, group), socc[s_sl], soft.KERNELS)
        out, g = counted(report, f"soft_edtsq t={SOFT_T} {S}^3 fwd+bwd",
                         {"K5": 3, "K6": 3}, sm)
        ref, rg = value_and_grad(fn, socc, soft.KERNELS)
        close5.check("soft_edtsq forward", out, ref[s_sl])
        close6.check("soft_edtsq gradient", g, rg[s_sl])
        del out, g, ref, rg
        close5.raise_if_failed(f"rank {rank}: sharded soft_edtsq forward")
        close6.raise_if_failed(f"rank {rank}: sharded soft_edtsq gradient")
        report["s"]["softmin fwd+bwd"] = time.perf_counter() - t
    return ml, sm


def sharded_rank(rank, world, backend, rendezvous, outdir, cases, args):
    """A spawned rank: ``backend`` ("gloo": every rank on card 0; "nccl":
    rank r on card r), ``cases(rank, world, *args, dev=...)``, its report
    saved with ``torch.save``."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0 if backend == "gloo" else rank)
    torch.cuda.set_device(dev)
    # f32 matmuls and convolutions, as main sets them (cuDNN's default is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        report = cases(rank, world, *args, dev=dev)
        torch.save(report, f"{outdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(world, backend, cases, *args):
    """Spawn ``world`` ranks running ``cases`` with ``args``; their
    reports. Any rank's failure (or ``SHARD_TIMEOUT_S``) fails the
    call."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(sharded_rank, args=(
            world, backend, f"{tmp}/rendezvous", tmp, cases, args),
            nprocs=world, join=False)
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{backend} ranks still running after "
                                       f"{SHARD_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        return [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]


def phase_sharded(kernels, dev):
    """The sharded transforms and soft passes over torch.distributed:
    four gloo ranks on the one card (bench.py's 512^3 volume and a shape
    that divides no axis by 4, the 256^3 voxel graph, bench.py's fwd+bwd
    with axis_name, the 256^3 softmin cell), then the 512^3 forward and
    fwd+bwd in one NCCL rank, and over min(4, cards) NCCL ranks where
    there are more cards."""
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    runs = [("gloo", SHARD_RANKS, True), ("nccl", 1, False)]
    if torch.cuda.device_count() > 1:
        runs.append(("nccl", min(4, torch.cuda.device_count()), False))
    for backend, world, full in runs:
        t = time.perf_counter()
        reports = spawn_ranks(world, backend, sharded_cases, full)
        label = f"{world} {backend} rank{'s' if world > 1 else ''}"
        print(f"sharded, {label}: every case bit-exact to the single-card "
              f"call (gradients within tolerance), launches checked on every "
              f"rank; {time.perf_counter() - t:.1f} s")
        note = ("ranks share one card and stage their collectives through "
                "the host: no scaling figure" if backend == "gloo" else
                "one card a rank")
        for rep in reports:
            times = ", ".join(f"{k} {v:.2f} ms" for k, v in rep["ms"].items())
            walls = ", ".join(f"{k} {v:.1f} s" for k, v in rep["s"].items())
            print(f"  rank {rep['rank']} ({smi}; {note}): launches "
                  f"{rep['launches']}; {times}; wall time of its cases: "
                  f"{walls}")
        if backend != "gloo":
            continue
        for e in reports[0]["kernels"]:
            k = next(x[0] for x in SHARD_KERNELS if x[4] == e["name"])
            launches = sum(rep["launches"].get(k, 0) for rep in reports)
            shape = e.pop("shape")
            print(f"  {k} alone on rank 0's first sharded call {tuple(shape)}"
                  f": {e['ms']:.3f} ms, plain {e['plain_ms']:.1f} ms, bound "
                  f"{e['bound_ms']:.3f} ms ({e['bound_by']})"
                  + (f", library scatter_add_ {e['library_ms']:.3f} ms"
                     if e["library_ms"] else "")
                  + f"; {launches} launches over the {world} ranks")
            kernels.append(dict(e, name=f"{e['name']} (sharded, {world} "
                                f"gloo ranks on one card)",
                                launches=launches))


# ---------------- slice 11: the trainers' sharded steps ----------------

TRAIN_SHARD_STEPS = 3  # steps a case; the first (and an Adam case's second) checked
# case: (model, optimizer, learning rate, reduce-scatter, steps checked);
# SGD's rate suits a loss of about 8e6 (2 x 256^3, barrier 256^2 / 2)
TRAIN_SHARD_CASES = {
    "DistanceFieldNet psum SGD": ("DistanceFieldNet", "SGD", 1e-7, False, 1),
    "DistanceFieldNet psum Adam": ("DistanceFieldNet", "Adam", 1e-3, False, 2),
    "DistanceFieldNet reduce-scatter Adam": ("DistanceFieldNet", "Adam", 1e-3,
                                             True, 2),
    "UNet3D psum Adam": ("UNet3D", "Adam", 1e-3, False, 1),
}
# gloo on CUDA tensors carries all_reduce, not reduce_scatter or send/recv
GLOO_TRAIN_CASES = ("DistanceFieldNet psum SGD",)


def train_model(family, dev):
    """The trainer of the DistanceFieldNet and UNet3D phases, seed 0."""
    from edt_tpu_torch.models import distance_net, unet3d

    gen = torch.Generator().manual_seed(0)
    if family == "DistanceFieldNet":
        return distance_net.DistanceFieldNet(8, 32, generator=gen, device=dev)
    return unet3d.UNet3D(4, 8, 2, generator=gen, device=dev)


def train_batch(family, dev):
    """The family's batch of the single-card phases (2 x 256^3, c_in 8;
    UNet3D 2 x 128^3, c_in 4), its size; K1 makes the target."""
    from edt_tpu_torch.models import distance_net

    S, c_in, seed = ((TRAIN_FULL, 8, 1) if family == "DistanceFieldNet"
                     else (TRAIN_SMALL, 4, 3))
    feats, target = distance_net.synthetic_batch(
        np.random.default_rng(seed), 2, (S,) * 3, c_in, device=dev)
    return feats, target, S


def make_optimizer(kind, lr):
    if kind == "SGD":
        return lambda ts: torch.optim.SGD(ts, lr)
    return lambda ts: torch.optim.Adam(ts, lr, betas=(0.9, 0.999), eps=1e-8)


def cpu_state(model):
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def run_train_case(case, model, step, feats, target, launches,
                   moments=None, capture=None):
    """TRAIN_SHARD_STEPS steps of ``step`` (K5 and K6 3 + 3 a step,
    checked by ``train_steps``, added to ``launches``): the losses, the
    step times (CUDA events), the parameters after each checked step and
    ``moments()`` after the first. ``capture``, a ``Capture``, records the
    kernels' calls of the first step."""
    checked = TRAIN_SHARD_CASES[case][4]
    out = {"losses": [], "ms": [], "params": []}
    for i in range(TRAIN_SHARD_STEPS):
        with (capture if i == 0 and capture is not None
              else contextlib.nullcontext()):
            losses, times = train_steps(step, feats, target, 1, case)
        out["losses"] += losses
        out["ms"] += times
        for k in ("K5", "K6"):
            launches[k] = launches.get(k, 0) + 3
        if i < checked:
            out["params"].append(cpu_state(model))
        if i == 0 and moments is not None:
            out["moments"] = moments()
    return out


def adam_moments(opt, params):
    """Adam's (exp_avg, exp_avg_sq) of every parameter, flat, on the host."""
    return [[opt.state[p][k].reshape(-1).to("cpu", copy=True)
             for p in params] for k in ("exp_avg", "exp_avg_sq")]


def block_order_moments(opt, mesh):
    """The reduce-scatter optimizer's moments, every rank's 1/n slices
    gathered in block order sp * n_dp + dp: the flat padded layout."""
    import torch.distributed as dist

    n_dp = dist.get_world_size(mesh.get_group("dp"))
    slices = opt.param_groups[0]["params"]
    me = torch.tensor([mesh.get_local_rank("dp"), mesh.get_local_rank("sp")],
                      device=slices[0].device)
    coords = [torch.empty_like(me) for _ in range(mesh.size())]
    dist.all_gather(coords, me)
    out = []
    for k in ("exp_avg", "exp_avg_sq"):
        per_param = []
        for s in slices:
            parts = [torch.empty_like(s) for _ in range(mesh.size())]
            dist.all_gather(parts, opt.state[s][k])
            blocks = [None] * mesh.size()
            for part, (i, j) in zip(parts, coords):
                blocks[int(j) * n_dp + int(i)] = part.to("cpu")
            per_param.append(torch.cat(blocks))
        out.append(per_param)
    return out


def train_reference_key(case):
    """Cases that the single-card step computes alike share a reference:
    the reduce-scatter mode's is the replicated step's."""
    family, kind, lr, _, _ = TRAIN_SHARD_CASES[case]
    return family, kind, lr


def single_card_train(dev):
    """Each reference of TRAIN_SHARD_CASES on one card through the
    single-card ``make_train_step``, from the same parameters: its
    ``run_train_case`` result (Adam's moments after the first step, flat),
    by ``train_reference_key``."""
    from edt_tpu_torch.models import distance_net, unet3d

    refs, launches, batch = {}, {}, None
    for case in TRAIN_SHARD_CASES:
        key = train_reference_key(case)
        if key in refs:
            continue
        family, kind, lr = key
        if batch is None or batch[0] != family:
            batch = None
            torch.cuda.empty_cache()
            batch = (family, *train_batch(family, dev))
        _, feats, target, S = batch
        model = train_model(family, dev)
        opt = make_optimizer(kind, lr)(list(model.parameters()))
        mod = distance_net if family == "DistanceFieldNet" else unet3d
        step = mod.make_train_step(model, opt, temperature=SOFT_T,
                                   barrier=S * S / 2)
        refs[key] = run_train_case(
            case, model, step, feats, target, launches,
            moments=(lambda: adam_moments(opt, model.parameters()))  # noqa: B023
            if kind == "Adam" else None)
        del model, opt, step
    del batch
    torch.cuda.empty_cache()
    return refs


def train_sharded_cases(rank, world, cases, dev):
    """One rank's cases of the trainers' sharded steps over a (dp, sp)
    mesh, 2 x 2 on four ranks, 1 x 1 on one: each case from the same
    parameters as the single-card step, every step's K5 and K6 launches
    checked on this rank; under gloo, rank 0 then times K5 and K6 alone on
    its first step's calls."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from edt_tpu_torch.models import distance_net, unet3d

    n_dp = 2 if world == 4 else 1
    mesh = init_device_mesh(dev.type, (n_dp, world // n_dp),
                            mesh_dim_names=("dp", "sp"))
    backend = dist.get_backend()
    report = {"rank": rank, "launches": {}, "cases": {}, "backend": backend}
    cap = Capture() if backend == "gloo" else None
    batch = None
    for case in cases:
        family, kind, lr, rs, _ = TRAIN_SHARD_CASES[case]
        if batch is None or batch[0] != family:
            batch = None
            torch.cuda.empty_cache()
            batch = (family, *counted(report, f"{family} synthetic_batch",
                                      {"K1": 4},
                                      lambda: train_batch(family, dev)))  # noqa: B023
        _, feats, target, S = batch
        model = train_model(family, dev)
        mod = distance_net if family == "DistanceFieldNet" else unet3d
        kw = dict(temperature=SOFT_T, barrier=S * S / 2)
        if rs:
            opt = distance_net.init_sharded_opt_state(
                mesh, make_optimizer(kind, lr), model)
            moments = lambda: block_order_moments(opt, mesh)  # noqa: B023,E731
            step = mod.make_sharded_train_step(model, mesh, opt,
                                               grad_reduce_scatter=True, **kw)
        else:
            opt = make_optimizer(kind, lr)(list(model.parameters()))
            moments = ((lambda: adam_moments(opt, model.parameters()))  # noqa: B023
                       if kind == "Adam" else None)
            step = mod.make_sharded_train_step(model, mesh, opt, **kw)
        report["cases"][case] = run_train_case(
            case, model, step, feats, target, report["launches"], moments,
            cap if not report["cases"] else None)
        del model, opt, step
    del batch
    if cap is not None:
        if rank == 0:
            exps_per_s = sfu_exps_per_s()
            with torch.no_grad():
                report["kernels"] = [shard_kernel_entry(k, cap.calls[k],
                                                        exps_per_s)
                                     for k in ("K5", "K6")]
        del cap
        dist.barrier()
    return report


def compare_train(rep, ref, checked, n, loss_rtol, params, moments):
    """A rank's ``run_train_case`` result against ``ref``'s: the losses
    and parameters of the ``checked`` steps (loss within ``loss_rtol``,
    parameters by the ``Close`` ``params``) and, where ``rep`` has them,
    the moments by ``moments`` (``rep``'s may be the reduce-scatter
    layout, padded to a multiple of n with zeros). The failures."""
    fails = []
    for i in range(checked):
        got, want = rep["losses"][i], ref["losses"][i]
        if not abs(got - want) <= loss_rtol * abs(want):
            fails.append(f"step {i + 1} loss {got} vs {want}")
        for k, v in ref["params"][i].items():
            params.check(f"step {i + 1} {k}", rep["params"][i][k], v)
    for name, got_m, want_m in zip(("exp_avg", "exp_avg_sq"),
                                   rep.get("moments", ()), ref.get("moments", ())):
        for j, (g, w) in enumerate(zip(got_m, want_m)):
            if g.numel() != w.numel():
                if (g.numel() != w.numel() + (-w.numel()) % n
                        or g[w.numel():].any()):
                    fails.append(f"{name} {j}: not the flat padded layout")
                g = g[:w.numel()]
            moments.check(f"{name} {j}", g, w)
    return fails + params.failures + moments.failures


def check_train_case(case, rep, ref, n):
    """A rank's case against the single-card step with the JAX package's
    tolerances (``tests/test_distance_net.py:38``: loss rtol 1e-4,
    parameters ``np.allclose(atol=1e-5)``; ``tests/test_unet3d.py:61``:
    loss rtol 1e-5, parameters rtol 1e-4, atol 1e-5); the moments (the
    flat padded layout of the reduce-scatter mode) within the gradients'
    tolerance, rtol 1e-4 with atol 1e-4 max|ref| (a block permutation
    moves whole blocks). Returns (failures, parameters' max error,
    moments' max error)."""
    family, _, _, _, checked = TRAIN_SHARD_CASES[case]
    if family == "DistanceFieldNet":
        loss_rtol, params = 1e-4, Close(1e-5, atol=1e-5)
    else:
        loss_rtol, params = 1e-5, Close(1e-4, atol=1e-5)
    moments = Close(1e-4, atol=0.0, atol_rel=1e-4)
    fails = compare_train(rep, ref, checked, n, loss_rtol, params, moments)
    return fails, params.max_abs_err, moments.max_abs_err


def check_reduce_scatter_vs_psum(rep, n):
    """The reduce-scatter step against the psum step of the same rank, as
    ``tests/test_distance_net.py:72`` holds them: loss rtol 1e-5,
    parameters and moments ``np.allclose(atol=1e-6)``. Returns (failures,
    max error)."""
    params, moments = Close(1e-5, atol=1e-6), Close(1e-5, atol=1e-6)
    fails = compare_train(rep["cases"]["DistanceFieldNet reduce-scatter Adam"],
                          rep["cases"]["DistanceFieldNet psum Adam"], 2, n,
                          1e-5, params, moments)
    return fails, max(params.max_abs_err, moments.max_abs_err)


def phase_train_sharded(kernels, dev):
    """The trainers' sharded steps over a (dp, sp) mesh at the single-card
    phases' widths (DistanceFieldNet 2 x 256^3, c_in 8, hidden 32; UNet3D
    2 x 128^3, c_in 4, c0 8, levels 2), each held to the single-card step
    from the same parameters: four gloo ranks on card 0 (2 x 2, the psum
    step: gloo carries all_reduce on CUDA tensors, not reduce_scatter or
    send/recv), one NCCL rank (1 x 1) with every case, and four NCCL ranks
    (2 x 2) where there are four cards."""
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    refs = single_card_train(dev)
    for key, ref in refs.items():
        print(f"train_sharded, one card, single-card step, {' '.join(map(str, key))} "
              f"({smi}): steps {[round(x, 2) for x in ref['ms']]} ms, losses "
              f"{ref['losses']}")
    cases = tuple(TRAIN_SHARD_CASES)
    runs = [("gloo", 4, GLOO_TRAIN_CASES), ("nccl", 1, cases)]
    cards = torch.cuda.device_count()
    if cards >= 4:
        runs.append(("nccl", 4, cases))
    else:
        print(f"train_sharded, 4 NCCL ranks (2 x 2), {', '.join(cases)}: "
              f"not run: {cards} cards")
    failed = []
    for backend, world, run_cases in runs:
        t = time.perf_counter()
        reports = spawn_ranks(world, backend, train_sharded_cases, run_cases)
        mesh = "2 x 2" if world == 4 else "1 x 1"
        print(f"train_sharded, {world} {backend} rank{'s' if world > 1 else ''}"
              f" ({mesh} mesh; {'every rank on card 0' if backend == 'gloo' else 'one card a rank'}"
              f"; backend {reports[0]['backend']}): "
              f"{time.perf_counter() - t:.1f} s")
        for case in run_cases:
            ref = refs[train_reference_key(case)]
            print(f"  {case}: single-card step {statistics.median(ref['ms'][1:]):.2f} ms "
                  f"(median after the first), loss {ref['losses'][0]}")
            for rep in reports:
                res = rep["cases"][case]
                fails, err, moments = check_train_case(case, res, ref, world)
                failed += [f"{backend} {world} rank {rep['rank']} {case}: {f}"
                           for f in fails]
                print(f"    rank {rep['rank']} ({smi}): steps "
                      f"{[round(x, 2) for x in res['ms']]} ms, median after the "
                      f"first {statistics.median(res['ms'][1:]):.2f} ms; losses "
                      f"{res['losses']}; parameters max abs err {err:.3g}"
                      + (f", moments max abs err {moments:.3g}"
                         if "moments" in res else "")
                      + f"; {'ok' if not fails else 'FAILED'}")
        if "DistanceFieldNet reduce-scatter Adam" in run_cases:
            for rep in reports:
                fails, err = check_reduce_scatter_vs_psum(rep, world)
                failed += [f"{backend} {world} rank {rep['rank']} "
                           f"reduce-scatter vs psum: {f}" for f in fails]
                print(f"    rank {rep['rank']}: reduce-scatter against psum "
                      f"(Adam, 2 steps, moments in block order): max abs err "
                      f"{err:.3g}; {'ok' if not fails else 'FAILED'}")
        for rep in reports:
            print(f"    rank {rep['rank']} launches {rep['launches']}")
        for e in reports[0].get("kernels", ()):
            k = next(x[0] for x in SHARD_KERNELS if x[4] == e["name"])
            launches = sum(rep["launches"].get(k, 0) for rep in reports)
            shape = e.pop("shape")
            print(f"  {k} alone on rank 0's first sharded train step "
                  f"{tuple(shape)}: {e['ms']:.3f} ms, plain {e['plain_ms']:.1f} "
                  f"ms, bound {e['bound_ms']:.3f} ms ({e['bound_by']}); "
                  f"{launches} launches over the {world} ranks")
            kernels.append(dict(e, name=f"{e['name']} (sharded train step, "
                                f"{world} gloo ranks on one card)",
                                launches=launches))
    if failed:
        raise AssertionError(f"train_sharded: {len(failed)} failures: "
                             + "; ".join(failed[:10]))


# ---------------- slice 12: the NumPy API over every card ----------------

API_SHARD = 768  # bench.py's volume past the auto-shard threshold, 600^3
API_SHARD_ODD = (767, 768, 766)  # divides no axis by 4
API_SHARD_VG = 320  # the vg phase's volume (b), doubled 640^3 >= 600^3
API_SHARD_REPS = 3


def sync_cards():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def wall_ms(fn, reps):
    """Host-clock ms of ``fn()`` (a NumPy API call: it returns once its
    result is on the host), each run after every card is idle."""
    times = []
    for _ in range(reps):
        sync_cards()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def card_profile(fn, label):
    """One run of ``fn`` under torch.profiler: its wall time and, on each
    card, the device time of host-to-device copies, device-to-host
    copies, peer copies (the rotations' blocks) and kernels (K1 apart),
    and the card's idle share (1 - busy / wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    sync_cards()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync_cards()
        wall = (time.perf_counter() - t0) * 1e3
    cards = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.name.startswith(
                "Activity Buffer"):
            continue
        name = ev.name
        kind = ("host to device" if name.startswith("Memcpy HtoD") else
                "device to host" if name.startswith("Memcpy DtoH") else
                "peer copies" if name.startswith(("Memcpy PtoP",
                                                  "Memcpy DtoD")) else
                "K1" if "minplus" in name else "other kernels")
        c = cards.setdefault(ev.device_index, {})
        c[kind] = c.get(kind, 0.0) + ev.time_range.elapsed_us() / 1e3
    print(f"profile {label}: wall {wall:.2f} ms (a kind with no events "
          f"was not captured)")
    for i, c in sorted(cards.items()):
        busy = sum(c.values())
        parts = ", ".join(f"{k} {v:.2f}" for k, v in sorted(c.items()))
        print(f"  card {i}: busy {busy:.2f} ms ({parts}), idle share "
              f"{max(0.0, 1 - busy / wall):.3f}")
    return wall, cards


def staged_call(fn):
    """``fn()`` (a sharded API call) with every card synchronised between
    its stages, each stage's host-clock ms: the upload (host volume to
    slabs on the cards), the passes, the rotations (every
    ``peer_exchange``: the pass rotations and the re-cuts of the slabs)
    and the gather to the host. The barriers cost the stages' overlap:
    their sum is no wall time of the call itself."""
    from edt_tpu_torch.parallel import local, sharded

    ms = {"upload": 0.0, "passes": 0.0, "rotations": 0.0, "gather": 0.0}
    marks = {}
    slabs_fn, exchange_fn = sharded.edtsq_slabs, local.peer_exchange

    def timed_exchange(devices):
        exchange = exchange_fn(devices)

        def run(slabs, split_axis, concat_axis):
            sync_cards()
            t = time.perf_counter()
            out = exchange(slabs, split_axis, concat_axis)
            sync_cards()
            ms["rotations"] += (time.perf_counter() - t) * 1e3
            return out
        return run

    def timed_slabs(*a, **kw):
        sync_cards()
        marks["in"] = time.perf_counter(), ms["rotations"]
        out = slabs_fn(*a, **kw)
        sync_cards()
        marks["out"] = time.perf_counter(), ms["rotations"]
        return out

    sync_cards()
    sharded.edtsq_slabs, local.peer_exchange = timed_slabs, timed_exchange
    try:
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
    finally:
        sharded.edtsq_slabs, local.peer_exchange = slabs_fn, exchange_fn
    (t_in, rot_in), (t_out, rot_out) = marks["in"], marks["out"]
    ms["upload"] = (t_in - t0) * 1e3 - rot_in
    ms["passes"] = (t_out - t_in) * 1e3 - (rot_out - rot_in)
    ms["gather"] = (t1 - t_out) * 1e3 - (ms["rotations"] - rot_out)
    return ms


def staged_one_card(lab, dev):
    """The NumPy API's one-card path on ``lab`` (its uint32 labels viewed
    as int32, as ``api._as_device_labels`` does) with the card synchronised
    between its stages, each stage's host-clock ms: upload, passes,
    gather."""
    from edt_tpu_torch import api
    from edt_tpu_torch.ops import compose

    ms = {}
    sync_cards()
    t = time.perf_counter()
    lt = torch.from_numpy(lab.view(np.int32)).to(dev)
    sync_cards()
    ms["upload"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    out = compose.edtsq(lt, ANISO, True, axis_order=api._sorted_axis_order(
        np.asarray(ANISO, np.float32)))
    sync_cards()
    ms["passes"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    out.contiguous().cpu().numpy()
    ms["gather"] = (time.perf_counter() - t) * 1e3
    return ms


def print_stages(label, runs):
    print(f"api_shard (d): {label}, stages with every card synchronised "
          f"between them (ms): " + "; ".join(
              ", ".join(f"{k} {v:.1f}" for k, v in s.items()) for s in runs))


def c6_run(labels, socc, dev):
    """The forward (K1), bench.py's fwd+bwd at SMALL (K2, K3, K4) and the
    softmin fwd+bwd (K5, K6) on ``dev``; the results on the host."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import compose

    lt = torch.from_numpy(labels.view(np.int32)).to(dev)
    barrier = float(np.sum((np.asarray(ANISO) * SMALL) ** 2))
    fwd = compose.edtsq(lt, ANISO, True)
    ml = fwd_bwd(lt, (lt != 0).to(torch.float32), True, barrier)
    sm = value_and_grad(
        lambda o, k: soft.soft_edtsq(o, (1.0, 1.0, 1.0), True,
                                     float(3 * SMALL ** 2), SOFT_T,
                                     kernels=k),
        torch.from_numpy(socc).to(dev), soft.KERNELS)
    return [t.cpu() for t in (fwd, *ml, *sm)]


def check_c6(first, last):
    """(a) Each of K1 to K6 on tensors on ``last`` while ``first`` is
    current, on the default stream and on a stream of its own, against
    the same calls on ``first``: K1 and K2 (the forwards) bit-equal, K3
    and K4 (the gradient), K5 and K6 within the tolerances of the K5-K6
    phase; and the NumPy API pinned to either card."""
    from edt_tpu_torch import api
    from edt_tpu_torch.ops import minplus

    labels = make_labels(np.random.default_rng(3), SMALL)
    socc = (np.random.default_rng(42).random((SMALL,) * 3)
            > 0.5).astype(np.float32)
    exact, close = Exact(), Close()
    close5, close6 = Close(1e-5, atol=1e-4), Close(1e-4, atol=0.0,
                                                     atol_rel=1e-4)
    torch.cuda.set_device(first)
    ref = c6_run(labels, socc, first)
    for stream in (None, torch.cuda.Stream(last)):
        tag = "its own stream" if stream else "the default stream"
        zero_all_launches()
        with (torch.cuda.stream(stream) if stream
              else contextlib.nullcontext()):
            # entering a stream's context makes its card current: undo that
            torch.cuda.set_device(first)
            got = c6_run(labels, socc, last)
        want = {"K1": 2, "K2": 2, "K3": 2, "K4": 1, "K5": 3, "K6": 3}
        if all_launches() != want or minplus.card_launches != {
                last.index: 2}:
            raise AssertionError(
                f"C6 on card {last.index}, {tag}: launches {all_launches()},"
                f" K1 by card {minplus.card_launches}; expected {want}")
        if torch.cuda.current_device() != first.index:
            raise AssertionError("C6: the current card changed")
        for name, chk, g, r in zip(
                ("K1 forward", "K2 forward", "K3-K4 gradient", "K5 forward",
                 "K6 gradient"), (exact, exact, close, close5, close6),
                got, ref):
            chk.check(f"{name} on card {last.index} ({tag})", g, r)
    exact.check(f"api.edtsq {SMALL}^3 device={last}",
                api.edtsq(labels, ANISO, True, device=last),
                api.edtsq(labels, ANISO, True, device=first))
    for chk in (exact, close, close5, close6):
        chk.raise_if_failed(f"C6: kernels on card {last.index}")
    print(f"api_shard (a): K1 to K6 on card {last.index} while card "
          f"{first.index} is current, on the default stream and on its own,"
          f" equal to card {first.index} (K1, K2 bit-equal; K3-K6 within "
          f"tolerance); api.edtsq device={last} bit-equal to device={first}")


def sharded_api_case(exact, name, fn, ref_fn, k1_each, n):
    """``fn()`` (the API at its default, sharded over n cards) counted:
    sharded_dispatches, K1 ``k1_each`` times on every card and no other
    kernel; bit-equal to ``ref_fn()`` (the API on card 0). Returns the K1
    launches by card of ``fn()``."""
    from edt_tpu_torch.ops import minplus
    from edt_tpu_torch.utils.profiling import counters

    dispatches = k1_each // 2
    counters.reset()
    zero_all_launches()
    got = fn()
    want = {k: 0 for k in all_launches()}
    want["K1"] = k1_each * n
    per_card = {i: k1_each for i in range(n)}
    if (counters.sharded_dispatches != dispatches
            or all_launches() != want or minplus.card_launches != per_card):
        raise AssertionError(
            f"{name}: sharded_dispatches {counters.sharded_dispatches}, "
            f"launches {all_launches()}, K1 by card {minplus.card_launches};"
            f" expected {dispatches}, {want}, {per_card}")
    exact.check(name, torch.from_numpy(got), torch.from_numpy(ref_fn()))
    print(f"api_shard: {name}: sharded_dispatches {dispatches}, K1 by card "
          f"{per_card}, bit-equal to the API on card 0")
    return per_card


def phase_api_shard(kernels, dev):
    """The NumPy API's auto-sharding over every card of one process.
    Two or more cards: (a) C6, every kernel launched on a card that is not
    the current one; (b) bench.py's volume at 768^3 through the API at the
    default threshold, sharded and bit-equal to card 0, and 767 x 768 x
    766 (black_border off), its bool mask and ``sdf``; (c) the voxel graph
    at 320^3; (d) the API's wall ms on one card and on all (host copies in
    threads, and in turn), a staged split and each card's profile. One
    card: the 768^3 call stays on it."""
    from edt_tpu_torch import api
    from edt_tpu_torch.ops import minplus
    from edt_tpu_torch.parallel import local
    from edt_tpu_torch.utils.profiling import counters

    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    n = torch.cuda.device_count()
    first = torch.device("cuda", 0)
    lab = make_labels(np.random.default_rng(42), API_SHARD)
    full = f"{API_SHARD}^3"
    if n < 2:
        counters.reset()
        zero_all_launches()
        with Capture() as cap:
            out = api.edtsq(lab, ANISO, True)
        if (counters.sharded_dispatches != 0 or minplus.launches != 2
                or minplus.card_launches != {0: 2}):
            raise AssertionError(
                f"api_shard on one card: sharded_dispatches "
                f"{counters.sharded_dispatches}, K1 by card "
                f"{minplus.card_launches}; expected 0 and {{0: 2}}")
        if out.shape != lab.shape or not np.isfinite(out).all():
            raise AssertionError(f"api_shard: {full} wrong shape or values")
        per_card = dict(minplus.card_launches)
        one = wall_ms(lambda: api.edtsq(lab, ANISO, True), API_SHARD_REPS)
        print(f"api_shard: one card ({smi[0]}): the {full} API call stays on "
              f"it (sharded_dispatches 0, K1 by card {per_card}); "
              f"{statistics.median(one):.1f} ms median of "
              f"{[round(t, 1) for t in one]}. (a) kernels on a card that is "
              f"not the current one, (b) the sharded dispatch, (c) the "
              f"sharded voxel graph and (d) the n-card times need two cards:"
              f" not run")
        print_stages(f"{full} on one card",
                     [staged_one_card(lab, first) for _ in range(2)])
        card_profile(lambda: api.edtsq(lab, ANISO, True),
                     f"{full} API call, one card")
    else:
        last = torch.device("cuda", n - 1)
        print(f"api_shard: {n} cards: " + "; ".join(smi))
        check_c6(first, last)
        exact = Exact()
        # (b) the dispatch at full width
        with Capture() as cap:
            per_card = sharded_api_case(
                exact, f"{full} edtsq black_border",
                lambda: api.edtsq(lab, ANISO, True),
                lambda: api.edtsq(lab, ANISO, True, device=first), 2, n)
        odd = lab[tuple(slice(0, s) for s in API_SHARD_ODD)]
        sharded_api_case(exact, "x".join(map(str, API_SHARD_ODD))
                         + " edtsq, open border",
                         lambda: api.edtsq(odd, ANISO, False),
                         lambda: api.edtsq(odd, ANISO, False, device=first),
                         2, n)
        del odd
        mask = lab != 0
        sharded_api_case(exact, f"{full} bool edtsq (binary path)",
                         lambda: api.edtsq(mask, ANISO, True),
                         lambda: api.edtsq(mask, ANISO, True, device=first),
                         2, n)
        del mask
        sharded_api_case(exact, f"{full} sdf", lambda: api.sdf(lab, ANISO, True),
                         lambda: api.sdf(lab, ANISO, True, device=first), 4, n)
        # (c) the voxel graph, gated on its doubled size
        rng = np.random.default_rng(11)
        vdata = make_labels(rng, API_SHARD_VG)
        vgraph = vg_graph(rng, vdata.shape)
        sharded_api_case(exact, f"{API_SHARD_VG}^3 voxel graph",
                         lambda: api.edtsq(vdata, ANISO, True,
                                           voxel_graph=vgraph),
                         lambda: api.edtsq(vdata, ANISO, True,
                                           voxel_graph=vgraph, device=first),
                         2, n)
        exact.raise_if_failed("api_shard")
        # (d) times: one card and every card in turns, and every card with
        # the host copies one card after another
        runs = {"one card": lambda: api.edtsq(lab, ANISO, True, device=first),
                f"{n} cards": lambda: api.edtsq(lab, ANISO, True)}
        threaded = local._on_cards

        def in_turn():
            local._on_cards = lambda fn, k: [fn(i) for i in range(k)]
            try:
                return api.edtsq(lab, ANISO, True)
            finally:
                local._on_cards = threaded

        runs[f"{n} cards, host copies in turn"] = in_turn
        times = {k: [] for k in runs}
        for rep in range(API_SHARD_REPS):
            for k in (list(runs) if rep % 2 == 0 else list(runs)[::-1]):
                times[k] += wall_ms(runs[k], 1)
        for k, ts in times.items():
            print(f"api_shard (d): {full} API call, {k}: "
                  f"{statistics.median(ts):.1f} ms median of "
                  f"{[round(t, 1) for t in ts]} ({smi[0]})")
        print_stages(f"{full} on one card",
                     [staged_one_card(lab, first) for _ in range(2)])
        print_stages(f"{full} over {n} cards",
                     [staged_call(runs[f"{n} cards"]) for _ in range(2)])
        card_profile(runs["one card"], f"{full} API call, one card")
        card_profile(runs[f"{n} cards"], f"{full} API call, {n} cards")
    with torch.no_grad():
        e = shard_kernel_entry("K1", cap.calls["K1"], None)
    del cap
    shape = e.pop("shape")
    launches = sum(per_card.values())
    print(f"  K1 alone on the first call of the {full} API call "
          f"{tuple(shape)}: {e['ms']:.3f} ms, plain {e['plain_ms']:.1f} ms, "
          f"bound {e['bound_ms']:.3f} ms ({e['bound_by']}); launches by card "
          f"{per_card} ({smi[0]})")
    kernels.append(dict(e, name=f"{e['name']} (api_shard: the NumPy API at "
                        f"{full}, {n} card{'s' if n > 1 else ''})",
                        launches=launches,
                        launches_per_card=[per_card.get(i, 0)
                                           for i in range(n)]))


def main(only=()) -> int:
    """Every phase; with ``only`` (command-line words), the build and the
    phases whose names contain one of them, and no result lines."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import edt_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    dev = torch.device("cuda")
    # the trainers' f32 matmuls and convolutions in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exact = Exact()  # K1 and slice 1
    exact2 = Exact()  # K2 and the forward of slice 2
    close = Close()  # the gradients of slice 2
    close3, close4 = Close(), Close()  # K3, K4
    # K5 and K6: the JAX package's tolerances for its softmin kernels
    close5 = Close(1e-5, atol=1e-4)
    close6 = Close(1e-4, atol=0.0, atol_rel=1e-4)
    # the softmin slice: forward as K5, gradients as K6's df
    soft_f = Close(1e-5, atol=1e-4)
    soft_g = Close(1e-4, atol=0.0, atol_rel=1e-4)
    close_train = Close(rtol=1e-4, atol=3e-5)  # parameters, 1e-2 lr
    kernels = []
    failed = []
    t0 = time.perf_counter()
    phases = [("build", phase_build),
              ("kernel vs plain", lambda: phase_kernel_cases(exact, dev)),
              ("slice 128^3", lambda: phase_slice_small(exact, dev)),
              ("slice 512^3", lambda: phase_slice_full(exact, kernels, dev)),
              ("K2-K4 vs plain",
               lambda: phase_grad_kernel_cases(exact2, close3, close4, dev)),
              ("soft slice 128^3",
               lambda: phase_soft_small(exact2, close, dev)),
              ("soft slice 512^3",
               lambda: phase_soft_full(exact2, close, close3, close4, kernels,
                                       dev)),
              ("K5-K6 vs plain",
               lambda: phase_softmin_kernel_cases(close5, close6, dev)),
              ("softmin slice 128^3",
               lambda: phase_softmin_small(soft_f, soft_g, dev)),
              ("softmin 256^3",
               lambda: phase_softmin_full(close5, close6, kernels, dev)),
              ("DistanceFieldNet trainer",
               lambda: phase_distance_net(close_train, close5, close6, dev)),
              ("UNet3D trainer", lambda: phase_unet3d(close_train, dev)),
              ("vg: voxel graph", lambda: phase_voxel_graph(exact, dev)),
              ("k1_floor: K1's floors on the ball, sdf, 768^3 and chunk "
               "passes", lambda: phase_k1_floor(Exact(), dev)),
              ("each: per-label extraction", lambda: phase_each(exact, dev)),
              ("export: 512^3 forward", lambda: phase_export(exact, dev)),
              ("long: rows past the ceilings",
               lambda: phase_long(Exact(), Close(), Close(),
                                  Close(1e-5, atol=1e-4),
                                  Close(1e-4, atol=0.0, atol_rel=1e-4),
                                  Close(1e-5, atol=1e-4),
                                  Close(1e-4, atol=0.0, atol_rel=1e-4),
                                  kernels, dev)),
              ("export_grad: exported gradients",
               lambda: phase_export_grad(Exact(), dev)),
              ("sharded: torch.distributed ranks",
               lambda: phase_sharded(kernels, dev)),
              ("train_sharded: the trainers' sharded steps",
               lambda: phase_train_sharded(kernels, dev)),
              ("api_shard: the NumPy API over every card",
               lambda: phase_api_shard(kernels, dev))]
    # tuning sweeps, run only when named
    phases += [("k3_modes: K3's two modes below its ceiling",
                lambda: k3_modes(dev)),
               ("split_profiles: K3's and K6's row-split calls by kernel",
                lambda: split_profiles(dev))]
    on_request = {name for name, _ in phases[-2:]}
    phases = [(name, fn) for name, fn in phases if name == "build"
              or (not only and name not in on_request)
              or any(w.lower() in name.lower() for w in only)]
    for name, fn in phases:
        t = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            if name == "build":
                break
        print(f"[{name}] {time.perf_counter() - t:.1f} s")
    print(f"total {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if only:
        print(f"chip_smoke: ran only {[name for name, _ in phases]}")
        return 0
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
