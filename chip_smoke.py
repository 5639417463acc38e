"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``edt_tpu_torch/csrc``, holds every kernel
against its plain PyTorch version on the card (K1 and K2 bit-exact, K3 and
K4 within rtol=1e-5, atol=1e-5: the same sums in another order, K3 the
same bits from two launches; K5 and K6 within the JAX package's
tolerances for its softmin kernels; K2's outward search on rows that
stress its exact stop, K3 on links K2 never makes, both up to and beyond
their ceilings), and drives the port's main paths:

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
  2 x 128^3.

Each path runs with the launch counts set to 0 just before it and checked
just after. Times come from CUDA events. Prints one JSON line with the
kernels' numbers, then as its last line ``{"ok": true, "device": {...}}``.
Exits non-zero, without that line, when there is no CUDA device or any
phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

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
    blk = max(1, size // 16)
    base = rng.integers(0, 6, size=(size // blk,) * 3)
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


class Exact:
    """Bit-exact comparisons: same INF pattern, equal finite values."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.failures = []

    def check(self, name, got, ref):
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


def k1_candidates(f, ss, se, w2, black_border, masked):
    """Candidates K1 scans on these inputs (its per-row radius, windows
    clipped to the row and, masked, to the target's segment)."""
    from edt_tpu_torch.ops import core

    R, n = f.shape
    w2 = core.f32(w2)
    i = torch.arange(n, dtype=torch.int32, device=f.device)
    bound = f
    if masked:
        lw = (i - ss + 1).to(torch.float32).square() * w2
        rw = (se - i).to(torch.float32).square() * w2
        if not black_border:
            lw = torch.where(ss > 0, lw, float("inf"))
            rw = torch.where(se < n, rw, float("inf"))
        bound = torch.minimum(f, torch.minimum(lw, rw))
    elif black_border:
        bw = core.binary_border_sq(torch.full_like(f, float("inf")), n, w2)
        bound = torch.minimum(f, bw)
    r = row_radii(f, bound, w2)
    lo = torch.clamp(i - r, min=0)
    hi = torch.clamp(i + r + 1, max=n)
    if masked:
        lo = torch.maximum(lo, ss)
        hi = torch.minimum(hi, se)
    return int((hi - lo).clamp(min=0).sum())


def k1_bound_ms(f, ss, se, w2, black_border, masked):
    """Least time for K1's work on the card: HBM bytes (f, and ss/se when
    masked, read once; d written once) or f32 operations (4 a candidate:
    square, scale, add, min), whichever is larger."""
    nbytes = f.numel() * (16 if masked else 8)
    return bound_ms(nbytes, 4 * k1_candidates(f, ss, se, w2, black_border,
                                              masked))


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
    position, clipped to the row; a NaN or negative gap has none): what
    K5 and K6 sum on these inputs."""
    n = gap.shape[-1]
    i = torch.arange(n, device=gap.device)
    r = torch.floor(torch.sqrt(gap.clamp(min=0.0) / w2)).clamp(max=n)
    r = torch.where(gap >= 0, r, -1.0).to(torch.int64)
    cnt = torch.clamp(i + r, max=n - 1) - torch.clamp(i - r, min=0) + 1
    return int(torch.where(r >= 0, cnt, 0).sum())


def k5_work(f, w2, t):
    """(hard-min candidates, exp terms) of K5 on these inputs."""
    from edt_tpu_torch.ops import argmin, core

    minf = f.amin(dim=1, keepdim=True)
    dmin, _ = argmin.minplus_argmin(f, w2)
    cut = core.f32(30.0 * t)
    return window_terms(dmin - minf, w2), window_terms(dmin + cut - minf, w2)


def k6_work(f, d, w2, t):
    """Exp terms of K6 on these inputs: df's over the sources, e's over
    the targets."""
    from edt_tpu_torch.ops import core

    cut = core.f32(30.0 * t)
    minf = f.amin(dim=1, keepdim=True)
    maxd = d.amax(dim=1, keepdim=True)
    return (window_terms(maxd + cut - f, w2)
            + window_terms(d + cut - minf, w2))


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
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")


def phase_kernel_cases(exact, dev):
    """K1 against its plain version, bit-exact, over the regimes it has."""
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
            cases.append((f"n={n} w={w}", f, lab, w))
    # the mixed band/large-radius field of the JAX kernel tests
    f = rng.random((10, 300)).astype(np.float32) * 25
    lab = rng.integers(0, 3, size=(10, 300)).astype(np.int32)
    f[:, 100:260] = 500.0
    lab[:, 100:260] = 1
    cases.append(("mixed", f, lab, 1.1))
    # constant rows: radius 0
    i = np.arange(300, dtype=np.float32)
    cases.append(("constant", np.repeat((i ** 2)[:, None], 40, axis=1),
                  np.ones((300, 40), np.int32), 1.0))
    # all-INF rows beside finite ones
    f = rng.random((64, 200)).astype(np.float32) * 50
    f[::2] = np.inf
    cases.append(("all-inf rows", f, np.ones((64, 200), np.int32), 1.3))
    # one source per row, INF elsewhere: every row scans in full
    f = np.full((8, 2049), np.inf, np.float32)
    f[np.arange(8), rng.integers(0, 2049, size=8)] = 0.0
    lab = np.ones((8, 2049), np.int32)
    lab[f == 0] = 0
    cases.append(("full-row radius", f, lab, 1.3))

    for name, f, lab, w in cases:
        w2 = core.f32(core.f32(w) ** 2)
        for binary in (False, True):
            lb = (lab != 0).astype(np.int32) if binary else lab
            ff = np.where(lb == 0, np.float32(0), f).astype(np.float32)
            ft = torch.from_numpy(ff).to(dev)
            ss, se = core.segment_bounds(torch.from_numpy(lb).to(dev))
            for bb in (False, True):
                got = minplus.minplus_walls(ft, ss, se, w2, bb, not binary)
                ref = minplus.minplus_walls_plain(ft, ss, se, w2, bb,
                                                  not binary)
                exact.check(f"{name} binary={binary} bb={bb}", got, ref)
    # the longest row the kernel takes, one source: d = w2 i^2 exactly
    n = minplus.MAX_AXIS
    ft = torch.full((4, n), float("inf"), device=dev)
    ft[:, 0] = 0.0
    w2 = core.f32(1.69)
    idx = torch.arange(n, dtype=torch.float32, device=dev)
    got = minplus.minplus_walls(ft, None, None, w2, False, False)
    exact.check(f"n={n} one source", got, ((idx * idx) * w2).expand(4, n))
    exact.raise_if_failed("kernel vs plain")
    print(f"kernel vs plain: {len(cases) * 4 + 1} cases bit-exact")


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
    exact.raise_if_failed("slice at 128^3")
    # an independent oracle: the host FH implementation (f64 intercepts)
    small = make_labels(np.random.default_rng(4), 64)
    got = et.edtsq(small, ANISO, True, device=dev)
    ref = host_reference.edtsq_host(small, ANISO, True)
    if got.shape != ref.shape or not np.allclose(got, ref, rtol=1e-5):
        raise AssertionError("64^3 edtsq disagrees with the host oracle")
    print("slice at 128^3: bit-exact to the plain path; 64^3 matches the "
          "host oracle")


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

    # K1 alone on the first parabolic pass's inputs (axis 1, w = 6)
    f = compose._along_last(lambda lab: core.rp_pass_sq(lab, ANISO[2], True),
                            2, lt)
    f2 = f.movedim(1, -1).contiguous().reshape(-1, FULL)
    l2 = lt.movedim(1, -1).contiguous().reshape(-1, FULL)
    ss, se = core.segment_bounds(l2)
    w2 = core.f32(ANISO[1] ** 2)
    k1 = lambda: minplus.minplus_walls(f2, ss, se, w2, True, True)  # noqa: E731
    k1_ms, _ = cuda_ms(k1, reps=20, warmup=2)
    pl = lambda: minplus.minplus_walls_plain(f2, ss, se, w2, True, True)  # noqa: E731
    plain_ms, _ = cuda_ms(pl, reps=3)
    exact.check("512^3 K1 pass vs plain", k1(), pl())
    exact.raise_if_failed("K1 at 512^3")
    bound_ms, bound_by = k1_bound_ms(f2, ss, se, w2, True, True)
    cands = k1_candidates(f2, ss, se, w2, True, True)

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
    print(f"K1 one pass {tuple(f2.shape)}: {k1_ms:.3f} ms, plain {plain_ms:.1f} "
          f"ms, bound {bound_ms:.3f} ms ({bound_by}), "
          f"{cands / f2.numel():.1f} candidates a voxel")
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


def check_ceilings(dev):
    """K2 and K3 raise ValueError on rows one longer than their ceilings."""
    from edt_tpu_torch.ops import argmin, grad

    for name, fn, n in (
            ("K2", lambda x: argmin.minplus_argmin(x, 1.0), argmin.MAX_AXIS + 1),
            ("K3", lambda x: grad.minplus_grad(
                x, offsets=torch.zeros_like(x, dtype=torch.int32)),
             grad.MAX_AXIS + 1)):
        try:
            fn(torch.zeros((1, n), device=dev))
        except ValueError:
            continue
        raise AssertionError(f"{name}: rows of {n} did not raise")


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
    check_ceilings(dev)
    exact.raise_if_failed("K2 vs plain")
    close3.raise_if_failed("K3 vs plain")
    close4.raise_if_failed("K4 vs plain")
    print(f"K2 vs plain: {n_k2 + 1} cases bit-exact, up to n={n}; K3 and K4 "
          f"vs plain on {len(cases) + 1} residuals, and K3 on {n_k3} more link "
          f"sets up to n={n}, each launched twice to the same bits, within "
          f"rtol={close3.rtol}, atol={close3.atol}: max abs err K3 "
          f"{close3.max_abs_err}, K4 {close4.max_abs_err}; both raise beyond "
          f"their ceilings")


def fwd_bwd(labels, occ, binary_occupancy, barrier, kernels=None):
    """bench.py's step on the port: multilabel_edtsq and the gradient of
    its sum w.r.t. the occupancy."""
    from edt_tpu_torch.models import soft

    occ = occ.detach().requires_grad_()
    out = soft.multilabel_edtsq(labels, occ, ANISO, black_border=True,
                                barrier=barrier,
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
    sum(g * e) within rtol=1e-3."""
    from edt_tpu_torch.ops import softmin

    df, e = softmin.softmin_grad(f, d, g, w2, t)
    rdf, re = softmin.softmin_grad_plain(f, d, g, w2, t)
    close6.check(f"K6 df {name}", df, rdf)
    close6.check_sum(f"K6 sum(g e) {name}", (g * e).sum(), (g * re).sum(),
                     1e-3)


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
                close5.check(f"K5 {name}", softmin.softmin(ft, w2, t), rd)
                # K6 on the finite rows: an all-INF row is NaN in the plain
                # version (INF - INF), as in the JAX package
                g = torch.from_numpy(rng.uniform(-1, 1, (rows - 1, n))
                                     .astype(np.float32)).to(dev)
                check_k6(close6, name, ft[:-1], rd[:-1], g, w2, t)
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
        d = softmin.softmin(ft, 36.0, 0.3)
        close5.check(f"K5 one source n={n}", d, 36.0 * (k * k))
        if n > softmin.GRAD_MAX_AXIS:
            continue
        g = torch.from_numpy(rng.uniform(-1, 1, (rows, n))
                             .astype(np.float32)).to(dev)
        df, e = softmin.softmin_grad(ft, d, g, 36.0, 0.3)
        ref_df = torch.zeros_like(g)
        ref_df[torch.arange(rows), torch.from_numpy(src)] = g.sum(dim=1)
        close6.check(f"K6 df one source n={n}", df, ref_df)
        close6.check(f"K6 e one source n={n}", e, k * k)
    for fn, n in ((lambda x: softmin.softmin(x, 1.0, 0.3),
                   softmin.MAX_AXIS + 1),
                  (lambda x: softmin.softmin_grad(x, x, x, 1.0, 0.3),
                   softmin.GRAD_MAX_AXIS + 1)):
        try:
            fn(torch.zeros((1, n), device=dev))
        except ValueError:
            pass
        else:
            raise AssertionError(f"rows of {n} did not raise")
    close5.raise_if_failed("K5 vs plain")
    close6.raise_if_failed("K6 vs plain")
    print(f"K5-K6 vs plain: {n_cases} cases and 3 one-source rows up to "
          f"n={softmin.MAX_AXIS}; K5 within rtol={close5.rtol}, "
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
    hard, terms5 = k5_work(f1, 1.0, SOFT_T)
    terms6 = k6_work(f1, d1, 1.0, SOFT_T)
    # f32 operations: 4 a hard-min candidate (square, scale, add, min),
    # 6 an exp term besides its exp (square, scale, add, sub, scale, sum),
    # one more in K6 (the product with g or k^2)
    k5_bound = bound_exp_ms(8 * f1.numel(), 4 * hard + 6 * terms5, terms5,
                            exps_per_s)
    k6_bound = bound_exp_ms(20 * f1.numel(), 7 * terms6, terms6, exps_per_s)
    vox1 = f1.numel()
    for name, ms_, pms, (bms, by, term), work in (
            ("K5", k5_ms, k5_plain_ms, k5_bound,
             f"{hard / vox1:.1f} hard-min candidates and {terms5 / vox1:.1f}"
             " exp terms a voxel"),
            ("K6", k6_ms, k6_plain_ms, k6_bound,
             f"{terms6 / vox1:.1f} exp terms a voxel")):
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


def phase_distance_net(close, dev):
    """DistanceFieldNet at the widths of examples/train_distance_net.py:
    one step through the kernels against the plain path at 2 x 128^3, and
    5 timed steps at 2 x 256^3 on one synthetic batch."""
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
    # K5's work on the first pass of this step: the untrained head's
    # sigmoid occupancy against the random cell's two-valued one
    with torch.no_grad():
        f0 = (S * S / 2) * torch.sigmoid(model(feats)).reshape(-1, S)
        hard, terms = k5_work(f0, 1.0, SOFT_T)
    print(f"DistanceFieldNet first pass {tuple(f0.shape)}: K5 scans "
          f"{hard / f0.numel():.1f} hard-min candidates and "
          f"{terms / f0.numel():.1f} exp terms a voxel")


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


def main() -> int:
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
               lambda: phase_distance_net(close_train, dev)),
              ("UNet3D trainer", lambda: phase_unet3d(close_train, dev))]
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
