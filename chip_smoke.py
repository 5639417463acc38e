"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``edt_tpu_torch/csrc``, holds every kernel
bit-exact against its plain PyTorch version on the card, drives the
port's main path (the forward multi-label EDT through ``edt_tpu_torch``)
at 128^3 and at the 512^3 ``bench.py`` volume, times it with CUDA events,
and checks the counts of kernel launches. Prints one JSON line with the
kernels' numbers, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, when
there is no CUDA device or any phase fails. Imports nothing of JAX.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


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
    minf = f.amin(dim=1)
    gap = bound.amax(dim=1) - minf
    gap = torch.where(torch.isfinite(gap), gap.clamp(min=0.0),
                      torch.where(minf == float("inf"), 0.0, float("inf")))
    r = torch.sqrt(gap / w2) * core.f32(1.00001) + core.f32(0.01)
    r = torch.clamp(r, max=float(n)).to(torch.int64)[:, None]
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
    ops = 4 * k1_candidates(f, ss, se, w2, black_border, masked)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profile(fn, label, top=8):
    """One run of ``fn`` under torch.profiler: wall time, device busy time
    (kernels and copies: the device-side events), idle share, and the
    device events that take the most time."""
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
    rows = []
    for ev in prof.key_averages():
        # "Activity Buffer Request" is the profiler's own bookkeeping
        if (ev.device_type != DeviceType.CUDA
                or ev.key.startswith("Activity Buffer")):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    copies = sum(r[0] for r in rows if r[2].startswith("Memcpy"))
    print(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} "
          f"ms (copies {copies:.2f} ms), idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}")
    for ms, count, key in rows[:top]:
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
    exact = Exact()
    kernels = []
    failed = []
    t0 = time.perf_counter()
    phases = [("build", phase_build),
              ("kernel vs plain", lambda: phase_kernel_cases(exact, dev)),
              ("slice 128^3", lambda: phase_slice_small(exact, dev)),
              ("slice 512^3", lambda: phase_slice_full(exact, kernels, dev))]
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
