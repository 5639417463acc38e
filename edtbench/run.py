"""Run one cell of the benchmark once and print its result line.

    python3 -m edtbench.run --workload ml512.loss --seed 7 --seconds 20 --trace 0

from the root of a checkout. It makes the cell's volume on the card from
the seed, warms up the cell's own call (the first run in a checkout also
builds the program's kernels), calls the program in a closed loop for
``--seconds`` (``edtbench.loops``), checks the kept answers against the
plain reference (``edtbench.reference``) once the window has closed, and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics from a profiled window, with a
``breakdown``), ``device`` and, last, ``checks``: each number compared
beside its limit, which also end standard error. A cell on several cards
runs one process a card (``edtbench.ranks``), and rank 0 prints.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result; so it does if the process holds jax, jaxlib,
flax or the JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from edtbench import loops, ranks, spec, trace as tracing, volumes

FORBIDDEN = ("jax", "jaxlib", "flax", "edt_tpu")


def process_age_s() -> float:
    """Seconds since this process started (10 ms ticks of /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


class Record:
    """What the metric readers read: the loop's kind, the calls completed
    in the window, the voxels a call, the window and set-up in seconds,
    each call's latency, and the traced window's ``Trace`` (or None)."""

    def __init__(self, loop, calls, voxels, window_s, latencies_s, setup_s,
                 trace):
        self.loop = loop
        self.calls = calls
        self.voxels = voxels
        self.window_s = window_s
        self.latencies_s = latencies_s
        self.setup_s = setup_s
        self.trace = trace


def window(loop, seconds):
    """Call the program in a closed loop until ``seconds`` have passed since
    the window opened; the last call's end closes it. Returns (calls,
    window seconds, latencies)."""
    lat = []
    k = 0
    start = time.perf_counter()
    while True:
        answer, t0, t1 = loop.call(k)
        lat.append(t1 - t0)
        last = loop.agree(t1 - start >= seconds)
        loop.keep(k, answer, last)
        del answer
        loop.restore(k)
        if last:
            return k + 1, t1 - start, lat
        k += 1


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(cell, seed, seconds, trace, device, setup_clock=process_age_s,
             group=None):
    """One run of ``cell``; returns (result dict, check lines). The checks'
    numbers are the largest over the kept calls (and the ranks). With
    ``group``, every rank calls it and rank 0's result is the run's: its
    clock, its trace, the fullest card's peak, the ranks' mean busy time."""
    stages = [("imports", setup_clock())]
    loop = loops.make(cell, seed, device, group)
    rank0 = loop.rank == 0
    stages.append(("inputs", setup_clock()))
    for k in (loops.POOL - 1, loops.POOL - 2):  # the cell's own call, twice
        answer, _, _ = loop.call(k)
        del answer
        loop.restore(k)
        stages.append(("warm-up call", setup_clock()))
    loop.sync()
    setup_s = setup_clock()
    if rank0:
        print("set-up, s since process start: " + ", ".join(
            f"{name} {t:.2f}" for name, t in stages), file=sys.stderr)
    prof = None
    if trace:
        loop.spans = {}
        with tracing.profiled(device) as prof:
            calls, window_s, lat = window(loop, seconds)
    else:
        calls, window_s, lat = window(loop, seconds)
    loop.sync()
    held = sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))
    if held:
        raise SystemExit(f"the process holds {', '.join(held)}: the port "
                         f"must not load JAX or the JAX package")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    peak = loop.reduce(peak, dist.ReduceOp.MAX)
    tr = None
    if prof is not None:
        tr = tracing.read(prof, loop.span_ms(),
                          volumes.label_bytes(cell.config["volume"]))
        del prof
    rec = Record(cell.traffic["loop"], calls, loop.voxels, window_s, lat,
                 setup_s, tr)
    metrics = {}
    for m in cell.metrics:
        if m.end_to_end == bool(trace):
            continue
        v = m.read(rec)
        if v is None and m.end_to_end:
            raise RuntimeError(f"{cell.name}: no reading of {m.name}")
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    results = loop.check()
    limits = cell.traffic["limits"]
    worst = {n: loop.reduce(max(r[n] for _, r in results), dist.ReduceOp.MAX)
             for n in limits}
    failed = int(loop.reduce(sum(any(r[n] > limits[n] for n in limits)
                                 for _, r in results), dist.ReduceOp.SUM))
    correct = bool(results) and failed == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if device.type == "cuda" and rank0:
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": correct, "attempted": calls, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = loop.reduce(tr.busy_us, dist.ReduceOp.SUM) / loop.world * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = {n: {"value": worst[n], "limit": limits[n]}
                        for n in limits}
    lines = [f"check {n}: {worst[n]!r} (limit {limits[n]!r}) over "
             f"{len(results)} kept calls" for n in limits]
    return result, lines


def rank_job(cell, device, group, seed, seconds, trace):
    """``run_cell`` as one rank's job (``ranks.launch``)."""
    return run_cell(cell, seed, seconds, trace, device, group=group)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()  # the program builds its kernels in its own _build/
    cell = spec.load(root, only=args.workload)[args.workload]
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    if cell.chips == 1:
        result, lines = run_cell(cell, args.seed, args.seconds, args.trace,
                                 torch.device("cuda", 0))
    else:
        result, lines = ranks.launch(
            root, args.workload, cell.chips,
            functools.partial(rank_job, seed=args.seed, seconds=args.seconds,
                              trace=args.trace))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
