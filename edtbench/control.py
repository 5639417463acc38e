"""Readings that set the limits of ``correct``: the program's, over many
seeds, and the control's, which has to come out as not correct.

    python3 -m edtbench.control --workload ml512.loss --seeds 1-12 --control-seeds 1-3

For each seed it runs the cell as a benchmark run does (inputs from the
seed, the warm-up, a short window of the cell's own call) and compares the
kept answers with the reference: the program's readings. For each control
seed it also puts the reference computed in bfloat16, the precision below
the configuration's float32, in the program's place on the same kept
calls: the control's readings. It prints one JSON line a seed, then the
largest program reading and the smallest control reading of each number.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from edtbench import loops, ranks, run, spec


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b) + 1) if b else [int(a)])
    return out


def readings(cell, seed, seconds, device, control, group=None):
    """(program's, control's or None) worst reading of each number over the
    kept calls of one short run (and over the ranks, with ``group``)."""
    loop = loops.make(cell, seed, device, group)
    run.window(loop, seconds)
    loop.sync()
    limits = cell.traffic["limits"]
    worst = lambda res: {n: loop.reduce(max(r[n] for _, r in res),  # noqa: E731
                                        dist.ReduceOp.MAX) for n in limits}
    prog = worst(loop.check())
    ctrl = None
    if control:
        ctrl = worst(loop.check(
            answer_of=lambda k: loop.reference(k, dtype=torch.bfloat16)))
    return prog, ctrl


def sweep(cell, device, group, seeds, control_seeds, seconds):
    """[(seed, program's, control's)] of every seed, in one process (a
    rank's job with ``group``)."""
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        out.append((seed, *readings(cell, seed, seconds, device,
                                    seed in control_seeds, group)))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=seeds)
    p.add_argument("--control-seeds", default="", type=lambda t: seeds(t) if t else [])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = spec.load(Path.cwd(), only=args.workload)[args.workload]
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards", file=sys.stderr)
        return 2
    job = functools.partial(sweep, seeds=args.seeds,
                            control_seeds=args.control_seeds,
                            seconds=args.seconds)
    if cell.chips == 1:
        rows = job(cell, torch.device("cuda", 0), None)
    else:
        rows = ranks.launch(Path.cwd(), args.workload, cell.chips, job)
    lower, upper = {}, {}
    for seed, prog, ctrl in rows:
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl}),
              flush=True)
        for n, v in prog.items():
            lower[n] = max(lower.get(n, v), v)
        for n, v in (ctrl or {}).items():
            upper[n] = min(upper.get(n, v), v)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
