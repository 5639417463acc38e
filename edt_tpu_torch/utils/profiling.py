"""Profiling and observability helpers (counterpart of
``edt_tpu.utils.profiling``): library counters, a ``torch.profiler`` trace
context and a throughput timer of chained calls."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


class Counters:
    """Process-wide library counters (transforms run, voxels processed,
    dispatch decisions): plain Python ints bumped at the NumPy API layer.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.transforms = 0
        self.voxels = 0
        self.sharded_dispatches = 0
        self.host_fallbacks = 0
        self.voxel_graph_calls = 0

    def snapshot(self) -> dict:
        return {
            "transforms": self.transforms,
            "voxels": self.voxels,
            "sharded_dispatches": self.sharded_dispatches,
            "host_fallbacks": self.host_fallbacks,
            "voxel_graph_calls": self.voxel_graph_calls,
        }


counters = Counters()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed block, host and
    (where there is a card) CUDA activity, as a Chrome trace in
    ``log_dir`` (default: ``edt_tpu_torch_trace`` under the temporary
    directory). Open it in Perfetto or chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "edt_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"[edt_tpu_torch] profiler trace written to {path}")


def _perturb(x, i):
    """Set the first voxel to i % 2, in place on the timer's own copy."""
    x.view(-1)[0] = i % 2
    return x


def throughput(fn, example, iters: int = 3, perturb=None):
    """Voxels/s of ``fn(volume) -> tensor`` on ``example``'s device.

    After one warm call, times ``iters`` chained calls, each on an input
    perturbed by ``perturb(x, i)`` (default: the first voxel set to i % 2
    on a copy of ``example``) and each result's first value summed on the
    device, so no call can be skipped: between two CUDA events on a CUDA
    tensor, on the host clock otherwise.
    """
    if perturb is None:
        perturb = _perturb
    x = example.contiguous().clone()
    cuda = x.device.type == "cuda"

    def chained():
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(iters):
            acc += fn(perturb(x, i)).reshape(-1)[0].to(torch.float32)
        return acc

    float(chained())  # warm: builds and loads what the calls need
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        acc = chained()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        float(acc)
    else:
        t0 = time.perf_counter()
        float(chained())
        seconds = time.perf_counter() - t0
    dt = seconds / iters
    return {"seconds_per_call": dt, "voxels_per_second": x.numel() / dt}
