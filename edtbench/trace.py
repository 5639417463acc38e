"""The traced run's reading of the device: ``torch.profiler`` over the
measured window, reduced to what the per-layer readers and the result's
``breakdown`` need.

The window is the benchmark's own span ``edtbench.window``; device events
(kernels, copies, fills) are clipped to it. Busy time is the union of
their intervals, so overlapping kernels count once; idle is the rest of
the window. An idle gap is named by what the host was doing at its middle:
the innermost profiled host event then running, in any thread.
"""

from __future__ import annotations

import contextlib
import heapq

import torch

from edtbench import roofline

WINDOW = "edtbench.window"
PROGRAM_OPS = "edt_tpu_torch::"


class Trace:
    """One traced window: ``device_events`` [(name, start_us, end_us)],
    ``host_ops`` [(op name, input shapes)] of the program's custom ops,
    ``host_events`` [(start_us, end_us, name)], ``spans`` {name: [ms]}
    (the benchmark's own CUDA-event spans), ``label_bytes`` (the width of
    the cell's labels, for the kernels' counts)."""

    def __init__(self, window, device_events, host_ops, host_events,
                 spans=None, label_bytes=4):
        self.window = window
        self.device_events = device_events
        self.host_ops = host_ops
        self.host_events = host_events
        self.spans = spans or {}
        self.label_bytes = label_bytes
        self.busy = _union([(s, e) for _, s, e in device_events])

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy)

    def kernel_us(self, keep) -> float:
        """Device time of the kernels (copies and fills of memory apart)
        whose family ``keep`` accepts (``roofline.kernel_family``: "K1" ..
        "K6", "NCCL" or None)."""
        return sum(e - s for name, s, e in self.device_events
                   if not name.startswith(("Memcpy", "Memset"))
                   and keep(roofline.kernel_family(name)))

    def idle_gaps(self):
        """[(start_us, end_us)] of the window that no device event covers."""
        gaps, t = [], self.window[0]
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@contextlib.contextmanager
def profiled(device):
    """Profile the body (host ops with their input shapes, and the card's
    events where there is one) inside the ``edtbench.window`` span; the
    profiler is yielded, to be read with ``read`` after the body."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        with record_function(WINDOW):
            yield prof


def read(prof, spans=None, label_bytes=4) -> Trace:
    """The ``Trace`` of a finished ``profiled`` block."""
    from torch.autograd import DeviceType

    window, device_events, host_ops, host_events = None, [], [], []
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            # "Activity Buffer Request" is the profiler's own bookkeeping;
            # a span's shadow on the device's timeline is no work
            if not (ev.name.startswith("Activity Buffer")
                    or getattr(ev, "is_user_annotation", False)
                    or ev.name == WINDOW):
                device_events.append((ev.name, s, e))
            continue
        if ev.name == WINDOW:
            window = (s, e)
            continue
        host_events.append((s, e, ev.name))
        if ev.name.startswith(PROGRAM_OPS):
            host_ops.append((ev.name, [list(x) for x in ev.input_shapes]))
    if window is None:
        raise RuntimeError(f"the trace lost its {WINDOW} span")
    w0, w1 = window
    device_events = [(n, max(s, w0), min(e, w1)) for n, s, e in device_events
                     if e > w0 and s < w1]
    return Trace(window, device_events, host_ops, host_events, spans,
                 label_bytes)


def breakdown(trace: Trace, top=10) -> dict:
    """The result's ``breakdown``: the device operations that took most
    time, by kernel name (template arguments kept, argument lists cut),
    and the idle time by what the host was doing, in seconds."""
    ops = {}
    for name, s, e in trace.device_events:
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6
    idle = {}
    for (s, e), name in zip(*_name_gaps(trace)):
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    by = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                          key=lambda kv: -kv[1])[:top]
    return {"device_ops": by(ops), "idle_gaps": by(idle)}


def short_name(kernel: str, width=160) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list (the last top-level parenthesis), cut to ``width``."""
    name = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name.strip()[:width]


def _name_gaps(trace: Trace):
    """The idle gaps, and for each the innermost host event (the latest to
    start among those running) at its middle, or "host outside any op"."""
    gaps = trace.idle_gaps()
    events = sorted(trace.host_events)
    names, heap, i = [], [], 0
    for s, e in gaps:  # in time order, so an event that ended stays ended
        t = 0.5 * (s + e)
        while i < len(events) and events[i][0] <= t:
            heapq.heappush(heap, (-events[i][0], events[i][1], events[i][2]))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "host outside any op")
    return gaps, names
