"""Profiling and observability helpers (counterpart of
``edt_tpu.utils.profiling``): library counters, a ``torch.profiler`` trace
context, and the program's spans.

Spans name the stages of a call where the work happens: each 1-D pass, its
axis moves (``edt_tpu_torch.transpose``), segment bounds, the closed-form
first pass, each kernel. ``span`` is off, a shared no-op after one check of
a bool, unless a ``torch.profiler`` session runs (``trace`` or any other):
the profiler itself is the switch. On, a span is a ``record_function``
range on the profiler's timeline, timed on its tensor's device (a pair of
CUDA events on the current stream; the host clock off the card), and a
record in a bounded in-memory registry (``spans``): its name, id, parent's
id, the call id of its outermost span (a backward's spans carry the call
id of the forward that saved them), its attributes and its counters
(``bytes`` of a transpose: 2 x numel x itemsize of each copy made). Names
start with ``edt_tpu_torch.`` (never ``edt_tpu_torch::``, the custom ops'
namespace); axis, rows and mode go in the attributes.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time

import torch

_ap = torch.autograd.profiler

# the registry keeps the latest records
SPAN_LIMIT = 1 << 16

TRANSPOSE = "edt_tpu_torch.transpose"


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
    directory), the program's spans included. Open it in Perfetto or
    chrome://tracing."""
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


# ---------------- spans ----------------


class _Record:
    __slots__ = ("name", "id", "parent", "call", "attrs", "start", "end")


class _Off:
    """The span while no profiler runs: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def copied(self, src, out):
        pass


OFF = _Off()  # the span while off
_local = threading.local()
_ids = itertools.count(1)
_registry: collections.deque = collections.deque(maxlen=SPAN_LIMIT)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """An open span (profiler on): its record, its device, its range."""

    __slots__ = ("record", "_parent", "_device", "_range")

    def __init__(self, name, where, parent, attrs):
        rec = _Record()
        rec.name, rec.attrs, rec.start, rec.end = name, attrs, None, None
        self.record, self._parent = rec, parent
        dev = where.device if isinstance(where, torch.Tensor) else where
        self._device = torch.device(dev) if dev is not None else None

    def _mark(self):
        if self._device is None or self._device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def __enter__(self):
        rec, stack = self.record, _stack()
        parent = self._parent or (stack[-1] if stack else None)
        rec.id = next(_ids)
        rec.parent = parent.id if parent is not None else None
        rec.call = parent.call if parent is not None else rec.id
        args = ", ".join(f"{k}={v}" for k, v in rec.attrs.items())
        self._range = _ap.record_function(rec.name, args or None)
        self._range.__enter__()
        rec.start = self._mark()
        stack.append(rec)
        _registry.append(rec)
        return self

    def __exit__(self, *exc):
        self.record.end = self._mark()
        _stack().pop()
        self._range.__exit__(*exc)
        return False

    def copied(self, src, out):
        """Count ``out`` in ``bytes`` (read and written) if it is a copy of
        ``src``, not ``src`` itself or a view of it."""
        if out.numel() and out.data_ptr() != src.data_ptr():
            attrs = self.record.attrs
            attrs["bytes"] = (attrs.get("bytes", 0)
                              + 2 * out.numel() * out.element_size())


def span(name: str, where=None, parent=None, **attrs):
    """A context manager marking a stage of the program, named ``name``
    (an ``edt_tpu_torch.`` name), timed on ``where``'s device (a tensor or
    a device; the host clock without one), inside the innermost open span
    of this thread or under ``parent`` (a record from ``current``).

    While no ``torch.profiler`` session runs, and while torch compiles or
    exports, it is a shared no-op: one check of a bool, and no range, event,
    record or string made. ``attrs`` are plain values, formatted only when
    on."""
    if not _ap._is_profiler_enabled or torch.compiler.is_compiling():
        return OFF
    return _Span(name, where, parent, attrs)


def on() -> bool:
    """Whether spans record: a profiler runs, and torch neither compiles
    nor exports. A caller whose attributes cost more than plain values
    checks it first and returns ``OFF``."""
    return _ap._is_profiler_enabled and not torch.compiler.is_compiling()


def current():
    """The innermost open span's record on this thread, None while no
    profiler runs or no span is open: what an autograd function's forward
    keeps for its backward's ``parent``."""
    if not _ap._is_profiler_enabled:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def pass_span(x, axis, kind, mode_of=None):
    """The ``edt_tpu_torch.pass`` span of one 1-D pass along ``axis`` of x:
    its ``axis``, ``n`` (x.shape[axis]), ``rows`` and ``kind``, and
    ``mode_of(n)`` as its ``mode`` where given; formed only when on."""
    if not on():
        return OFF
    n = x.shape[axis]
    return _Span("edt_tpu_torch.pass", x, None, {
        "axis": axis, "n": n, "rows": x.numel() // max(n, 1), "kind": kind,
        "mode": mode_of(n) if mode_of is not None else None})


def contiguous(*views):
    """``v.contiguous()`` of each view, in one ``edt_tpu_torch.transpose``
    span whose ``bytes`` counts each copy made (0 where every view was
    contiguous already). Returns a list."""
    s = span(TRANSPOSE, views[0], bytes=0)
    if s is OFF:
        return [v.contiguous() for v in views]
    with s:
        out = [v.contiguous() for v in views]
        for v, o in zip(views, out):
            s.copied(v, o)
    return out


def spans(sync: bool = False) -> list[dict]:
    """The registry's closed spans, oldest first: dicts of ``name``, ``id``,
    ``parent``, ``call``, ``attrs`` and ``ms`` (None where the card has not
    reached the span's end yet). ``sync=True`` waits for every card
    first."""
    recs = [r for r in list(_registry) if r.end is not None]
    if sync and torch.cuda.is_available() and any(
            not isinstance(r.end, float) for r in recs):
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    out = []
    for r in recs:
        if isinstance(r.start, float):
            ms = (r.end - r.start) * 1e3
        else:
            ms = r.start.elapsed_time(r.end) if r.end.query() else None
        out.append({"name": r.name, "id": r.id, "parent": r.parent,
                    "call": r.call, "attrs": dict(r.attrs), "ms": ms})
    return out


def reset_spans():
    """Empty the registry."""
    _registry.clear()
