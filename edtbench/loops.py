"""The one traffic generator: a closed loop of calls into the program, as
the traffic mix's parameters (``edtbench/traffic/<name>.json``) describe it.

Every call first clears ``cleared_voxels`` foreground voxels of the
volume, at positions drawn from the seed, so that each call's answer
differs from the last and the work stays the same; the voxels are restored
after it. The loop kinds:

- ``fwd``: the device-native forward, ``torch_api.edtsq`` on the labels
  (``binary`` as the configuration says), which the caller waits for.
- ``loss``: ``models.soft.multilabel_edtsq`` of the labels and an f32
  occupancy (``labels != 0``, the cleared voxels 0), then
  ``torch.autograd.grad`` of its sum w.r.t. the occupancy: one training
  step's loss and gradient, waited for on the card. Over several cards
  each rank holds a slab of axis 0 (and clears voxels in it), and the
  program runs sharded (``axis_name``), every rank calling it.

The answers of ``checked_calls`` calls (the window's last, and the rest
drawn from the seed among its first ``checked_among_first``) are held on
the device and compared with the reference once the window has closed
(``check``).
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from edtbench import reference, volumes

POOL = 1 << 14  # distinct sets of cleared voxels; calls past it cycle
F32 = torch.float32


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the voxels, INF wherever one is finite and the
    other not, 0 where both are the same infinity."""
    same = got == want
    d = torch.where(same, 0.0, (got.to(F32) - want.to(F32)).abs())
    return float(torch.nan_to_num(d, nan=math.inf).max())


class Loop:
    """Inputs made from the seed, the timed call, the kept answers and their
    check."""

    def __init__(self, cell, seed, device, group=None):
        cfg, tr = cell.config, cell.traffic
        self.device, self.group = device, group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1
        self.shape = tuple(cfg["shape"])
        self.voxels = math.prod(self.shape)  # of the whole volume
        self.anisotropy = tuple(float(a) for a in cfg["anisotropy"])
        self.black_border = bool(cfg["black_border"])
        self.cfg, self.traffic = cfg, tr
        self.vol = volumes.make(cfg["volume"], self.shape, seed, device,
                                self.rank, self.world)
        n = int(tr["cleared_voxels"])  # a call, in each rank's slab
        pos = volumes.foreground_positions(self.vol, seed, POOL * n, self.rank)
        self.pos = torch.from_numpy(pos).reshape(POOL, n).to(device)
        self.plan = volumes.checked_calls(seed, int(tr["checked_calls"]),
                                          int(tr["checked_among_first"]))
        self.kept = {}  # call -> its answer, held on the device
        self.spans = None  # {name: [(start, end) CUDA events or host times]}

    # -- the window's side --------------------------------------------

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self):
        """A point on the device's timeline (host time off the card)."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop``, on every rank (one small broadcast a call)."""
        if self.group is None:
            return stop
        flag = torch.tensor([int(stop)], device=self.device)
        dist.broadcast(flag, dist.get_global_rank(self.group, 0), group=self.group)
        return bool(flag.item())

    def reduce(self, value: float, op) -> float:
        """``value`` reduced over the ranks (``dist.ReduceOp``)."""
        if self.group is None:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op, group=self.group)
        return float(t.item())

    def span(self, name, a, b):
        if self.spans is not None:
            self.spans.setdefault(name, []).append((a, b))

    def span_ms(self):
        """{name: [ms]} of the recorded spans (after a sync)."""
        out = {}
        for name, pairs in (self.spans or {}).items():
            out[name] = [a.elapsed_time(b) if hasattr(a, "elapsed_time")
                         else (b - a) * 1e3 for a, b in pairs]
        return out

    def keep(self, k, answer, last=False):
        """Hold call k's answer for the check if the plan checks it
        (``last``: the window's last call, the plan's -1). A held answer
        stays on the device: no copy runs in the window, and the peak
        counts it."""
        if last or k in self.plan:
            self.kept[k] = answer

    def call(self, k):
        """Clear call k's voxels, run the program's call and wait for it.
        Returns (answer, start, end) on the host clock."""
        raise NotImplementedError

    def restore(self, k):
        raise NotImplementedError

    # -- the check's side ---------------------------------------------

    def reference(self, k, dtype=F32):
        """The reference's answer to call k's input, in ``dtype``."""
        raise NotImplementedError

    def compare(self, got, want) -> dict:
        raise NotImplementedError

    def check(self, answer_of=None) -> list:
        """[(call, {number: value})] of every kept call, the program's answer
        (or ``answer_of(k)``'s, for a control) against the reference's."""
        out = []
        for k in sorted(self.kept):
            want = self.reference(k)
            got = self.kept[k] if answer_of is None else answer_of(k)
            out.append((k, self.compare(got, want)))
            del got, want
        return out


class Fwd(Loop):
    """Answers (out,)."""

    def __init__(self, cell, seed, device, group=None):
        if group is not None:
            raise ValueError("the fwd loop runs on one card")
        super().__init__(cell, seed, device)
        self.binary = bool(self.cfg.get("binary", False))
        self.orig = self.vol.reshape(-1)[self.pos]  # (POOL, n), to restore

    def _cleared(self, vol, k):
        vol.reshape(-1).index_fill_(0, self.pos[k % POOL], 0)

    def call(self, k):
        from edt_tpu_torch import torch_api

        self._cleared(self.vol, k)
        t0 = time.perf_counter()
        out = torch_api.edtsq(self.vol, self.anisotropy,
                              black_border=self.black_border,
                              binary=self.binary)
        self.sync()
        return (out,), t0, time.perf_counter()

    def restore(self, k):
        self.vol.reshape(-1).index_copy_(0, self.pos[k % POOL],
                                         self.orig[k % POOL])

    def reference(self, k, dtype=F32):
        lab = self.vol.clone()
        self._cleared(lab, k)
        return (reference.edtsq(lab, self.anisotropy, self.black_border,
                                self.binary, dtype=dtype).to(F32),)

    def compare(self, got, want):
        return {"out_max_abs_diff": gap(got[0], want[0])}


class Loss(Loop):
    """Answers (out, grad)."""

    def __init__(self, cell, seed, device, group=None):
        super().__init__(cell, seed, device, group)
        self.barrier = float(self.cfg["barrier"])
        self.binary_occupancy = bool(self.traffic["binary_occupancy"])
        self.occ = (self.vol != 0).to(F32).requires_grad_(True)

    def _occupancy(self, k, value):
        # in place on the leaf's storage, outside any graph
        self.occ.detach().reshape(-1).index_fill_(0, self.pos[k % POOL], value)

    def call(self, k):
        from edt_tpu_torch.models import soft

        self._occupancy(k, 0.0)
        t0 = time.perf_counter()
        a = self.mark() if self.spans is not None else None
        out = soft.multilabel_edtsq(self.vol, self.occ, self.anisotropy,
                                    black_border=self.black_border,
                                    barrier=self.barrier,
                                    axis_name=self.group,
                                    binary_occupancy=self.binary_occupancy)
        b = self.mark() if self.spans is not None else None
        (grad,) = torch.autograd.grad(out.sum(), self.occ)
        c = self.mark() if self.spans is not None else None
        self.sync()
        t1 = time.perf_counter()
        self.span("loss.fwd", a, b)
        self.span("loss.bwd", b, c)
        return (out.detach(), grad), t0, t1

    def restore(self, k):
        self._occupancy(k, 1.0)

    def reference(self, k, dtype=F32):
        occ = (self.vol != 0).to(F32)
        occ.reshape(-1).index_fill_(0, self.pos[k % POOL], 0.0)
        out, grad = reference.loss_forward_grad(
            self.vol, occ, self.anisotropy, self.black_border, self.barrier,
            dtype=dtype, group=self.group)
        return out.to(F32), grad.to(F32)

    def compare(self, got, want):
        scale = float(want[1].abs().max())
        return {"out_max_abs_diff": gap(got[0], want[0]),
                "grad_max_rel_diff": gap(got[1], want[1]) / max(scale, 1e-30)}


KINDS = {"fwd": Fwd, "loss": Loss}


def make(cell, seed, device, group=None) -> Loop:
    """The cell's loop; with ``group``, this rank's part of it (its slab of
    axis 0, the program called with ``axis_name=group``)."""
    return KINDS[cell.traffic["loop"]](cell, seed, device, group)
