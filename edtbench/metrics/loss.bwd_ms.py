"""loss.bwd_ms: the mean over the window's steps of the sum and
``torch.autograd.grad`` of it w.r.t. the occupancy, between the benchmark's
CUDA events around them, in ms."""


def read(rec):
    ms = rec.trace.spans.get("loss.bwd") if rec.trace else None
    return sum(ms) / len(ms) if ms else None
