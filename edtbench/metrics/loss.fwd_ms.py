"""loss.fwd_ms: the mean over the window's steps of the forward call
(``multilabel_edtsq``), between the benchmark's CUDA events around it, in ms."""


def read(rec):
    ms = rec.trace.spans.get("loss.fwd") if rec.trace else None
    return sum(ms) / len(ms) if ms else None
