"""The program's own spans over a traced window, for the ``program_span``
readers: ``edt_tpu_torch.utils.profiling.spans()``, each record timed on
the card by a pair of CUDA events (on the host clock off the card).

The window's calls are the last ``rec.calls`` call ids of the registry
(a call id is shared by every span of one call into the program, its
backward included), so two runs in one process do not mix. Where the
program keeps no spans (a checkout without them), or the registry holds
fewer calls than the window, or the run was not traced, every reading is
None.
"""

from __future__ import annotations

TRANSPOSE = "edt_tpu_torch.transpose"
BOUNDS = "edt_tpu_torch.bounds"
FIRST_PASS = "edt_tpu_torch.first_pass"


def window(rec):
    """The records of the window's calls, or None."""
    if not rec.trace or rec.calls < 1:
        return None
    try:
        from edt_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    recs = spans(sync=True)
    calls = sorted({r["call"] for r in recs})
    if len(calls) < rec.calls:
        return None
    keep = set(calls[-rec.calls:])
    return [r for r in recs if r["call"] in keep]


def named(rec, name):
    """The window's records named ``name``, or None where there are none or
    one lacks its time."""
    recs = window(rec)
    if recs is None:
        return None
    out = [r for r in recs if r["name"] == name]
    if not out or any(r["ms"] is None for r in out):
        return None
    return out


def ms_a_call(rec, name):
    """Device ms a call inside the spans named ``name``."""
    out = named(rec, name)
    return sum(r["ms"] for r in out) / rec.calls if out is not None else None
