"""bounds_ms, under any suffix (``.fwd``, ``.loss``): device ms a call (a
step in the loss cell) inside the program's ``edt_tpu_torch.bounds`` spans:
the segment bounds of the forward's passes, the loss's wall counts."""

from edtbench import spans


def read(rec):
    return spans.ms_a_call(rec, spans.BOUNDS)
