"""transpose_ms, under any suffix (``.fwd``, ``.loss``): device ms a call (a
step, forward and backward, in the loss cell) inside the program's
``edt_tpu_torch.transpose`` spans: every axis move that copies."""

from edtbench import spans


def read(rec):
    return spans.ms_a_call(rec, spans.TRANSPOSE)
