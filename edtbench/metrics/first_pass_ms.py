"""first_pass_ms, under any suffix (``.fwd``, ``.loss``): device ms a call
(a step in the loss cell) inside the program's ``edt_tpu_torch.first_pass``
spans: the closed form of the first pass, after its bounds."""

from edtbench import spans


def read(rec):
    return spans.ms_a_call(rec, spans.FIRST_PASS)
