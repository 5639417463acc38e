"""k2_roofline, under any suffix (``.loss``): K2's least time
(edtbench.roofline) over its device time, in %."""

from edtbench import roofline


def read(rec):
    return roofline.share(rec.trace, "K2") if rec.trace else None
