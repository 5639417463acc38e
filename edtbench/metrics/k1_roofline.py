"""k1_roofline: K1's least time (edtbench.roofline) over its device time, in %."""

from edtbench import roofline


def read(rec):
    return roofline.share(rec.trace, "K1") if rec.trace else None
