"""glue_share, under any suffix (``.loss``, ``.fwd``): device time in
kernels that are not the program's K1-K6 or NCCL's (torch's own kernels:
the composition's transposes, scans, compares, ``where`` and fills) over
the device time of all kernels of the traced window, in %. Copies of
memory are in neither."""


def read(rec):
    t = rec.trace
    total = t.kernel_us(lambda fam: True) if t else 0.0
    return 100.0 * t.kernel_us(lambda fam: fam is None) / total if total > 0 else None
