"""transpose_roofline, under any suffix (``.fwd``, ``.loss``): the bytes the
program's ``edt_tpu_torch.transpose`` spans count (each copy read and
written once) at ``edtbench.roofline.HBM_BYTES_PER_S``, over their device
time, in %."""

from edtbench import roofline, spans


def read(rec):
    out = spans.named(rec, spans.TRANSPOSE)
    if out is None:
        return None
    ms = sum(r["ms"] for r in out)
    nbytes = sum(r["attrs"].get("bytes", 0) for r in out)
    if ms <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / (ms * 1e-3)
