"""setup_s: process start to the first timed call, in s (host clock)."""


def read(rec):
    return rec.setup_s
