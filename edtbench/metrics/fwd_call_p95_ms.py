"""fwd_call_p95_ms: the 95th percentile over every call of the window of one
forward call, from the call to the synchronize after it (host clock)."""

import statistics


def read(rec):
    if rec.loop != "fwd" or len(rec.latencies_s) < 2:
        return None
    return statistics.quantiles(rec.latencies_s, n=20, method="inclusive")[18] * 1e3
