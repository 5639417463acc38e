"""idle_share, under any suffix (``.loss``, ``.fwd``): the traced window
less the union of its device events (kernels, copies, fills), over the
window, in %."""


def read(rec):
    t = rec.trace
    if not t or not t.device_events:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
