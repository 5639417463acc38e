"""fwd_voxels_per_s: the voxels of every completed forward call over the
whole window (host clock)."""


def read(rec):
    return rec.calls * rec.voxels / rec.window_s if rec.loop == "fwd" else None
