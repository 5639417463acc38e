"""loss_voxels_per_s: the voxels of every completed loss step (forward and
occupancy gradient, ready on the card) over the whole window (host clock)."""


def read(rec):
    return rec.calls * rec.voxels / rec.window_s if rec.loop == "loss" else None
