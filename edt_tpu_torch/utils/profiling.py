"""Library counters (counterpart of ``edt_tpu.utils.profiling.Counters``)."""

from __future__ import annotations


class Counters:
    """Process-wide library counters (transforms run, voxels processed,
    dispatch decisions): plain Python ints bumped at the NumPy API layer.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.transforms = 0
        self.voxels = 0
        self.sharded_dispatches = 0
        self.host_fallbacks = 0
        self.voxel_graph_calls = 0

    def snapshot(self) -> dict:
        return {
            "transforms": self.transforms,
            "voxels": self.voxels,
            "sharded_dispatches": self.sharded_dispatches,
            "host_fallbacks": self.host_fallbacks,
            "voxel_graph_calls": self.voxel_graph_calls,
        }


counters = Counters()
