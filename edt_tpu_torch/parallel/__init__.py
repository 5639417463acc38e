"""Multi-card execution over ``torch.distributed`` (counterpart of
``edt_tpu.parallel``)."""

from edt_tpu_torch.parallel.sharded import (
    default_mesh,
    edt_sharded,
    edtsq_sharded,
    edtsq_sharded_auto,
    edtsq_voxel_graph_sharded,
    sdf_sharded,
)

__all__ = [
    "default_mesh",
    "edtsq_sharded",
    "edtsq_sharded_auto",
    "edt_sharded",
    "sdf_sharded",
    "edtsq_voxel_graph_sharded",
]
