"""Multi-card execution over ``torch.distributed`` (counterpart of
``edt_tpu.parallel``): the slab-sharded transforms (``sharded``) and the
(dp, sp) mesh of the trainers' sharded steps (``train``; the steps are
``models.distance_net.make_sharded_train_step`` and
``models.unet3d.make_sharded_train_step``)."""

from edt_tpu_torch.parallel.sharded import (
    default_mesh,
    edt_sharded,
    edtsq_sharded,
    edtsq_sharded_auto,
    edtsq_voxel_graph_sharded,
    sdf_sharded,
)
from edt_tpu_torch.parallel.train import batch_block

__all__ = [
    "default_mesh",
    "edtsq_sharded",
    "edtsq_sharded_auto",
    "edt_sharded",
    "sdf_sharded",
    "edtsq_voxel_graph_sharded",
    "batch_block",
]
