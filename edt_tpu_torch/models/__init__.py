"""Differentiable distance transforms and the models trained on them
(counterpart of ``edt_tpu.models``).

- ``soft``: squared EDT of a continuous height field, at temperature 0
  with an O(voxels) argmin-residual backward (K2-K4) and at t > 0 as
  softmin passes (K5, K6); the wall-faithful multi-label form that
  ``bench.py`` times.
- ``distance_net``: DistanceFieldNet, a per-voxel MLP trained against a
  target distance field through ``soft.soft_edtsq`` (one device).
- ``unet3d``: UNet3D, a 3-D U-Net trained the same way (one device).
"""

from edt_tpu_torch.models import distance_net, unet3d
from edt_tpu_torch.models.soft import (
    edtsq_from_heights,
    multilabel_edtsq,
    soft_edtsq,
    soft_sdfsq,
    wall_counts_for,
)

__all__ = ["edtsq_from_heights", "soft_edtsq", "soft_sdfsq",
           "multilabel_edtsq", "wall_counts_for", "distance_net", "unet3d"]
