"""Differentiable distance transforms (counterpart of ``edt_tpu.models``).

- ``soft``: squared EDT of a continuous height field at temperature 0,
  with an O(voxels) argmin-residual backward, and the wall-faithful
  multi-label form that ``bench.py`` times.

The models built on them (``distance_net``, ``unet3d``) are not ported yet.
"""

from edt_tpu_torch.models.soft import (
    edtsq_from_heights,
    multilabel_edtsq,
    soft_edtsq,
    soft_sdfsq,
    wall_counts_for,
)

__all__ = ["edtsq_from_heights", "soft_edtsq", "soft_sdfsq",
           "multilabel_edtsq", "wall_counts_for"]
