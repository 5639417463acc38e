"""edt_tpu_torch — the multi-label anisotropic Euclidean distance transform
on PyTorch and CUDA (NVIDIA H100), a port of ``edt_tpu``.

NumPy-facing API (drop-in for the reference package ``edt``):
  edt, edtsq, sdf, sdfsq, binary_edt, binary_edtsq,
  edt1d, edt1dsq, edt2d, edt2dsq, edt3d, edt3dsq,
  each, runs, draw, erase, transfer, reshape

Each transform runs on the CUDA device unless ``device=`` names another
(the tests pass ``device="cpu"``); the run-length kit (``each`` and the
rest) is host code. The device-native API on torch tensors is
``edt_tpu_torch.torch_api``; the differentiable transforms are in
``edt_tpu_torch.models``; checkpointing, export and profiling in
``edt_tpu_torch.utils``. The package imports torch and numpy, never jax.
"""

from edt_tpu_torch.api import (
    binary_edt,
    binary_edtsq,
    edt,
    edt1d,
    edt1dsq,
    edt2d,
    edt2dsq,
    edt3d,
    edt3dsq,
    edtsq,
    sdf,
    sdfsq,
)
from edt_tpu_torch.rle import draw, each, erase, reshape, runs, transfer

__version__ = "0.2.0"

__all__ = [
    "edt", "edtsq", "sdf", "sdfsq",
    "edt1d", "edt1dsq", "edt2d", "edt2dsq", "edt3d", "edt3dsq",
    "binary_edt", "binary_edtsq",
    "each", "runs", "draw", "erase", "transfer", "reshape",
    "__version__",
]
