"""edt_tpu_torch — the multi-label anisotropic Euclidean distance transform
on PyTorch and CUDA (NVIDIA H100), a port of ``edt_tpu``.

NumPy-facing API (drop-in for the reference package ``edt``):
  edt, edtsq, sdf, sdfsq, binary_edt, binary_edtsq,
  edt1d, edt1dsq, edt2d, edt2dsq, edt3d, edt3dsq

Each runs on the CUDA device unless ``device=`` names another (the tests
pass ``device="cpu"``). The package imports torch and numpy, never jax.
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

__version__ = "0.2.0"

__all__ = [
    "edt", "edtsq", "sdf", "sdfsq",
    "edt1d", "edt1dsq", "edt2d", "edt2dsq", "edt3d", "edt3dsq",
    "binary_edt", "binary_edtsq",
    "__version__",
]
