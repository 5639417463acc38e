"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA card (a CUDA
kernel has no CPU mode). The file imports no JAX, so it also runs on a
machine without it:

    EDT_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from edt_tpu_torch.ops import core, minplus


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    return torch.device("cuda")


def _rows(kind, rng):
    if kind == "random":
        labels = rng.integers(0, 3, size=(13, 200)).astype(np.int32)
        f = rng.random((13, 200)).astype(np.float32) * 25
    elif kind == "long-run":  # large radii beside small ones
        labels = rng.integers(0, 3, size=(10, 300)).astype(np.int32)
        f = rng.random((10, 300)).astype(np.float32) * 25
        f[:5, 100:260] = 500.0
        labels[:5, 100:260] = 1
    else:  # all-INF rows beside finite ones
        f = rng.random((8, 50)).astype(np.float32) * 50
        f[::2] = np.inf
        labels = np.ones((8, 50), np.int32)
    return f, labels


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "long-run", "inf-rows"])
def test_minplus_kernel_matches_plain(cuda, kind):
    f, labels = _rows(kind, np.random.default_rng(0))
    for binary in (False, True):
        lb = (labels != 0).astype(np.int32) if binary else labels
        ft = torch.from_numpy(np.where(lb == 0, 0, f).astype(np.float32)).to(cuda)
        ss, se = core.segment_bounds(torch.from_numpy(lb).to(cuda))
        for bb in (False, True):
            for w2 in (1.69, 36.0, 900.0):
                before = minplus.launches
                got = minplus.minplus_walls(ft, ss, se, w2, bb, not binary)
                assert minplus.launches == before + 1
                ref = minplus.minplus_walls_plain(ft, ss, se, w2, bb,
                                                  not binary)
                fin = torch.isfinite(ref)
                assert torch.equal(torch.isfinite(got), fin)
                assert torch.equal(got[fin], ref[fin])


@pytest.mark.cuda
def test_minplus_wrapper_rejects_bad_inputs(cuda):
    f = torch.zeros(4, 8, device=cuda)
    seg = torch.zeros(4, 8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="ss"):
        minplus.minplus_walls(f, seg, seg, 1.0, False, True)
    with pytest.raises(ValueError, match="contiguous"):
        minplus.minplus_walls(f.t().contiguous().t(), None, None, 1.0, False,
                              False)
