"""K1's floors on the CPU (``edt_tpu_torch/csrc/minplus.cu``).

``chip_smoke.k1_search`` emulates the kernel's search step for step: its
default, ``floor="row"``, is what K1 runs (the segment's min f on masked
rows up to 512, the row's elsewhere). ``floor="chunk"`` emulates a search
under 32-voxel chunk floors that the kernel does not run (a warp of flat
heights takes them, any other warp the row floor), to count what it
would visit. Here both are held bit-exact to the plain version and to
the JAX package's ``parabolic_pass_sq`` on rows that stress the floors,
for w in {0.7, 1, 6, 30}, both borders, binary and masked; on binary
rows the chunk floors visit no more candidates than the row floor, and
at least 4x fewer where the background lies far from flat heights: the
voxel graph's zero tail (one background voxel at the row's end) and a
ball's mask rows (INF inside, 0 outside). On the rows of a ball's own K1
pass, where f falls toward the edge, its warps keep the row floor.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edt_tpu import api as japi
from edt_tpu.ops import core as jcore
from edt_tpu_torch import api
from edt_tpu_torch.ops import core, minplus

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WS = (0.7, 1.0, 6.0, 30.0)
N = 640  # groups of two warps; one shape keeps the JAX side quick
KINDS = ("zero-tail", "ball-mask", "ball-pass", "chunk-edges", "labels")
FAR = ("zero-tail", "ball-mask")  # where the chunk floors visit 4x fewer


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _rows(kind, w2):
    """(f, labels) of 2 rows of N: foreground label 1 (or labels 1..3),
    background 0, f zeroed at background as a pass receives it."""
    rng = np.random.default_rng(5)
    lab = np.ones((2, N), np.int32)
    i = np.arange(N)
    if kind == "zero-tail":  # flat heights that reach 90 and 290 voxels
        reach = np.array([90.0, 290.0])
        f = np.repeat((w2 * reach * reach)[:, None], N, axis=1)
        lab[:, -1] = 0
    elif kind == "ball-mask":  # rows of a disc of radius 300, as a mask
        y = np.array([320, 200])[:, None]
        lab = ((i[None] - 320) ** 2 + (y - 320) ** 2 < 300 ** 2).astype(np.int32)
        f = np.full((2, N), np.inf)
    elif kind == "ball-pass":  # rows of a ball's first K1 pass
        x = np.array([0, 150])[:, None]
        half = np.sqrt(np.maximum(0, 300.0 ** 2 - (i - 320.0) ** 2))
        d = np.maximum(0.0, half[None] - x)
        f = w2 * d * d
        lab = (d > 0).astype(np.int32)
    elif kind == "chunk-edges":  # background exactly at chunk boundaries
        f = rng.random((2, N)) * 900 * w2
        lab[0, 31::64] = 0
        lab[1, 32::64] = 0
        lab[:, 63::128] = 0
    else:  # "labels": runs of labels 0..3 and one long segment
        lab = np.repeat(rng.integers(0, 4, size=(2, N // 37 + 1)), 37,
                        axis=1)[:, :N].astype(np.int32)
        lab[1, 100:] = 2
        f = rng.random((2, N)) * 200 + (i % 37) ** 2
    return np.where(lab == 0, 0, f).astype(np.float32), lab


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("w", WS)
def test_chunk_floors_exact_and_fewer(w, binary):
    """Every kind of row, both borders: the chunk floors' search bit-exact
    to the plain version, to the row floor's and to the JAX package; no
    more candidates than the row floor on any kind, 4x fewer on FAR."""
    w2 = core.f32(core.f32(w) ** 2)
    f, lab = (np.concatenate(x) for x in zip(*(_rows(k, w2) for k in KINDS)))
    if binary:
        lab = (lab != 0).astype(np.int32)
    ft = torch.from_numpy(f)
    ss, se = core.segment_bounds(torch.from_numpy(lab))
    for bb in (False, True):
        new = CS.k1_search(ft, ss, se, w2, bb, not binary, floor="chunk",
                           by_row=True)
        old = CS.k1_search(ft, ss, se, w2, bb, not binary, by_row=True)
        ref = minplus.minplus_walls_plain(ft, ss, se, w2, bb, not binary)
        assert torch.equal(new[0], ref) and torch.equal(old[0], ref)
        # eager: XLA's jit may fuse f + w2 k^2 into one rounding
        jref = np.asarray(jcore.parabolic_pass_sq(
            jnp.asarray(f), jnp.asarray(lab), jnp.float32(w), bb,
            binary=binary))
        got = new[0].numpy()
        fin = np.isfinite(jref)
        assert np.array_equal(np.isfinite(got), fin)
        assert np.array_equal(got[fin], jref[fin])
        for x, kind in enumerate(KINDS):
            a = int(new[1][2 * x:2 * x + 2].sum())
            b = int(old[1][2 * x:2 * x + 2].sum())
            if binary:
                assert a <= b, (kind, a, b)
                if kind in FAR:
                    assert 4 * a <= b, (kind, a, b)
            else:  # masked rows keep the segment or row floor
                assert a == b, (kind, a, b)


def test_table_axis_and_device_ceiling():
    """The shared-memory ceiling and the API's device limit stay 58048,
    and the card's stress rows of the floors (``k1_floor_rows``) take
    every mode's edge: one warp, groups of warps, parked targets, the
    ceiling and the long-row mode."""
    assert minplus.MAX_AXIS == 58048
    assert api._DEVICE_MAX_AXIS_CUDA == 58048
    assert japi is not None
    lengths = {f.shape[1] for _, f, _, _ in
               CS.k1_floor_rows(np.random.default_rng(0))}
    m = minplus.MAX_AXIS
    assert {33, 511, 512, 513, 4096, 4097, m, m + 1} <= lengths


def test_floors_table_is_a_floor():
    """The chunk floors of binary rows: cmin each chunk's min f, pre (suf)
    below every f from the row's start to the chunk's end (from the
    chunk's start to the row's end)."""
    f = torch.from_numpy(_rows("chunk-edges", 1.0)[0])
    cmin, pre, suf = CS.k1_chunk_floors(f)
    for c in range(cmin.shape[1]):
        assert torch.equal(cmin[:, c], f[:, 32 * c:32 * c + 32].amin(dim=1))
        assert bool((pre[:, c] <= f[:, :32 * c + 32].amin(dim=1)).all())
        assert bool((suf[:, c] <= f[:, 32 * c:].amin(dim=1)).all())
