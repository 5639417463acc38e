"""The plain versions of the segment-bounds and wall-count kernel
(``ops/bounds.py``) against the JAX package on the CPU, bit-exact, and
the CPU path around them: CPU tensors keep the torch ops, launch no
kernel, and export as before.

``core.segment_bounds`` against ``edt_tpu.ops.core.segment_bounds`` and
``models.soft._wall_counts`` against ``edt_tpu.models.soft._wall_counts``
over the label dtypes, the row lengths about the kernel's warp and segment
edges and the int16 / int32 switch of the counts, and every axis of 3-D
volumes. The kernel itself against these plain versions, on a card:
``tests/test_torch_bounds.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bounds import block_volume, label_rows

from edt_tpu.models import soft as jsoft
from edt_tpu.ops import core as jcore
from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import bounds, compose, core
from edt_tpu_torch.utils import export, profiling

torch.set_num_threads(1)

LENGTHS = (1, 2, 31, 32, 33, 511, 512, 513)
DTYPES = {"bool": np.bool_, "uint8": np.uint8, "int16": np.int16,
          "int32": np.int32, "uint32": np.uint32, "int64": np.int64,
          "float32": np.float32}

_jbounds = jax.jit(jcore.segment_bounds)
_jwalls = jax.jit(jsoft._wall_counts, static_argnums=(1, 2))


def _rows(rng, n, dtype):
    return label_rows(rng, n, np.issubdtype(dtype, np.floating)).astype(dtype)


def _volume(rng, shape, blk, dtype=np.int32):
    return block_volume(rng, shape, blk).astype(dtype)


def _check_bounds(lab):
    start, end = core.segment_bounds(torch.from_numpy(lab))
    jstart, jend = _jbounds(jnp.asarray(lab))
    assert start.dtype == end.dtype == torch.int32
    assert np.array_equal(start.numpy(), np.asarray(jstart))
    assert np.array_equal(end.numpy(), np.asarray(jend))


def _check_walls(lab, axis, black_border):
    got = soft._wall_counts(torch.from_numpy(lab), axis, black_border)
    want = np.asarray(_jwalls(jnp.asarray(lab), axis, black_border))
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_segment_bounds_plain_matches_jax(dtype):
    """Rows of every length about a warp and the cells' 511 / 512, in
    each label dtype (floats with -0.0 and NaN), bit-exact to JAX."""
    rng = np.random.default_rng(11)
    for n in LENGTHS:
        _check_bounds(_rows(rng, n, DTYPES[dtype]))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("black_border", [False, True])
def test_wall_counts_plain_matches_jax(axis, black_border):
    """Every axis of 3-D volumes (odd shapes, an axis past one of the
    kernel's 1024-voxel segments), in bool, uint8, int32 and float32
    labels, both black_border values, bit-exact to JAX."""
    rng = np.random.default_rng(12)
    for dtype in (np.bool_, np.uint8, np.int32, np.float32):
        _check_walls(_volume(rng, (13, 17, 19), 4, dtype), axis,
                     black_border)
    _check_walls(_volume(rng, (1100, 3, 2), 32).transpose(
        [(0, 1, 2), (1, 0, 2), (1, 2, 0)][axis]).copy(), axis, black_border)


def test_long_rows_plain_match_jax():
    """16000 (the last int16 counts), 16001 (int32 counts) and 65536
    voxels a row: bounds and wall counts bit-exact to JAX."""
    rng = np.random.default_rng(13)
    for n in (16000, 16001, 65536):
        lab = _rows(rng, n, np.int32)
        _check_bounds(lab)
        for bb in (False, True):
            _check_walls(lab, 1, bb)


def test_zero_sizes_match_jax():
    """Zero-size dimensions beside the scanned axis give empty outputs of
    JAX's dtypes; an axis of no voxel raises in both wall counts."""
    for shape in ((0, 5), (4, 0)):
        _check_bounds(np.zeros(shape, np.int32))
    lab = np.zeros((3, 0, 4), np.int32)
    for axis in (0, 2):
        _check_walls(lab, axis, True)
    with pytest.raises(RuntimeError):
        soft._wall_counts(torch.from_numpy(lab), 1, True)
    with pytest.raises(Exception):
        jsoft._wall_counts(jnp.asarray(lab), 1, True)


def test_cpu_keeps_the_torch_ops():
    """On the CPU no kernel launches, the bounds span says ``plain``, and
    an exported ``edtsq`` holds no scan op node."""
    lab = torch.from_numpy(_volume(np.random.default_rng(14), (6, 7, 8), 2))
    bounds.launches = 0
    profiling.reset_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        compose.edtsq(lab, [1.0, 1.0, 2.0], True)
        soft._wall_counts(lab, 0, True)
    assert bounds.launches == 0
    impls = [s["attrs"]["impl"] for s in profiling.spans()
             if s["name"] == "edt_tpu_torch.bounds"]
    assert impls == ["plain"] * 4
    program = export.export_fn(
        lambda x: compose.edtsq(x, [1.0, 1.0, 2.0], True), lab)
    targets = {str(n.target) for n in program.graph.nodes}
    assert not any(t.startswith(("edt_tpu_torch.segment_bounds",
                                 "edt_tpu_torch.wall_counts"))
                   for t in targets)


@pytest.mark.parametrize("case", ["segment_bounds", "wall_counts int16",
                                  "wall_counts int32"])
def test_opcheck(case):
    """torch.library.opcheck of each op on CPU tensors (the plain
    versions): its schema, its fake implementation's shapes and dtypes
    against the real outputs, and its use under AOT dispatch."""
    rng = np.random.default_rng(15)
    args = {"segment_bounds": (torch.from_numpy(_rows(rng, 40, np.int32)),),
            "wall_counts int16": (torch.from_numpy(
                _volume(rng, (5, 6, 7), 2)), 1, False),
            "wall_counts int32": (torch.from_numpy(
                _rows(rng, 16001, np.int32)), 1, True)}[case]
    op = getattr(torch.ops.edt_tpu_torch, case.split()[0]).default
    torch.library.opcheck(op, args)


def test_wrappers_refuse_other_devices():
    """The kernel wrappers take CPU tensors to the plain versions, CUDA
    tensors to the kernel, and refuse any other device."""
    lab = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        bounds.segment_bounds(lab)
    with pytest.raises(ValueError, match="device"):
        bounds.wall_counts(lab, 1, True)
