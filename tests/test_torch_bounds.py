"""The segment-bounds and wall-count kernel (``ops/bounds.py``,
``csrc/bounds.cu``) against its plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA card (the
kernel has no CPU mode). The plain versions run on the same card tensors
(the torch ops the kernel replaced), and every output must equal theirs
bit for bit, dtype included. The file imports no JAX, so it also runs on
a machine without it:

    EDT_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_torch_bounds.py -q

The plain versions against the JAX package, on the CPU:
``tests/test_torch_bounds_plain.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from edt_tpu_torch import torch_api
from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import bounds, core

torch.set_num_threads(1)

# lengths about a warp, the cells' 511 / 512, the int16 / int32 switch of
# the wall counts (16000 / 16001), and past the other kernels' ceilings
LENGTHS = (1, 2, 31, 32, 33, 511, 512, 513, 1025, 16000, 16001, 65536)
DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
          torch.uint32, torch.int64, torch.float16, torch.bfloat16,
          torch.float32, torch.float64)
# the plain versions compare unsigned labels through their signed view
# (the same bits, so the same runs)
SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
          torch.uint64: torch.int64}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _plain_input(t):
    return t.view(SIGNED[t.dtype]) if t.dtype in SIGNED else t


def label_rows(rng, n, floating=False):
    """Rows of n labels (float64): random over few values, runs of random
    lengths, one run, alternating every voxel, and (``floating``) -0.0
    beside 0.0 and NaN beside NaN."""
    rows = [rng.integers(0, 3, n),
            np.repeat(rng.integers(0, 4, n), rng.integers(1, 80, n))[:n],
            np.full(n, 2), np.arange(n) % 2]
    if floating:
        rows.append(rng.choice(np.array([0.0, -0.0, np.nan, 1.0]), n))
    return np.stack(rows).astype(np.float64)


def block_volume(rng, shape, blk):
    """int64 labels in blocks of blk^3 voxels, a tenth of the voxels
    random."""
    grid = tuple(-(-s // blk) for s in shape)
    v = np.kron(rng.integers(0, 4, grid), np.ones((blk,) * 3, np.int64))
    v = v[tuple(slice(0, s) for s in shape)]
    noise = rng.random(shape) < 0.1
    v[noise] = rng.integers(0, 4, int(noise.sum()))
    return v


def _rows(rng, n, dtype):
    t = torch.from_numpy(label_rows(rng, n, dtype.is_floating_point))
    if dtype in SIGNED:
        return t.to(SIGNED[dtype]).view(dtype)
    return t.to(dtype)


def _volume(rng, shape, blk):
    return torch.from_numpy(block_volume(rng, shape, blk).astype(np.int32))


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_segment_bounds_bit_equal(cuda, dtype):
    """(start, end) from the kernel equal the plain version's on rows of
    every length about the kernel's warp and segment edges, in each
    label type."""
    rng = np.random.default_rng(1)
    for n in LENGTHS:
        lab = _rows(rng, n, dtype).to(cuda)
        got = bounds.segment_bounds(lab)
        want = bounds.segment_bounds_plain(_plain_input(lab))
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bool, torch.int32, torch.uint16,
                                   torch.uint64, torch.float32), ids=str)
def test_wall_counts_rows_bit_equal(cuda, dtype):
    """The wall counts along the last axis (a warp a row), both
    black_border values, int16 counts up to 16000 and int32 past it."""
    rng = np.random.default_rng(2)
    for n in LENGTHS:
        lab = _rows(rng, n, dtype).to(cuda)
        for bb in (False, True):
            _same(bounds.wall_counts(lab, 1, bb),
                  bounds.wall_counts_plain(_plain_input(lab), 1, bb))


@pytest.mark.cuda
@pytest.mark.parametrize("axis", (0, 1, 2, -1))
@pytest.mark.parametrize("black_border", (False, True))
def test_wall_counts_volume_bit_equal(cuda, axis, black_border):
    """``soft._wall_counts`` on 3-D volumes along each axis (axes 0 and 1
    strided: a thread a column), against the plain version; odd shapes,
    an axis past one segment and past 16000 voxels."""
    rng = np.random.default_rng(3)
    for shape, blk in (((37, 41, 43), 8), ((512, 24, 20), 32),
                       ((3, 16001, 5), 2), ((2, 5, 1), 1), ((5, 1, 7), 1)):
        lab = _volume(rng, shape, blk).to(cuda)
        _same(soft._wall_counts(lab, axis, black_border),
              bounds.wall_counts_plain(lab, axis, black_border))


@pytest.mark.cuda
def test_long_runs_across_segments(cuda):
    """Runs that span many of the kernel's segments (512 voxels a row,
    1024 a column), whose ends it reads ahead for, in both layouts."""
    n = 65536
    row = np.zeros(n, np.int32)
    for cut in (5, 512, 513, 1024, 1025, 3000, 40000, 65535):
        row[cut:] += 1
    rows = torch.from_numpy(np.stack([row, np.zeros(n, np.int32)])).to(cuda)
    for g, w in zip(bounds.segment_bounds(rows),
                    bounds.segment_bounds_plain(rows)):
        _same(g, w)
    cols = rows.t().contiguous().reshape(n, 2, 1).expand(n, 2, 3).contiguous()
    for bb in (False, True):
        _same(bounds.wall_counts(rows, 1, bb),
              bounds.wall_counts_plain(rows, 1, bb))
        _same(bounds.wall_counts(cols, 0, bb),
              bounds.wall_counts_plain(cols, 0, bb))


@pytest.mark.cuda
def test_zero_sizes_and_views(cuda):
    """Zero-size dimensions give empty outputs of the plain dtype; an axis
    of no voxel raises in the wall counts, as in the plain version; a
    non-contiguous view gives the plain version's values."""
    for shape in ((0, 5), (4, 0), (0, 0)):
        lab = torch.zeros(shape, dtype=torch.int32, device=cuda)
        for g, w in zip(bounds.segment_bounds(lab),
                        bounds.segment_bounds_plain(lab)):
            _same(g, w)
    lab = torch.zeros((3, 0, 4), dtype=torch.int32, device=cuda)
    for axis in (0, 2):
        _same(bounds.wall_counts(lab, axis, True),
              bounds.wall_counts_plain(lab, axis, True))
    with pytest.raises(ValueError):
        bounds.wall_counts(lab, 1, True)
    with pytest.raises(RuntimeError):
        bounds.wall_counts_plain(lab, 1, True)
    rng = np.random.default_rng(4)
    vol = _volume(rng, (20, 30, 40), 4).to(cuda)
    view = vol.transpose(0, 2)
    for g, w in zip(core.segment_bounds(view),
                    bounds.segment_bounds_plain(view)):
        assert torch.equal(g, w)
    assert torch.equal(soft._wall_counts(view, 1, False),
                       bounds.wall_counts_plain(view, 1, False))


@pytest.mark.cuda
def test_wrapper_rejects(cuda):
    """Types the kernel does not take raise, with no fallback; so does a
    0-d tensor and an axis out of range."""
    lab = torch.zeros((2, 8), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        bounds.segment_bounds(lab)
    with pytest.raises(ValueError, match="dtype"):
        bounds.wall_counts(lab, 1, True)
    with pytest.raises(ValueError):
        bounds.segment_bounds(torch.zeros((), device=cuda))
    with pytest.raises(ValueError, match="axis"):
        bounds.wall_counts(torch.zeros((2, 3), device=cuda), 2, True)


@pytest.mark.cuda
def test_main_path_launches(cuda):
    """The cells' calls take the kernel: a multi-label 3-D ``edtsq`` three
    launches (its first pass and two masked passes), a binary one one,
    ``multilabel_edtsq`` three (a wall count an axis), none on the CPU;
    the custom ops launch it too, and the transforms' values are the
    CPU's."""
    rng = np.random.default_rng(5)
    lab = _volume(rng, (24, 20, 28), 4)
    cases = (
        (lambda x: torch_api.edtsq(x, (6.0, 6.0, 30.0), True), lab, 3),
        (lambda x: torch_api.edtsq(x, (1.0, 1.0, 1.0), True, binary=True),
         (lab != 0), 1),
        (lambda x: soft.multilabel_edtsq(x, anisotropy=(6.0, 6.0, 30.0),
                                         black_border=True), lab, 3))
    for fn, x, want in cases:
        bounds.launches = 0
        ref = fn(x)
        assert bounds.launches == 0
        got = fn(x.to(cuda))
        assert bounds.launches == want
        assert torch.equal(got.cpu(), ref)
    bounds.launches = 0
    s, e = torch.ops.edt_tpu_torch.segment_bounds(lab.to(cuda))
    c = torch.ops.edt_tpu_torch.wall_counts(lab.to(cuda), 0, False)
    assert bounds.launches == 2
    assert torch.equal(s.cpu(), bounds.segment_bounds_plain(lab)[0])
    assert torch.equal(c.cpu(), bounds.wall_counts_plain(lab, 0, False))


@pytest.mark.cuda
def test_export_on_a_card_records_the_ops(cuda):
    """``export_fn`` on card tensors records each scan as one op node:
    three ``segment_bounds`` in a 3-D ``edtsq``, three ``wall_counts`` in
    ``multilabel_edtsq``; the loaded programs give the live values."""
    from edt_tpu_torch.ops import compose
    from edt_tpu_torch.utils import export

    lab = _volume(np.random.default_rng(6), (16, 12, 20), 4).to(cuda)
    for fn, op in ((lambda x: compose.edtsq(x, [6.0, 6.0, 30.0], True),
                    "segment_bounds"),
                   (lambda x: soft.multilabel_edtsq(x, anisotropy=(6.0, 6.0,
                                                                   30.0)),
                    "wall_counts")):
        program = export.export_fn(fn, lab)
        nodes = [str(n.target) for n in program.graph.nodes
                 if n.op == "call_function"]
        assert nodes.count(f"edt_tpu_torch.{op}.default") == 3
        assert torch.equal(export.load(program)(lab), fn(lab))


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a launch on a card that is not "
                    "the current one")
    return torch.device("cuda", 0), torch.device(
        "cuda", torch.cuda.device_count() - 1)


@pytest.mark.cuda
def test_launches_on_their_tensors_card(two_cards):
    """Both layouts on tensors on the last card, while card 0 is current,
    also under a non-default stream there, give what they give on card
    0, counted on the last card."""
    first, last = two_cards
    lab = _volume(np.random.default_rng(7), (30, 40, 50), 4)

    def run(dev):
        x = lab.to(dev)
        return [t.cpu() for t in (*bounds.segment_bounds(x),
                                  bounds.wall_counts(x, 0, True),
                                  bounds.wall_counts(x, 2, False))]

    torch.cuda.set_device(first)
    ref = run(first)
    for stream in (None, torch.cuda.Stream(last)):
        bounds.card_launches.clear()
        with torch.cuda.stream(stream) if stream else contextlib.nullcontext():
            torch.cuda.set_device(first)  # a stream's context makes its card current
            got = run(last)
        assert torch.cuda.current_device() == first.index
        assert bounds.card_launches == {last.index: 3}
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
