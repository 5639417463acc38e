"""The long-row modes of the port's kernels against their plain versions,
on a card.

K1, K2, K3 and K5 keep a row in shared memory up to 58048 voxels and K6
up to 29024 (``MAX_AXIS``, ``GRAD_MAX_AXIS``); longer rows take each
kernel's long-row mode, which reads the row from device memory. On the CPU
the port runs the plain versions, which have no ceiling, so a fault of the
long-row modes shows only on a card: here and in the ``long`` phase of
``chip_smoke.py``. Every test is marked ``cuda`` and skips without one:

    EDT_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_torch_long_rows.py -q

Each mode is held against its plain version one length past its ceiling
(K1 and K2 bit-exact; K3, K5 and K6 within the tolerances of
``tests/test_torch_cuda.py``), and, forced on a shorter row through the
wrappers' private ``_long_rows``, against the shared-memory mode (K1, K2
and K3 bit-exact: the same sums in the same order; K5 within tolerance:
its warp mode walks in pairs of steps; K6's df within tolerance, its e
bit-exact: its row-split mode sums df tile by tile, then the halos).
K3's and K6's long-row modes split a row over many warps and send the
rows they cannot take (K3: links that do not ascend; K6: pairs past a
tile's halo) to a one-warp mode in a second launch; the marks they leave
(``last_one_warp_rows``) are checked too.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import argmin, compose, core, grad, minplus, softmin
from edt_tpu_torch.ops import voxel_graph as vg

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(x):
    return x.contiguous().view(torch.int32)


def _descends(targets):
    """(R,) int32: 1 where a row's live targets (>= 0) ever descend."""
    prev = torch.nn.functional.pad(targets, (1, 0), value=-1)[:, :-1]
    before = torch.cummax(prev, dim=1).values
    return ((targets >= 0) & (targets < before)).any(dim=1).to(torch.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def assert_exact(got, ref):
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[fin], ref[fin])


def _label_rows(rng, rows, n, run=64):
    """Random heights over runs of labels 0..3, zero at background."""
    lab = np.repeat(rng.integers(0, 4, size=(rows, n // run + 1)), run,
                    axis=1)[:, :n].astype(np.int32)
    f = (rng.random((rows, n)) * 900).astype(np.float32)
    return np.where(lab == 0, np.float32(0), f), lab


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 4097, minplus.MAX_AXIS + 1])
def test_minplus_long_rows(cuda, n):
    """K1's long-row mode: bit-exact to the plain version past the ceiling
    and to the shared-memory mode below it, multi-label and binary, with
    and without black_border."""
    f, lab = _label_rows(np.random.default_rng(n), 4, n)
    for binary in (False, True):
        lb = (lab != 0).astype(np.int32) if binary else lab
        ft = torch.from_numpy(np.where(lb == 0, 0, f).astype(np.float32)).to(cuda)
        ss, se = core.segment_bounds(torch.from_numpy(lb).to(cuda))
        for bb in (False, True):
            got = minplus.minplus_walls(ft, ss, se, 36.0, bb, not binary,
                                        _long_rows=True)
            if n > minplus.MAX_AXIS:
                ref = minplus.minplus_walls_plain(ft, ss, se, 36.0, bb,
                                                  not binary)
            else:
                ref = minplus.minplus_walls(ft, ss, se, 36.0, bb, not binary)
            assert_exact(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, argmin.MAX_AXIS + 1])
def test_argmin_and_grad_long_rows(cuda, n):
    """K2's long-row mode bit-exact (values and int32 link offsets) and
    K3's within rtol=1e-5 of the plain versions past the ceiling; both
    bit-exact to the shared-memory modes below it."""
    rng = np.random.default_rng(n)
    f, lab = _label_rows(rng, 4, n)
    lt = torch.from_numpy(lab).to(cuda)
    cnt = soft._wall_counts(lt, 1, True).contiguous()
    ft = torch.from_numpy(f).to(cuda)
    g = torch.from_numpy(rng.uniform(-1, 1, (4, n)).astype(np.float32)).to(cuda)
    d, o = argmin.minplus_argmin(ft, 36.0, cnt, emit_offsets=True,
                                 _long_rows=True)
    assert o.dtype == argmin.link_dtype(n)
    sent = torch.iinfo(o.dtype).min
    df = grad.minplus_grad(g, offsets=o, off_sent=sent, _long_rows=True)
    if n > argmin.MAX_AXIS:
        assert o.dtype == torch.int32
        rd, ro = argmin.minplus_argmin_plain(ft, 36.0, cnt, emit_offsets=True)
        assert_exact(d, rd)
        assert torch.equal(o, ro)
        rdf = grad.minplus_grad_plain(g, offsets=o, off_sent=sent)
        torch.testing.assert_close(df, rdf, rtol=1e-5, atol=1e-5)
    else:
        rd, ro = argmin.minplus_argmin(ft, 36.0, cnt, emit_offsets=True)
        assert_exact(d, rd)
        assert torch.equal(o, ro)
        rdf = grad.minplus_grad(g, offsets=o, off_sent=sent, _long_rows=False)
        assert torch.equal(df.view(torch.int32), rdf.view(torch.int32))


def _soft_rows(rng, rows, n):
    f = (rng.random((rows, n)) * 900).astype(np.float32)
    f[rng.random((rows, n)) < 0.3] = 0.0
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2049, softmin.MAX_AXIS + 1])
def test_softmin_long_rows(cuda, n):
    """K5's long-row mode within rtol=1e-5, atol=1e-4 of the plain version
    past its ceiling and of the shared-memory mode below it."""
    ft = torch.from_numpy(_soft_rows(np.random.default_rng(n), 4, n)).to(cuda)
    d = softmin.softmin(ft, 36.0, 0.3, _long_rows=True)
    ref = (softmin.softmin_plain(ft, 36.0, 0.3) if n > softmin.MAX_AXIS
           else softmin.softmin(ft, 36.0, 0.3))
    torch.testing.assert_close(d, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, softmin.GRAD_MAX_AXIS,
                               softmin.GRAD_MAX_AXIS + 1])
def test_softmin_grad_long_rows(cuda, n):
    """K6's long-row mode: df within rtol=1e-4, atol=1e-4 max|df| and
    sum(g * e) within rtol=1e-3 of the plain version past its ceiling; at
    and below it, df within the same tolerance of the shared-memory mode
    (the row-split mode sums df in another order) and e bit-exact."""
    rng = np.random.default_rng(n)
    ft = torch.from_numpy(_soft_rows(rng, 4, n)).to(cuda)
    d = softmin.softmin(ft, 36.0, 0.3)
    g = torch.from_numpy(rng.uniform(-1, 1, (4, n)).astype(np.float32)).to(cuda)
    df, e = softmin.softmin_grad(ft, d, g, 36.0, 0.3, _long_rows=True)
    if n > softmin.GRAD_MAX_AXIS:
        rdf, re = softmin.softmin_grad_plain(ft, d, g, 36.0, 0.3)
        torch.testing.assert_close(df, rdf, rtol=1e-4,
                                   atol=1e-4 * float(rdf.abs().max()))
        torch.testing.assert_close((g * e).sum(), (g * re).sum(), rtol=1e-3,
                                   atol=0.0)
    else:
        rdf, re = softmin.softmin_grad(ft, d, g, 36.0, 0.3)
        torch.testing.assert_close(df, rdf, rtol=1e-4,
                                   atol=1e-4 * float(rdf.abs().max()))
        assert torch.equal(e.view(torch.int32), re.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 256])
def test_grad_row_split_past_the_ceiling(cuda, rows):
    """K3's long-row mode one past its ceiling on K2's links of label
    rows: within rtol=1e-5 of the plain version (``scatter_add_`` on the
    card sums in another order), exactly the rows whose links descend
    marked, one row-split and one one-warp launch, and two calls the same
    bits."""
    n = grad.MAX_AXIS + 1
    rng = np.random.default_rng(rows)
    f, lab = _label_rows(rng, rows, n)
    cnt = soft._wall_counts(torch.from_numpy(lab).to(cuda), 1, True).contiguous()
    _, o = argmin.minplus_argmin(torch.from_numpy(f).to(cuda), 36.0, cnt,
                                 emit_offsets=True)
    sent = torch.iinfo(o.dtype).min
    g = torch.from_numpy(rng.uniform(-1, 1, (rows, n)).astype(np.float32)).to(cuda)
    before = (grad.minplus_grad_split_launches, grad.minplus_grad_long_launches)
    df = grad.minplus_grad(g, offsets=o, off_sent=sent)
    assert (grad.minplus_grad_split_launches,
            grad.minplus_grad_long_launches) == (before[0] + 1, before[1] + 1)
    cs = _chip_smoke()
    assert torch.equal(grad.last_one_warp_rows, _descends(cs.k3_targets(o, sent)))
    rdf = grad.minplus_grad_plain(g, offsets=o, off_sent=sent)
    torch.testing.assert_close(df, rdf, rtol=1e-5, atol=1e-5)
    assert torch.equal(_bits(df), _bits(grad.minplus_grad(g, offsets=o,
                                                          off_sent=sent)))


@pytest.mark.cuda
@pytest.mark.parametrize("rows, n", [(16, grad.SPLIT_MIN_AXIS - 1),
                                     (16, grad.SPLIT_MIN_AXIS),
                                     (4096, grad.SPLIT_MIN_AXIS)])
def test_grad_takes_the_row_split_mode_from_split_min_axis(cuda, rows, n):
    """Below its ceiling K3 takes the row-split mode from SPLIT_MIN_AXIS
    up, on its own and on many rows too: the same bits as the
    shared-memory mode."""
    rng = np.random.default_rng(n)
    f, lab = _label_rows(rng, rows, n)
    cnt = soft._wall_counts(torch.from_numpy(lab).to(cuda), 1, True).contiguous()
    _, o = argmin.minplus_argmin(torch.from_numpy(f).to(cuda), 36.0, cnt,
                                 emit_offsets=True)
    sent = torch.iinfo(o.dtype).min
    g = torch.from_numpy(rng.uniform(-1, 1, (rows, n)).astype(np.float32)).to(cuda)
    before = grad.minplus_grad_split_launches
    df = grad.minplus_grad(g, offsets=o, off_sent=sent)
    assert grad.minplus_grad_split_launches == before + (n >= grad.SPLIT_MIN_AXIS)
    ref = grad.minplus_grad(g, offsets=o, off_sent=sent, _long_rows=False)
    assert torch.equal(_bits(df), _bits(ref))


@pytest.mark.cuda
def test_grad_row_split_bit_equal_to_shared_memory_mode(cuda):
    """At K3's ceiling, 58048: the row-split mode forced with
    ``_long_rows`` bit-equal to the shared-memory mode, on rows of K2's
    links and on ``chip_smoke.k3_split_rows`` (runs across tile ends, a
    run longer than a tile, inert sources at tile ends, links that leave
    the row, and two rows whose links descend, which go to the one-warp
    mode), and to the host twin ``chip_smoke.k3_split``; the marks as
    expected; two calls the same bits."""
    n = grad.MAX_AXIS
    cs = _chip_smoke()
    rng = np.random.default_rng(3)
    f, lab = _label_rows(rng, 4, n)
    cnt = soft._wall_counts(torch.from_numpy(lab).to(cuda), 1, True).contiguous()
    _, o2 = argmin.minplus_argmin(torch.from_numpy(f).to(cuda), 36.0, cnt,
                                  emit_offsets=True)
    assert o2.dtype == torch.int32
    g, o, sent, marks = cs.k3_split_rows(rng, n)
    assert sent == torch.iinfo(torch.int32).min
    o = torch.cat([o2, torch.from_numpy(o).to(cuda)])
    g = torch.cat([torch.from_numpy(rng.uniform(-1, 1, (4, n)).astype(np.float32)),
                   torch.from_numpy(g)]).to(cuda)
    targets = cs.k3_targets(o, sent)
    want = torch.cat([_descends(targets[:4]).cpu(), torch.from_numpy(marks)])
    df = grad.minplus_grad(g, offsets=o, off_sent=sent, _long_rows=True)
    assert torch.equal(grad.last_one_warp_rows.cpu(), want)
    ref = grad.minplus_grad(g, offsets=o, off_sent=sent, _long_rows=False)
    assert torch.equal(_bits(df), _bits(ref))
    twin, twin_marks = cs.k3_split(g, targets)
    assert torch.equal(twin_marks, want)
    assert torch.equal(_bits(df.cpu()), _bits(twin))
    assert torch.equal(_bits(df), _bits(grad.minplus_grad(
        g, offsets=o, off_sent=sent, _long_rows=True)))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 256])
def test_softmin_grad_row_split_past_the_ceiling(cuda, rows):
    """K6's long-row mode one past its ceiling, 8 and 256 rows: df within
    rtol=1e-4, atol=1e-4 max|df|, e within rtol=1e-4, sum(g * e) within
    rtol=1e-3 of the plain version; row 1 has one source, so its pairs
    reach past every tile's halo: it alone is marked and takes the one-warp
    mode; two calls the same bits."""
    n = softmin.GRAD_MAX_AXIS + 1
    rng = np.random.default_rng(rows)
    f = _soft_rows(rng, rows, n)
    f[1] = np.inf
    f[1, 40] = 0.0
    ft = torch.from_numpy(f).to(cuda)
    d = softmin.softmin(ft, 36.0, 0.3)
    g = torch.from_numpy(rng.uniform(-1, 1, (rows, n)).astype(np.float32)).to(cuda)
    df, e = softmin.softmin_grad(ft, d, g, 36.0, 0.3)
    want = torch.zeros(rows, dtype=torch.int32)
    want[1] = 1
    assert torch.equal(softmin.last_one_warp_rows.cpu(), want)
    rdf, re = softmin.softmin_grad_plain(ft, d, g, 36.0, 0.3)
    torch.testing.assert_close(df, rdf, rtol=1e-4,
                               atol=1e-4 * float(rdf.abs().max()))
    torch.testing.assert_close(e, re, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close((g * e).sum(), (g * re).sum(), rtol=1e-3,
                               atol=0.0)
    df2, e2 = softmin.softmin_grad(ft, d, g, 36.0, 0.3)
    assert torch.equal(_bits(df), _bits(df2)) and torch.equal(_bits(e), _bits(e2))


@pytest.mark.cuda
def test_voxel_graph_past_29024(cuda):
    """A volume whose doubled first axis (58200) is past K1's shared-memory
    ceiling: bit-exact to the volume doubled on the host and run through
    the plain parabolic pass on the card, subsampled."""
    rng = np.random.default_rng(12)
    data = (rng.random((29100, 2, 2)) < 0.9).astype(np.uint8)
    graph = np.full(data.shape, 0b111111, np.uint8)
    graph[rng.random(data.shape) < 0.1] &= np.uint8(0b111110)
    out = torch.as_tensor(
        vg.edtsq_voxel_graph(data, graph, (1.0, 1.0, 1.0), True, "C", cuda))
    D = torch.from_numpy(vg._doubled_3d(data, graph, True)).to(cuda)
    plain = minplus.make_parabolic_fn(minplus.minplus_walls_plain)
    ref = compose.edtsq(D, [0.5, 0.5, 0.5], True, binary=True,
                        parabolic_fn=plain)[::2, ::2, ::2]
    assert_exact(out, ref.cpu())


@pytest.mark.cuda
def test_multilabel_edtsq_long_axis(cuda):
    """multilabel_edtsq forward and gradient with one axis past 58048
    through the kernels (K2 and K3 in their long-row modes) against the
    same call with kernels=PLAIN: forward bit-exact, gradient within
    rtol=1e-5."""
    rng = np.random.default_rng(13)
    n = argmin.MAX_AXIS + 1
    lab = np.repeat(rng.integers(0, 4, size=(2, 2, n // 64 + 1)), 64,
                    axis=2)[:, :, :n].astype(np.int32)
    lt = torch.from_numpy(lab).to(cuda)
    outs = []
    for kernels in (soft.KERNELS, soft.PLAIN):
        occ = (lt != 0).float().requires_grad_()
        out = soft.multilabel_edtsq(lt, occ, (6.0, 6.0, 30.0), True,
                                    binary_occupancy=True, kernels=kernels)
        (g,) = torch.autograd.grad(out.sum(), occ)
        outs.append((out.detach(), g))
    (out, g), (rout, rg) = outs
    assert_exact(out, rout)
    torch.testing.assert_close(g, rg, rtol=1e-5, atol=1e-5)
