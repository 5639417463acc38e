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
wrappers' private ``_long_rows``, against the shared-memory mode (K1, K2,
K3 and K6 bit-exact: the same arithmetic in the same order; K5 within
tolerance: its warp mode walks in pairs of steps).
"""

import numpy as np
import pytest
import torch

from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import argmin, compose, core, grad, minplus, softmin
from edt_tpu_torch.ops import voxel_graph as vg

torch.set_num_threads(1)


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
        rdf = grad.minplus_grad(g, offsets=o, off_sent=sent)
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
@pytest.mark.parametrize("n", [300, softmin.GRAD_MAX_AXIS + 1])
def test_softmin_grad_long_rows(cuda, n):
    """K6's long-row mode: df within rtol=1e-4, atol=1e-4 max|df| and
    sum(g * e) within rtol=1e-3 of the plain version past its ceiling;
    bit-exact to the shared-memory mode below it."""
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
        assert torch.equal(df.view(torch.int32), rdf.view(torch.int32))
        assert torch.equal(e.view(torch.int32), re.view(torch.int32))


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
