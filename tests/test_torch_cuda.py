"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA card (a CUDA
kernel has no CPU mode). The file imports no JAX, so it also runs on a
machine without it:

    EDT_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import argmin, core, grad, minplus, softmin


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
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


def _argmin_rows(n, rng):
    """f, int16 wall counts (some open) and f32 walls over rows of n: a
    source-rich half, a barrier half with sparse sources, an all-INF row."""
    f = (rng.random((16, n)) * 50).astype(np.float32)
    f[rng.random((16, n)) > 0.6] = 0.0
    f[8:] = 2.7e5
    f[8:, ::70] = 0.0
    f[5] = np.inf
    cnt = rng.integers(1, 40, size=(16, n)).astype(np.int16)
    cnt[rng.random((16, n)) > 0.9] = 30000
    return f, cnt


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 300, 512])
def test_argmin_kernel_matches_plain(cuda, n):
    f, cnt = _argmin_rows(n, np.random.default_rng(n))
    ft = torch.from_numpy(f).to(cuda)
    ct = torch.from_numpy(cnt).to(cuda)
    for w2 in (1.69, 36.0, 900.0):
        wf = argmin.walls_from_counts(ct, w2)
        for walls in (None, wf, ct, ct.to(torch.int32)):
            for emit in (False, True):
                before = argmin.launches
                d, a = argmin.minplus_argmin(ft, w2, walls, emit)
                assert argmin.launches == before + 1
                rd, ra = argmin.minplus_argmin_plain(ft, w2, walls, emit)
                assert torch.equal(d, rd) and torch.equal(a, ra)


@pytest.mark.cuda
def test_grad_kernels_match_plain(cuda):
    rng = np.random.default_rng(1)
    f, cnt = _argmin_rows(300, rng)
    ft = torch.from_numpy(f).to(cuda)
    _, o = argmin.minplus_argmin_plain(ft, 36.0, torch.from_numpy(cnt).to(cuda),
                                       True)
    g = torch.from_numpy(rng.uniform(-1, 1, f.shape).astype(np.float32)).to(cuda)
    sent = torch.iinfo(o.dtype).min
    got = grad.minplus_grad(g, offsets=o, off_sent=sent)
    ref = grad.minplus_grad_plain(g, offsets=o, off_sent=sent)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    # the closed-form binary pass's residual: zero sites at the dtype max
    fb = torch.where(ft <= 0, 0.0, 5e4)
    _, argj = soft._minplus_hard_binary_with_arg(fb, 36.0)
    walls = argmin.walls_from_counts(torch.from_numpy(cnt).to(cuda), 36.0)
    d, _ = soft._minplus_hard_binary_with_arg(fb, 36.0)
    ob = soft._binary_offsets(fb, argj, d <= walls)
    got = grad.binary_grad_scan(g, ob, off_sent=sent)
    ref = grad.binary_grad_scan_plain(g, ob, off_sent=sent)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def _far_tie_rows(n, rng):
    """Rows whose costs tie at i - k and i + k far out (two equal sources
    about the middle), integer heights full of ties (w2 = 1), and heights
    near 3e7, where f32 rounding makes neighbouring costs non-monotone."""
    f = np.full((12, n), 1e6, np.float32)
    k = rng.integers(1, n // 3, size=4)
    f[np.arange(4), n // 2 - k] = 7.0
    f[np.arange(4), n // 2 + k] = 7.0
    f[4:8] = rng.integers(0, 400, size=(4, n))
    f[8:] = 3e7 + rng.random((4, n)) * 200
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("w2", [0.16, 1.0, 1.69])
def test_argmin_kernel_far_ties_and_small_w2(cuda, w2):
    """K2's outward search keeps the leftmost tie however far out, and its
    exact stop holds for w2 < 1: bit-exact to the plain version."""
    rng = np.random.default_rng(5)
    ft = torch.from_numpy(_far_tie_rows(301, rng)).to(cuda)
    cnt = torch.from_numpy(rng.integers(1, 40, size=(12, 301)).astype(np.int16))
    for walls in (None, cnt.to(cuda)):
        for emit in (False, True):
            d, a = argmin.minplus_argmin(ft, w2, walls, emit)
            rd, ra = argmin.minplus_argmin_plain(ft, w2, walls, emit)
            assert torch.equal(d, rd) and torch.equal(a, ra)


def _k3_links(kind, n, rng):
    """(R, n) int16 link offsets K2 never makes: random and non-monotone,
    every live link to one voxel, or links that leave the row; about a
    tenth inert."""
    i = np.arange(n)
    if kind == "non-monotone":
        o = rng.integers(-n, n, size=(16, n))
    elif kind == "one-target":
        o = rng.integers(0, n, size=(16, 1)) - i
    else:  # leaving the row on either side
        o = np.where(rng.random((16, n)) < 0.5, -i - 1, n - i)
    return np.where(rng.random((16, n)) < 0.1, -32768, o).astype(np.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["non-monotone", "one-target", "leaving"])
def test_grad_kernel_any_links(cuda, kind):
    """K3 scatters any links: within rtol=1e-6, atol=1e-6 of the plain
    version, the same bits from two launches."""
    rng = np.random.default_rng(6)
    for n in (1, 33, 300):
        o = torch.from_numpy(_k3_links(kind, n, rng)).to(cuda)
        g = torch.from_numpy(rng.uniform(-1, 1, (16, n)).astype(np.float32)).to(cuda)
        got = grad.minplus_grad(g, offsets=o, off_sent=-32768)
        ref = grad.minplus_grad_plain(g, offsets=o, off_sent=-32768)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
        assert torch.equal(got, grad.minplus_grad(g, offsets=o, off_sent=-32768))


@pytest.mark.cuda
def test_argmin_and_grad_ceilings(cuda):
    """Both kernels take rows up to 58048 and raise beyond: one source a
    row, d = w2 k^2 exactly; one link target, df = the row's sum (the
    cotangents are multiples of 1/16, so the sums are exact)."""
    n = argmin.MAX_AXIS
    f = torch.full((2, n), float("inf"), device=cuda)
    f[:, 5] = 0.0
    d, a = argmin.minplus_argmin(f, 1.69, None)
    k = (torch.arange(n, device=cuda) - 5).to(torch.float32)
    assert torch.equal(d, (1.69 * (k * k)).expand(2, n))
    assert bool((a == 5).all())
    g = torch.randint(-64, 64, (2, grad.MAX_AXIS), device=cuda) / 16.0
    o = (7 - torch.arange(grad.MAX_AXIS, device=cuda)).to(torch.int32).expand(2, -1)
    df = grad.minplus_grad(g, offsets=o.contiguous())
    assert torch.equal(df[:, 7], g.sum(dim=1)) and int((df != 0).sum()) <= 2
    with pytest.raises(ValueError, match="exceed"):
        argmin.minplus_argmin(torch.zeros((1, n + 1), device=cuda), 1.0)
    with pytest.raises(ValueError, match="exceed"):
        big = torch.zeros((1, grad.MAX_AXIS + 1), device=cuda)
        grad.minplus_grad(big, offsets=torch.zeros_like(big, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("binocc", [True, False])
def test_multilabel_edtsq_kernels_match_plain(cuda, binocc):
    rng = np.random.default_rng(2)
    labels = np.kron(rng.integers(0, 4, size=(4, 4, 4)),
                     np.ones((8, 8, 8), np.uint8)).astype(np.int32)
    lt = torch.from_numpy(labels).to(cuda)
    outs = []
    for kernels in (soft.KERNELS, soft.PLAIN):
        occ = (lt != 0).float().requires_grad_()
        out = soft.multilabel_edtsq(lt, occ, (6.0, 6.0, 30.0), True,
                                    binary_occupancy=binocc, kernels=kernels)
        (g,) = torch.autograd.grad(out.sum(), occ)
        outs.append((out.detach(), g))
    (out, g), (rout, rg) = outs
    assert torch.equal(out, rout)
    torch.testing.assert_close(g, rg, rtol=1e-6, atol=1e-6)


def _soft_rows(n, rng):
    """Random heights with sources, a plateau over sparse sources (radii
    of about 22 beside short ones), one all-INF row last."""
    f = (rng.random((12, n)) * 50).astype(np.float32)
    f[rng.random((12, n)) > 0.6] = 0.0
    if n >= 300:
        f[:4, 100:260] = 500.0
        f[:4, ::70] = 0.0
    f[-1] = np.inf
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 300, 2049])
def test_softmin_kernels_match_plain(cuda, n):
    """K5 and K6 within the JAX package's tolerances for its softmin
    kernels: forward rtol=1e-5, atol=1e-4; df rtol=1e-4, atol=1e-4
    max|df|; sum(g * e) rtol=1e-3."""
    rng = np.random.default_rng(n)
    ft = torch.from_numpy(_soft_rows(n, rng)).to(cuda)
    for w2, t in ((1.0, 0.3), (36.0, 1.0), (900.0, 0.01)):
        before = (softmin.launches, softmin.grad_launches)
        d = softmin.softmin(ft * w2, w2, t)
        rd = softmin.softmin_plain(ft * w2, w2, t)
        assert torch.equal(torch.isinf(d), torch.isinf(rd))
        fin = torch.isfinite(rd)
        torch.testing.assert_close(d[fin], rd[fin], rtol=1e-5, atol=1e-4)
        g = torch.from_numpy(rng.uniform(-1, 1, (11, n)).astype(np.float32)).to(cuda)
        f1, d1 = (ft * w2)[:-1].contiguous(), rd[:-1].contiguous()
        df, e = softmin.softmin_grad(f1, d1, g, w2, t)
        rdf, re = softmin.softmin_grad_plain(f1, d1, g, w2, t)
        assert (softmin.launches, softmin.grad_launches) == (before[0] + 1,
                                                            before[1] + 1)
        torch.testing.assert_close(df, rdf, rtol=1e-4,
                                   atol=1e-4 * float(rdf.abs().max()))
        torch.testing.assert_close((g * e).sum(), (g * re).sum(), rtol=1e-3,
                                   atol=0.0)


@pytest.mark.cuda
def test_softmin_wrappers_reject_bad_inputs(cuda):
    f = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="temperature"):
        softmin.softmin(f, 1.0, 0.0)
    with pytest.raises(ValueError, match="exceed"):
        softmin.softmin(torch.zeros(1, softmin.MAX_AXIS + 1, device=cuda),
                        1.0, 0.3)
    big = torch.zeros(1, softmin.GRAD_MAX_AXIS + 1, device=cuda)
    with pytest.raises(ValueError, match="exceed"):
        softmin.softmin_grad(big, big, big, 1.0, 0.3)
    with pytest.raises(ValueError, match="g:"):
        softmin.softmin_grad(f, f, f.double(), 1.0, 0.3)


@pytest.mark.cuda
def test_soft_edtsq_softmin_kernels_match_plain(cuda):
    rng = np.random.default_rng(3)
    labels = np.kron(rng.integers(0, 4, size=(4, 4, 4)),
                     np.ones((8, 8, 8), np.uint8)).astype(np.int32)
    lt = torch.from_numpy(labels).to(cuda)
    outs = []
    for kernels in (soft.KERNELS, soft.PLAIN):
        occ = (lt != 0).float().requires_grad_()
        out = soft.multilabel_edtsq(lt, occ, (6.0, 6.0, 30.0), True,
                                    temperature=0.5, kernels=kernels)
        (g,) = torch.autograd.grad(out.sum(), occ)
        outs.append((out.detach(), g))
    (out, g), (rout, rg) = outs
    torch.testing.assert_close(out, rout, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(g, rg, rtol=1e-4,
                               atol=1e-4 * float(rg.abs().max()))
