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

torch.set_num_threads(1)


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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "long-run", "inf-rows"])
def test_minplus_custom_op_is_the_kernel(cuda, kind):
    """K1's custom op launches the kernel on CUDA tensors, to the same bits
    as the wrapper, once a call; compose.edtsq's default goes through it."""
    from edt_tpu_torch.ops import compose

    f, labels = _rows(kind, np.random.default_rng(1))
    ft = torch.from_numpy(np.where(labels == 0, 0, f).astype(np.float32)).to(cuda)
    ss, se = core.segment_bounds(torch.from_numpy(labels).to(cuda))
    for masked in (False, True):
        args = (ss, se) if masked else (None, None)
        before = minplus.launches
        got = torch.ops.edt_tpu_torch.minplus_walls(ft, *args, 36.0, True,
                                                    masked)
        assert minplus.launches == before + 1
        assert torch.equal(got, minplus.minplus_walls(ft, *args, 36.0, True,
                                                      masked))
    lab = torch.from_numpy(np.random.default_rng(2).integers(
        0, 3, (20, 21, 22)).astype(np.int32)).to(cuda)
    before = minplus.launches
    got = compose.edtsq(lab, (1.0, 2.0, 3.0), True)
    assert minplus.launches == before + 2
    plain = minplus.make_parabolic_fn(minplus.minplus_walls_plain)
    assert torch.equal(got, compose.edtsq(lab, (1.0, 2.0, 3.0), True,
                                          parabolic_fn=plain))


@pytest.mark.cuda
@pytest.mark.parametrize("bb", [False, True])
def test_voxel_graph_on_the_card_matches_plain(cuda, bb):
    """The voxel-graph transform on the card (K1 on the doubled volume)
    against the same volume doubled on the host through the plain pass."""
    import edt_tpu_torch
    from edt_tpu_torch.ops import compose
    from edt_tpu_torch.ops import voxel_graph as vg

    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, (30, 31, 32)).astype(np.uint32)
    graph = np.full(labels.shape, 0b111111, np.uint8)
    for bit in (0b1, 0b100, 0b10000):
        graph[rng.random(labels.shape) < 0.1] &= np.uint8(~bit & 0xFF)
    before = minplus.launches
    got = edt_tpu_torch.edtsq(labels, (6.0, 6.0, 30.0), bb, voxel_graph=graph)
    assert minplus.launches == before + 2
    D = torch.from_numpy(vg._doubled_3d((labels != 0).astype(np.uint8),
                                        graph, bb)).to(cuda)
    plain = minplus.make_parabolic_fn(minplus.minplus_walls_plain)
    ref = compose.edtsq(D, (3.0, 3.0, 15.0), bb, binary=True,
                        parabolic_fn=plain)[::2, ::2, ::2].cpu().numpy()
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[fin], ref[fin])


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
    version, the same bits from two launches. The plain version runs on
    the CPU, where scatter_add_ sums in ascending order as K3 does; on the
    card it adds with atomics, in an order that changes from run to run."""
    rng = np.random.default_rng(6)
    for n in (1, 33, 300):
        o = torch.from_numpy(_k3_links(kind, n, rng)).to(cuda)
        g = torch.from_numpy(rng.uniform(-1, 1, (16, n)).astype(np.float32)).to(cuda)
        got = grad.minplus_grad(g, offsets=o, off_sent=-32768)
        ref = grad.minplus_grad_plain(g.cpu(), offsets=o.cpu(), off_sent=-32768)
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=1e-6)
        assert torch.equal(got, grad.minplus_grad(g, offsets=o, off_sent=-32768))


@pytest.mark.cuda
def test_argmin_and_grad_ceilings(cuda):
    """Both kernels take rows up to 58048 in shared memory and longer ones
    in their long-row mode, at the ceiling and one past it: one source a
    row, d = w2 k^2 exactly; one link target, df = the row's sum (the
    cotangents are multiples of 1/16, so the sums are exact)."""
    assert argmin.MAX_AXIS == grad.MAX_AXIS
    for n in (argmin.MAX_AXIS, argmin.MAX_AXIS + 1):
        f = torch.full((2, n), float("inf"), device=cuda)
        f[:, 5] = 0.0
        d, a = argmin.minplus_argmin(f, 1.69, None)
        k = (torch.arange(n, device=cuda) - 5).to(torch.float32)
        assert torch.equal(d, (1.69 * (k * k)).expand(2, n))
        assert bool((a == 5).all())
        g = torch.randint(-64, 64, (2, n), device=cuda) / 16.0
        o = (7 - torch.arange(n, device=cuda)).to(torch.int32).expand(2, -1)
        df = grad.minplus_grad(g, offsets=o.contiguous())
        assert torch.equal(df[:, 7], g.sum(dim=1)) and int((df != 0).sum()) <= 2


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
    # a row past a ceiling is no bad input: the long-row modes take it
    d = softmin.softmin(torch.zeros(1, softmin.MAX_AXIS + 1, device=cuda),
                        1.0, 0.3)
    assert bool(torch.isfinite(d).all())
    big = torch.zeros(1, softmin.GRAD_MAX_AXIS + 1, device=cuda)
    df, e = softmin.softmin_grad(big, big, big, 1.0, 0.3)
    assert bool((df == 0).all()) and bool(torch.isfinite(e).all())
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


def _k1_stress_rows(kind, rng):
    """(f, labels) rows that stress K1's exact stop: heights near 3e7
    (ulp 2), partly INF rows and a wholly INF one, one-voxel segments,
    and sparse sources whose searches the row radius caps."""
    if kind == "near-3e7":
        f = (3e7 + rng.random((12, 300)) * 200).astype(np.float32)
        f[6:, ::17] = 2.99999e7
        labels = rng.integers(1, 3, size=(12, 300))
    elif kind == "partly-inf":
        f = (rng.random((12, 300)) * 900).astype(np.float32)
        f[rng.random((12, 300)) < 0.3] = np.inf
        f[1] = np.inf
        labels = np.repeat(rng.integers(0, 3, size=(12, 10)), 30, axis=1)
    elif kind == "one-voxel-segments":
        f = (rng.random((12, 300)) * 90).astype(np.float32)
        labels = np.broadcast_to(np.arange(300) % 3 + 1, (12, 300)).copy()
    else:  # sparse sources
        f = np.full((12, 300), 1e4, np.float32)
        f[:, ::37] = rng.random((12, 9)) * 50
        f[2] = np.inf
        f[2, 250] = 0.0
        labels = np.ones((12, 300))
    f[labels == 0] = 0
    return f, labels.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["near-3e7", "partly-inf",
                                  "one-voxel-segments", "sparse-sources"])
def test_minplus_kernel_exact_stop(cuda, kind):
    """K1's outward search stops exactly: bit-exact to the plain version
    for w2 in {0.7, 1, 36, 900}, multi-label and binary, with and without
    black_border, and the same bits from two launches."""
    f, labels = _k1_stress_rows(kind, np.random.default_rng(8))
    for binary in (False, True):
        lb = (labels != 0).astype(np.int32) if binary else labels
        ft = torch.from_numpy(np.where(lb == 0, 0, f).astype(np.float32)).to(cuda)
        ss, se = core.segment_bounds(torch.from_numpy(lb).to(cuda))
        for bb in (False, True):
            for w2 in (0.7, 1.0, 36.0, 900.0):
                got = minplus.minplus_walls(ft, ss, se, w2, bb, not binary)
                ref = minplus.minplus_walls_plain(ft, ss, se, w2, bb,
                                                  not binary)
                fin = torch.isfinite(ref)
                assert torch.equal(torch.isfinite(got), fin)
                assert torch.equal(got[fin], ref[fin])
                again = minplus.minplus_walls(ft, ss, se, w2, bb, not binary)
                assert torch.equal(got.view(torch.int32),
                                   again.view(torch.int32))


@pytest.mark.cuda
def test_minplus_kernel_ceiling(cuda):
    """K1 takes rows up to 58048 in shared memory and longer ones in its
    long-row mode, at the ceiling and one past it: one source a row, INF
    elsewhere, d = w2 k^2 exactly, binary and as one segment."""
    assert minplus.MAX_AXIS >= 58048
    for n in (minplus.MAX_AXIS, minplus.MAX_AXIS + 1):
        f = torch.full((2, n), float("inf"), device=cuda)
        f[:, 11] = 0.0
        k = (torch.arange(n, device=cuda) - 11).to(torch.float32)
        ref = (36.0 * (k * k)).expand(2, n)
        seg = torch.zeros((2, n), dtype=torch.int32, device=cuda)
        for masked in (False, True):
            got = minplus.minplus_walls(f, seg, seg + n, 36.0, False, masked)
            assert torch.equal(got, ref)


def _distance_net_rows(rng, rows, n):
    """Heights like DistanceFieldNet's untrained head: sigmoid of smooth
    logits with per-voxel noise, times S^2 / 2 for S = n."""
    z = rng.normal(0, 1, (rows, n)) * 0.4
    z += np.cumsum(rng.normal(0, 0.05, (rows, n)), axis=1)
    return (n * n / 2 / (1 + np.exp(-z))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.01, 0.3, 1.0])
def test_softmin_grad_kernel_long_windows(cuda, t):
    """K6 on DistanceFieldNet-like rows (long windows, heights of
    thousands): df within rtol=1e-4, atol=1e-4 max|df| of the plain
    version, sum(g * e) within rtol=1e-3, the same bits from two launches."""
    rng = np.random.default_rng(9)
    f = torch.from_numpy(_distance_net_rows(rng, 16, 256)).to(cuda)
    d = softmin.softmin_plain(f, 1.0, t)
    g = torch.from_numpy(rng.uniform(-1, 1, (16, 256)).astype(np.float32)).to(cuda)
    df, e = softmin.softmin_grad(f, d, g, 1.0, t)
    rdf, re = softmin.softmin_grad_plain(f, d, g, 1.0, t)
    torch.testing.assert_close(df, rdf, rtol=1e-4,
                               atol=1e-4 * float(rdf.abs().max()))
    torch.testing.assert_close((g * e).sum(), (g * re).sum(), rtol=1e-3,
                               atol=0.0)
    df2, e2 = softmin.softmin_grad(f, d, g, 1.0, t)
    assert torch.equal(df.view(torch.int32), df2.view(torch.int32))
    assert torch.equal(e.view(torch.int32), e2.view(torch.int32))


@pytest.mark.cuda
def test_softmin_grad_kernel_ceiling(cuda):
    """K6 takes rows up to 29024 in shared memory and longer ones in its
    long-row mode, at the ceiling and one past it: one source a row,
    d = w2 k^2, so df = sum(g) at the source and e = k^2."""
    assert softmin.GRAD_MAX_AXIS >= 19349
    for n in (softmin.GRAD_MAX_AXIS, softmin.GRAD_MAX_AXIS + 1):
        f = torch.full((2, n), float("inf"), device=cuda)
        f[:, 40] = 0.0
        k = (torch.arange(n, device=cuda) - 40).to(torch.float32)
        d = (36.0 * (k * k)).expand(2, n).contiguous()
        g = (torch.randint(-64, 64, (2, n), device=cuda) / 16.0).contiguous()
        df, e = softmin.softmin_grad(f, d, g, 36.0, 0.3)
        torch.testing.assert_close(df[:, 40], g.sum(dim=1), rtol=1e-5, atol=1e-3)
        assert int((df != 0).sum()) <= 2
        torch.testing.assert_close(e, (k * k).expand(2, n), rtol=1e-5, atol=0.0)


def _k5_rows(kind, n, rng):
    """(f, w2) rows for K5's walks: heights near 3e7 (ulp 2), partly INF
    rows with a wholly INF one and one of a single finite height, and
    DistanceFieldNet-like rows (w2 = 1, heights of n^2 / 2)."""
    rows = 12 if n <= 257 else 4
    if kind == "near-3e7":
        f = (3e7 + rng.random((rows, n)) * 200).astype(np.float32)
        f[rows // 2:, ::97] = 2.99999e7
        return f, 0.7
    if kind == "partly-inf":
        f = (rng.random((rows, n)) * 900).astype(np.float32)
        f[rng.random((rows, n)) < 0.3] = np.inf
        f[1] = np.inf
        f[2] = np.inf
        f[2, rng.integers(0, n)] = 5.0
        return f, 900.0
    return _distance_net_rows(rng, rows, n), 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 256, 257, 2048, 2049])
def test_softmin_kernel_walks(cuda, n):
    """K5 in both regimes (a warp a row up to 2048, a block a row beyond)
    on rows that stress its walks and its cut, t in {0.01, 0.3, 1}: within
    rtol=1e-5, atol=1e-4 of the plain version, the same INF pattern, the
    same bits from two launches."""
    rng = np.random.default_rng(n + 1)
    for kind in ("near-3e7", "partly-inf", "distance-net"):
        f, w2 = _k5_rows(kind, n, rng)
        ft = torch.from_numpy(f).to(cuda)
        for t in (0.01, 0.3, 1.0):
            d = softmin.softmin(ft, w2, t)
            rd = softmin.softmin_plain(ft, w2, t)
            fin = torch.isfinite(rd)
            assert torch.equal(torch.isfinite(d), fin)
            torch.testing.assert_close(d[fin], rd[fin], rtol=1e-5, atol=1e-4)
            again = softmin.softmin(ft, w2, t)
            assert torch.equal(d.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_softmin_kernel_ceiling(cuda):
    """K5 takes rows up to 58048 in shared memory and longer ones in its
    long-row mode, at the ceiling and one past it: random heights with INF
    every third voxel against the plain arithmetic taken 256 targets at a
    time."""
    assert softmin.MAX_AXIS == 58048
    rng = np.random.default_rng(4)
    for n in (softmin.MAX_AXIS, softmin.MAX_AXIS + 1):
        f = torch.from_numpy((rng.random((2, n)) * 900).astype(np.float32)).to(cuda)
        f[1, ::3] = float("inf")
        d = softmin.softmin(f, 36.0, 0.3)
        j = torch.arange(n, dtype=torch.float32, device=cuda)
        for i0 in range(0, n, 256):
            diff = j[i0:i0 + 256, None] - j[None, :]
            cost = f[:, None, :] + (diff * diff) * 36.0
            ref = -0.3 * torch.logsumexp(-cost / 0.3, dim=-1)
            torch.testing.assert_close(d[:, i0:i0 + 256], ref, rtol=1e-5,
                                       atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 31, 33, 512, 513, 1024, 1025, 3000])
def test_binary_grad_scan_kernel_lanes(cuda, n):
    """K4 on rows a warp holds in registers (n <= 1024) and past them (the
    two sweeps): zero sites on the lane boundaries, on the first and last
    voxel only, rows without and rows of only zero sites, wall wins at
    off_sent, int16 and int32 offsets; within rtol=1e-5, atol=1e-5 of the
    plain version, the same bits from two launches."""
    rng = np.random.default_rng(n)
    v = 1
    while 32 * v < n:
        v *= 2
    i = np.arange(n)
    for idt in (torch.int16, torch.int32):
        top, sent = torch.iinfo(idt).max, torch.iinfo(idt).min
        o = rng.integers(-6, 7, size=(10, n))
        o[:2, (i % v == 0) | (i % v == v - 1)] = top
        o[2:4][rng.random((2, n)) < 0.2] = top
        o[5] = top  # row 4: no zero site, row 5: zero sites only
        o[6:8, [0, n - 1]] = top
        o[8:] = np.where(rng.random((2, n)) < 0.1, sent, o[8:])
        g = torch.from_numpy(rng.uniform(-1, 1, (10, n)).astype(np.float32)).to(cuda)
        ot = torch.from_numpy(o).to(idt).to(cuda)
        for s in (None, sent):
            got = grad.binary_grad_scan(g, ot, off_sent=s)
            ref = grad.binary_grad_scan_plain(g, ot, off_sent=s)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
            again = grad.binary_grad_scan(g, ot, off_sent=s)
            assert torch.equal(got.view(torch.int32), again.view(torch.int32))
