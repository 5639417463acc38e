"""K2, K3 and K4 (edt_tpu_torch.ops.argmin, edt_tpu_torch.ops.grad) on the
CPU: the plain versions against the JAX oracles, and the wrappers'
dispatch and checks. The CUDA kernels themselves are tested in
test_torch_cuda.py.

Tolerances:
- K2 (values, absolute args, offsets): bit-exact.
- K3 against JAX's ``.at[].add``: rtol=1e-6, atol=1e-6. Both scatter the
  same contributions; only the order of a target's sum may differ, a few
  f32 ulps of sums of values in [-1, 1].
- K4 against ``soft._binary_grad_from_links``: rtol=1e-6, atol=1e-6. The
  JAX oracle sums a segment by ``associative_scan``, the plain version by
  shift-and-add steps: the same terms in another order.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edt_tpu.models import soft as jsoft
from edt_tpu.ops import pallas_kernels as pk
from edt_tpu_torch.ops import argmin, grad
from edt_tpu_torch.ops.wall_sentinels import WALL_SENT16, WALL_SENT32

torch.set_num_threads(1)

N = 300


def _regime(kind, seed=0):
    """(f, f32 walls, int16 counts, w) rows of the regimes K2 has."""
    rng = np.random.default_rng(seed)
    w = 1.3
    f = (rng.random((9, N)) * 50).astype(np.float32)
    f[rng.random((9, N)) > 0.6] = 0.0
    cnt = rng.integers(1, 40, size=(9, N)).astype(np.int16)
    cnt[rng.random((9, N)) > 0.9] = WALL_SENT16  # open sides
    if kind == "barrier-sparse":  # sources beyond the probe of a tile
        f = np.full((9, N), 2.7e5, np.float32)
        f[:, ::70] = 0.0
        cnt = rng.integers(1, 400, size=(9, N)).astype(np.int16)
    elif kind == "wall-everywhere":  # walls win most voxels
        cnt = rng.integers(1, 4, size=(9, N)).astype(np.int16)
    elif kind == "exact-ties":  # walls and candidates of equal cost
        w = 6.0
        f = np.full((9, N), 1000.0, np.float32)
        f[:, ::10] = 0.0
        i = np.arange(N)
        cnt = np.broadcast_to(np.minimum(i % 10, 10 - i % 10),
                              (9, N)).astype(np.int16).copy()
        cnt[cnt == 0] = 1
    elif kind == "inf-rows":  # all-INF rows beside finite ones
        f[::2] = np.inf
    w2 = float(np.float32(w) * np.float32(w))
    walls = np.array(jsoft._walls_from_counts(jnp.asarray(cnt),
                                              jnp.float32(w2)))
    return f, walls, cnt, w2


def _oracle(f, w2, walls_f32, emit_offsets):
    """The JAX package's jnp path: brute-force min/argmin, then the wall
    clamp and the residual encoding of models/soft.py."""
    d, a = jsoft._minplus_hard_with_arg(jnp.asarray(f), jnp.float32(w2))
    d, a = np.asarray(d), np.asarray(a)
    n = f.shape[1]
    idx = np.arange(n)[None, :]
    win = None
    if walls_f32 is not None:
        win = d <= walls_f32
        d = np.where(win, d, walls_f32)
    if emit_offsets:
        idt = np.int16 if n <= 16000 else np.int32
        o = (a - idx).astype(idt)
        if win is not None:
            o = np.where(win, o, np.iinfo(idt).min).astype(idt)
        return d, o
    if win is not None:
        a = np.where(win, a, ~idx)
    return d, a.astype(np.int32)


def assert_same(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    fin = np.isfinite(ref) if ref.dtype.kind == "f" else np.ones(ref.shape, bool)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[fin], ref[fin])


def test_torch_argmin_takes_first_index_on_ties():
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0], [np.inf] * 5])
    assert x.argmin(dim=-1).tolist() == [1, 0]


@pytest.mark.parametrize("emit_offsets", [False, True])
@pytest.mark.parametrize("walls", ["none", "f32", "int16", "int32"])
@pytest.mark.parametrize("kind", ["source-rich", "barrier-sparse",
                                  "wall-everywhere", "exact-ties",
                                  "inf-rows"])
def test_argmin_plain_matches_jax(kind, walls, emit_offsets):
    f, wf, cnt, w2 = _regime(kind)
    w_in = {"none": None, "f32": torch.from_numpy(wf),
            "int16": torch.from_numpy(cnt),
            "int32": torch.from_numpy(np.where(cnt >= WALL_SENT16, WALL_SENT32,
                                               cnt.astype(np.int32)))}[walls]
    d, a = argmin.minplus_argmin_plain(torch.from_numpy(f), w2, w_in,
                                       emit_offsets)
    rd, ra = _oracle(f, w2, None if walls == "none" else wf, emit_offsets)
    assert_same(d.numpy(), rd)
    assert_same(a.numpy(), ra)


def test_argmin_plain_matches_jax_kernel():
    """Against JAX's own K2 (Pallas, interpret mode): int16 counts and
    int16 offsets, the encoding the multi-label backward reads."""
    f, _, cnt, w2 = _regime("barrier-sparse", seed=1)
    d, o = argmin.minplus_argmin_plain(torch.from_numpy(f), w2,
                                       torch.from_numpy(cnt), True)
    rd, ro = pk.minplus_argmin_pallas(jnp.asarray(f), jnp.float32(w2),
                                      walls=jnp.asarray(cnt), interpret=True,
                                      emit_offsets=True)
    assert_same(d.numpy(), np.asarray(rd))
    assert_same(o.numpy(), np.asarray(ro))


def test_argmin_plain_long_row_int32():
    """Rows longer than 16000: int32 counts from JAX's _wall_counts and
    int32 offsets. Sources only at a few sites, so the oracle is the
    min/argmin over those sites alone (ascending: leftmost on ties)."""
    n = 16001
    rng = np.random.default_rng(2)
    labels = np.repeat(rng.integers(0, 3, size=(1, 40)), 401, axis=1)[:, :n]
    labels[0, :2000] = 7  # the first run is open on its left
    cnt = np.array(jsoft._wall_counts(jnp.asarray(labels), 1, False))
    assert cnt.dtype == np.int32
    f = np.full((1, n), np.inf, np.float32)
    src = np.sort(rng.choice(n, size=6, replace=False))
    f[:, src] = rng.random(6).astype(np.float32) * 100
    w2 = 1.69
    d, o = argmin.minplus_argmin_plain(torch.from_numpy(f), w2,
                                       torch.from_numpy(cnt), True)
    i = np.arange(n, dtype=np.float32)[:, None]
    k = i - src.astype(np.float32)[None, :]
    cost = f[0, src][None, :] + np.float32(w2) * (k * k)
    best = cost.argmin(axis=1)
    walls = np.asarray(jsoft._walls_from_counts(jnp.asarray(cnt),
                                                jnp.float32(w2)))
    ref_d = cost[np.arange(n), best]
    win = ref_d <= walls[0]
    ref_o = np.where(win, src[best] - np.arange(n),
                     np.iinfo(np.int32).min).astype(np.int32)
    assert_same(d.numpy()[0], np.where(win, ref_d, walls[0]))
    assert_same(o.numpy()[0], ref_o)


def test_argmin_int16_counts_on_long_rows_raise():
    f = torch.zeros((1, 16001))
    with pytest.raises(ValueError, match="int16 wall counts"):
        argmin.minplus_argmin_plain(f, 1.0, torch.zeros((1, 16001),
                                                        dtype=torch.int16))


def test_kernel_ceilings():
    """K2 stages only the f32 row and K3 only its f32 accumulator in shared
    memory, 4 B a voxel each: both take rows up to 58048, as K1 and K5."""
    assert argmin.MAX_AXIS == 58048 and grad.MAX_AXIS == 58048


def _links(kind):
    """Cotangents and K2's link residuals (walled offsets) of a regime."""
    f, _, cnt, w2 = _regime(kind)
    d, o = argmin.minplus_argmin_plain(torch.from_numpy(f), w2,
                                       torch.from_numpy(cnt), True)
    g = np.random.default_rng(3).uniform(-1, 1, f.shape).astype(np.float32)
    return g, o.numpy()


@pytest.mark.parametrize("kind", ["source-rich", "barrier-sparse",
                                  "exact-ties"])
def test_grad_plain_matches_jax_scatter(kind):
    g, o = _links(kind)
    sent = np.iinfo(o.dtype).min
    win = o != sent
    n = g.shape[1]
    idx = np.arange(n)[None, :]
    links = idx + np.where(win, o, 0).astype(np.int32)
    gm = np.where(win, g, 0).astype(np.float32)
    rows = np.arange(g.shape[0])[:, None]
    ref = np.asarray(jnp.zeros(g.shape, jnp.float32)
                     .at[rows, links].add(jnp.asarray(gm)))
    got = grad.minplus_grad_plain(torch.from_numpy(g),
                                  offsets=torch.from_numpy(o), off_sent=sent)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the same links as absolute indices, wall wins as ~i
    argj = np.where(win, links, ~idx).astype(np.int32)
    got = grad.minplus_grad_plain(torch.from_numpy(g),
                                  argj=torch.from_numpy(argj))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def _binary_links(walled, seed=4):
    """Cotangents and the closed-form binary pass's residual, as
    models/soft.py stores it (wall wins at the dtype min when walled, zero
    sites at the dtype max)."""
    rng = np.random.default_rng(seed)
    f = np.where(rng.random((12, 200)) < 0.08, 0.0, 5e4).astype(np.float32)
    f[3] = 5e4  # a row without sources
    w2 = 36.0
    d, argj = jsoft._minplus_hard_binary_with_arg(jnp.asarray(f),
                                                  jnp.float32(w2))
    d, argj = np.asarray(d), np.asarray(argj)
    idx = np.arange(200)[None, :]
    o = (argj - idx).astype(np.int16)
    if walled:
        cnt = rng.integers(1, 12, size=f.shape).astype(np.int16)
        walls = np.asarray(jsoft._walls_from_counts(jnp.asarray(cnt),
                                                    jnp.float32(w2)))
        o = np.where(d <= walls, o, np.iinfo(np.int16).min).astype(np.int16)
    o = np.where(f <= 0, np.iinfo(np.int16).max, o).astype(np.int16)
    g = rng.uniform(-1, 1, f.shape).astype(np.float32)
    return g, o


@pytest.mark.parametrize("walled", [False, True])
def test_binary_grad_scan_plain_matches_jax(walled):
    g, o = _binary_links(walled)
    sent = np.iinfo(np.int16).min if walled else None
    win = o != sent if walled else np.ones(o.shape, bool)
    z = o == np.iinfo(np.int16).max
    gm = np.where(win, g, 0).astype(np.float32)
    o0 = np.where(win & ~z, o, 0).astype(np.int16)
    # jit: one compile of the oracle's scans instead of one an operation
    oracle = jax.jit(jsoft._binary_grad_from_links)
    ref = np.asarray(oracle(jnp.asarray(gm), jnp.asarray(o0), jnp.asarray(z)))
    got = grad.binary_grad_scan_plain(torch.from_numpy(g),
                                      torch.from_numpy(o), off_sent=sent)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # with every cotangent 1 the sums are small integers: exact
    ones = np.ones_like(g)
    ref1 = np.asarray(oracle(
        jnp.asarray(np.where(win, ones, 0).astype(np.float32)),
        jnp.asarray(o0), jnp.asarray(z)))
    got1 = grad.binary_grad_scan_plain(torch.from_numpy(ones),
                                       torch.from_numpy(o), off_sent=sent)
    assert np.array_equal(got1.numpy(), ref1)


def test_wrappers_take_plain_only_on_cpu():
    f, _, cnt, w2 = _regime("source-rich")
    ft, ct = torch.from_numpy(f), torch.from_numpy(cnt)
    before = (argmin.launches, grad.minplus_grad_launches,
              grad.binary_grad_scan_launches)
    d, o = argmin.minplus_argmin(ft, w2, ct, emit_offsets=True)
    rd, ro = argmin.minplus_argmin_plain(ft, w2, ct, emit_offsets=True)
    assert torch.equal(d, rd) and torch.equal(o, ro)
    g = torch.ones_like(ft)
    sent = torch.iinfo(o.dtype).min
    assert torch.equal(grad.minplus_grad(g, offsets=o, off_sent=sent),
                       grad.minplus_grad_plain(g, offsets=o, off_sent=sent))
    gb, ob = _binary_links(True)
    gb, ob = torch.from_numpy(gb), torch.from_numpy(ob)
    assert torch.equal(grad.binary_grad_scan(gb, ob, off_sent=-32768),
                       grad.binary_grad_scan_plain(gb, ob, off_sent=-32768))
    # the plain versions launch nothing
    assert before == (argmin.launches, grad.minplus_grad_launches,
                      grad.binary_grad_scan_launches)
    meta = torch.empty(2, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        argmin.minplus_argmin(meta, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        grad.minplus_grad(meta, offsets=torch.zeros(2, 3, dtype=torch.int16,
                                                    device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        grad.binary_grad_scan(meta, torch.zeros(2, 3, dtype=torch.int16,
                                                device="meta"))
    with pytest.raises(ValueError, match="exactly one"):
        grad.minplus_grad(g)
    with pytest.raises(ValueError, match="walls must be"):
        argmin.minplus_argmin(ft, w2, ct.to(torch.int64))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [1, 31, 33, 512, 700])
def test_k4_blocked_emulation_matches_plain_and_jax(n):
    """K4's lane-blocked scan (V contiguous voxels a lane, the lane sums
    scanned across the warp), emulated in torch by
    ``chip_smoke.k4_blocked``: within rtol=1e-5, atol=1e-5 of the plain
    version and of the Pallas kernel in interpret mode (the same sums in
    another order), with zero sites on lane boundaries, rows without zero
    sites, rows of zero sites only, and wall wins (off_sent)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(n)
    top, sent = np.iinfo(np.int16).max, np.iinfo(np.int16).min
    v = cs.k4_lanes(n)
    i = np.arange(n)
    o = rng.integers(-6, 7, size=(12, n))
    o[:3, (i % v == 0) | (i % v == v - 1)] = top
    o[3:6][rng.random((3, n)) < 0.2] = top
    o[6] = top  # row 7: no zero site, row 6: zero sites only
    o[8:, [0, n - 1]] = top
    g = rng.uniform(-1, 1, (12, n)).astype(np.float32)
    for s in (None, sent):
        oo = o if s is None else np.where(rng.random(o.shape) < 0.1, s, o)
        oo = oo.astype(np.int16)
        got = cs.k4_blocked(torch.from_numpy(g), torch.from_numpy(oo), s)
        ref = grad.binary_grad_scan_plain(torch.from_numpy(g),
                                          torch.from_numpy(oo), s)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
        kern = np.asarray(pk.binary_grad_scan_pallas(
            jnp.asarray(g), jnp.asarray(oo), off_sent=s, interpret=True))
        np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-5)
