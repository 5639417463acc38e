"""edt_tpu_torch's voxel-graph EDT against edt_tpu's on the CPU.

Every case of tests/test_voxel_graph.py, plus seeded random volumes and
graphs, goes through both packages with the same numpy inputs; the port
runs with ``device="cpu"``. The squared forms are bit-exact, and so are
the sqrt forms (np.sqrt of equal f32 values).
"""

import numpy as np
import pytest
import torch

import edt_tpu
import edt_tpu_torch
from edt_tpu.ops import voxel_graph as jvg
from edt_tpu_torch.ops import minplus
from edt_tpu_torch.ops import voxel_graph as vg
from edt_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

OMNI = 0b111111
NOXF = 0b111110  # +x blocked
NOXB = 0b111101  # -x blocked (ignored: only +x/+y/+z are consulted)


def assert_same(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert got.flags.f_contiguous == ref.flags.f_contiguous
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[fin], ref[fin])


def both(name, data, graph, *args, **kw):
    got = getattr(edt_tpu_torch, name)(data, *args, voxel_graph=graph,
                                       device="cpu", **kw)
    ref = getattr(edt_tpu, name)(data, *args, voxel_graph=graph, **kw)
    assert_same(got, ref)
    return got


def _wall_graph():
    graph = np.full((5, 6), OMNI, dtype=np.uint8)
    graph[2, 2] = NOXF
    graph[2, 3] = NOXB
    return graph


def _random_case(shape, seed, dtype=np.uint32):
    """Labels in 4-voxel blocks with single-voxel noise, and a graph with
    about 10 % of its +x/+y/+z bits cleared."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, size=tuple(-(-s // 4) for s in shape))
    lab = np.kron(base, np.ones((4,) * len(shape), np.uint8))
    lab = lab[tuple(slice(0, s) for s in shape)]
    lab = np.where(rng.random(shape) < 0.1, rng.integers(0, 3, shape), lab)
    graph = np.full(shape, OMNI, np.uint8)
    for bit in (0b1, 0b100, 0b10000):
        graph[rng.random(shape) < 0.1] &= np.uint8(~bit & 0xFF)
    return lab.astype(dtype), graph


@pytest.mark.parametrize("bb", [False, True])
def test_2d_omni(bb):
    labels = np.ones((5, 6), dtype=int)
    graph = np.full((5, 6), OMNI, dtype=np.uint8)
    dt = both("edt", labels, graph, black_border=bb)
    if not bb:
        assert np.all(dt == np.inf)
    both("edtsq", labels, graph, black_border=bb)


@pytest.mark.parametrize("layout", ["C", "F graph", "F labels"])
def test_2d_wall(layout):
    labels = np.ones((5, 6), dtype=int)
    graph = _wall_graph()
    if layout == "F graph":  # the axis mapping follows the data's order
        graph = np.asfortranarray(graph)
    elif layout == "F labels":  # "x" becomes axis 0
        labels = np.asfortranarray(labels.T)
        graph = np.asfortranarray(graph.T)
    dt = both("edt", labels, graph, black_border=True)
    s5h = np.sqrt(5.0) / 2.0
    ans = np.array([[0.5] * 6, [0.5, 1.5, s5h, s5h, 1.5, 0.5],
                    [0.5, 1.5, 0.5, 0.5, 1.5, 0.5],
                    [0.5, 1.5, s5h, s5h, 1.5, 0.5], [0.5] * 6])
    if layout == "F labels":
        ans = ans.T
    assert np.max(np.abs(dt - ans)) < 2e-6


def test_3d_omni_and_x_wall():
    labels = np.ones((4, 4, 4), dtype=np.uint32)
    graph = np.full((4, 4, 4), OMNI, dtype=np.uint8)
    dt = both("edt", labels, graph, black_border=True)
    per_axis = np.minimum(np.arange(4) + 1, 4 - np.arange(4)) - 0.5
    expected = np.minimum.reduce(np.meshgrid(*[per_axis] * 3, indexing="ij"))
    assert np.allclose(dt, expected)
    graph[1, 1, 1] = OMNI & ~0b1  # block +x (x = last axis)
    dt2 = both("edt", labels, graph, black_border=True)
    assert dt2[1, 1, 1] == 0.5 and dt2[1, 1, 2] <= dt[1, 1, 2]


def test_multilabel_reduces_to_foreground():
    labels = np.ones((3, 3), dtype=np.uint32)
    labels[0, :] = 7
    graph = np.full((3, 3), OMNI, dtype=np.uint8)
    dt = both("edt", labels, graph, black_border=True)
    assert np.array_equal(dt, both("edt", labels > 0, graph,
                                   black_border=True))


@pytest.mark.parametrize("binary", [False, True])
def test_negative_floats_stay_background(binary):
    labels = np.array([[-1.0, -1.0], [2.0, 2.0]], np.float32)
    graph = np.full((2, 2), 0xFF, np.uint8)
    out = both("edtsq", labels, graph, black_border=True, binary=binary)
    assert np.all(out[labels < 0] == 0)


@pytest.mark.parametrize("shape,aniso,bb,order,dtype,gdtype", [
    ((12, 13, 14), (6.0, 6.0, 30.0), True, "C", np.uint32, np.uint8),
    ((12, 13, 14), (1.0, 2.0, 3.0), False, "F", np.uint32, np.uint8),
    ((9, 10, 11), (1.3, 1.0, 2.0), True, "F", np.float32, np.int8),
    ((9, 10, 11), (1.0, 1.0, 1.0), True, "C", np.int64, np.int32),
    ((17, 23), (2.0, 1.0), True, "C", np.uint16, np.uint8),
    ((17, 23), (1.0, 3.0), False, "F", np.uint8, np.uint8),
])
def test_random_volumes(shape, aniso, bb, order, dtype, gdtype):
    labels, graph = _random_case(shape, seed=len(shape) + shape[0])
    labels = labels.astype(dtype)
    if dtype == np.float32:  # some negative floats: background here
        labels[labels == 2] = -1.0
    graph = graph.astype(gdtype)
    if order == "F":
        labels, graph = np.asfortranarray(labels), np.asfortranarray(graph)
    both("edtsq", labels, graph, aniso, bb)
    both("edtsq", labels, graph, aniso, bb, binary=True)


@pytest.mark.parametrize("name", ["sdf", "sdfsq"])
def test_sdf_with_voxel_graph(name):
    labels, graph = _random_case((10, 11, 12), seed=5)
    both(name, labels, graph, (1.0, 2.0, 3.0), True)


def test_fixed_dimension_entry_points_pass_the_graph():
    labels, graph = _random_case((10, 11, 12), seed=6)
    for name in ("edt3d", "edt3dsq"):
        assert_same(
            getattr(edt_tpu_torch, name)(labels, (1.0, 1.0, 2.0), True,
                                         voxel_graph=graph, device="cpu"),
            getattr(edt_tpu, name)(labels, (1.0, 1.0, 2.0), True,
                                   voxel_graph=graph))
    labels, graph = _random_case((13, 14), seed=7)
    assert_same(edt_tpu_torch.edt2d(labels, (1.0, 2.0), True,
                                    voxel_graph=graph, device="cpu"),
                edt_tpu.edt2d(labels, (1.0, 2.0), True, voxel_graph=graph))


def test_counts_the_call_and_checks_the_graph_shape():
    labels, graph = _random_case((6, 7), seed=8)
    before = counters.voxel_graph_calls
    edt_tpu_torch.edtsq(labels, voxel_graph=graph, device="cpu")
    assert counters.voxel_graph_calls == before + 1
    with pytest.raises(ValueError, match="must match data shape"):
        edt_tpu_torch.edtsq(labels, voxel_graph=graph[:, 1:], device="cpu")


@pytest.mark.parametrize("bb", [False, True])
def test_doublers_match_numpy_and_jax(bb):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    fg = (rng.random((5, 6, 7)) > 0.3).astype(np.uint8)
    g = rng.integers(0, 64, size=(5, 6, 7)).astype(np.uint8)
    ref = vg._doubled_3d(fg, g, bb)
    assert np.array_equal(ref, jvg._doubled_3d(fg, g, bb))
    got = vg.doubled_3d_torch(torch.from_numpy(fg), torch.from_numpy(g), bb)
    assert np.array_equal(got.numpy(), ref)
    for tail in ((True, False, True), (False, True, False)):
        got = vg.doubled_3d_torch(torch.from_numpy(fg), torch.from_numpy(g),
                                  bb, zero_tail=tail)
        want = jvg.doubled_3d_jnp(jnp.asarray(fg), jnp.asarray(g), bb,
                                  zero_tail=tail)
        assert np.array_equal(got.numpy(), np.asarray(want))
    fg2, g2 = fg[0], g[0]
    ref2 = vg._doubled_2d(fg2, g2, bb)
    assert np.array_equal(ref2, jvg._doubled_2d(fg2, g2, bb))
    got2 = vg.doubled_2d_torch(torch.from_numpy(fg2), torch.from_numpy(g2), bb)
    assert np.array_equal(got2.numpy(), ref2)


def test_device_native_transform_matches_jax():
    import jax.numpy as jnp

    labels, graph = _random_case((10, 12, 14), seed=9)
    labels = labels.astype(np.float32)
    labels[labels == 1] = -3.0
    for bb in (False, True):
        got = vg.edtsq_voxel_graph_torch(torch.from_numpy(labels),
                                         torch.from_numpy(graph),
                                         (6.0, 6.0, 30.0), bb)
        ref = np.asarray(jvg.edtsq_voxel_graph_jnp(
            jnp.asarray(labels), jnp.asarray(graph), (6.0, 6.0, 30.0), bb))
        assert_same(got.numpy(), ref)


def test_device_native_transform_takes_minplus_fn_fifth():
    """C8: ``edtsq_voxel_graph_torch`` takes ``minplus_fn`` at the JAX
    package's fifth position and passes it to ``compose.edtsq``: called
    positionally with the plain min-plus on both sides, bit-equal to
    ``edtsq_voxel_graph_jnp``, and the given min-plus is the one that
    runs (unmasked: the doubled volume is binary)."""
    import jax
    import jax.numpy as jnp

    from edt_tpu.ops import core as jcore
    from edt_tpu_torch.ops import core

    calls = []

    def port_minplus(f, start, end, w2, masked):
        calls.append(masked)
        return core.minplus_masked(f, None, w2)

    def jax_minplus(f, start, end, w2, masked):
        return jcore.minplus_masked(f, None, w2)

    labels, graph = _random_case((6, 7, 8), seed=13)
    for bb in (False, True):
        calls.clear()
        got = vg.edtsq_voxel_graph_torch(torch.from_numpy(labels),
                                         torch.from_numpy(graph),
                                         (6.0, 6.0, 30.0), bb, port_minplus)
        ref = jax.jit(lambda v, g: jvg.edtsq_voxel_graph_jnp(  # noqa: B023
            v, g, (6.0, 6.0, 30.0), bb, jax_minplus))(  # noqa: B023
                jnp.asarray(labels), jnp.asarray(graph))
        assert_same(got.numpy(), np.asarray(ref))
        assert calls == [False, False]


def test_past_the_ceiling_raises(monkeypatch):
    """A doubled axis past K1's shared-memory ceiling no longer raises: K1
    takes such rows in its long-row mode, so both entry points run at any
    length, as the JAX package's do on one device. With the ceiling patched
    down to 20, the doubled axes of 20 and 22 give the JAX package's bits.
    (The long-row mode itself runs only on a card: tests/test_torch_long_rows.py.)"""
    import jax.numpy as jnp

    monkeypatch.setattr(minplus, "MAX_AXIS", 20)
    labels, graph = _random_case((6, 10, 11), seed=10)
    assert_same(edt_tpu_torch.edtsq(labels, voxel_graph=graph, device="cpu"),
                edt_tpu.edtsq(labels, voxel_graph=graph))
    ref = jvg.edtsq_voxel_graph_jnp(jnp.asarray(labels), jnp.asarray(graph),
                                    (1.0, 1.0, 1.0), False)
    assert_same(vg.edtsq_voxel_graph_torch(torch.from_numpy(labels),
                                           torch.from_numpy(graph),
                                           (1, 1, 1)).numpy(),
                np.asarray(ref))
    # a doubled axis at the ceiling runs as before
    assert_same(edt_tpu_torch.edtsq(labels[:, :, :10], voxel_graph=graph[:, :, :10],
                                    device="cpu"),
                edt_tpu.edtsq(labels[:, :, :10], voxel_graph=graph[:, :, :10]))
