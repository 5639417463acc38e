"""edt_tpu_torch.parallel and the soft passes' ``axis_name`` against the
JAX package, on four gloo ranks on the CPU.

A module fixture spawns four ranks once (``torch.multiprocessing``, start
method spawn, a file rendezvous under ``tmp_path``). Every rank runs every
case on the CPU, through the kernels' plain versions; rank 0 writes the
gathered results, and the tests below hold them against the JAX package:

- the sharded transforms against the same-named JAX functions on a mesh
  of four of conftest's eight virtual CPU devices, bit-exact (equal
  finite values, the same INF pattern);
- the soft passes with ``axis_name`` (the ranks' process group), each rank
  holding its slab, against the JAX package's single-device function,
  jitted (``tests/test_sharded.py`` holds that equal to JAX's sharded
  form): forwards bit-exact at temperature 0 and within rtol 1e-5 (atol
  1e-5 max|ref|) at t > 0, gathered gradients within rtol 1e-5 (atol 1e-5
  max|grad|) at t = 0 and rtol 1e-4 (atol 1e-4 max|grad|) at t > 0, the
  tolerances of ``tests/test_torch_soft.py``.

jax is imported inside the tests only: each spawned rank imports this
module again, and needs torch alone.
"""

import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

WORLD = 4
BB = (True, False)
SHAPES = ((8, 6, 8), (7, 5, 6), (9, 4, 7))
ANISOS = ((1.0, 1.0, 1.0), (2.0, 3.0, 5.0))
AUTO = ((7, 5, 6), (1.0, 3.0, 2.0))  # sharded axis: the largest pitch, 1
SDF = ((9, 4, 7), (1.0, 2.0, 3.0))
VG_SHAPES = ((7, 5, 6), (9, 4, 7))
SOFT_SHAPE = (8, 5, 8)
SOFT_CASES = [(name, t) for name in ("multilabel", "multilabel_counts",
                                     "soft_edtsq", "soft_sdfsq", "heights")
              for t in (0.0, 0.3)]
SPAWN_TIMEOUT_S = 240


def _key(*parts):
    return "|".join(map(str, parts))


def _labels(shape, nl=4):
    return np.random.default_rng(sum(shape)).integers(
        0, nl, size=shape).astype(np.int32)


def _vg_inputs(shape):
    rng = np.random.default_rng(shape[0])
    labels = rng.integers(0, 2, size=shape).astype(np.int32) + 1
    labels[rng.random(shape) < 0.15] = 0
    return labels, rng.integers(0, 64, size=shape).astype(np.uint8)


def _soft_inputs():
    """labels, occupancy, heights, two-valued heights, cotangent."""
    rng = np.random.default_rng(17)
    labels = rng.integers(0, 3, size=SOFT_SHAPE).astype(np.int32)
    occ = np.clip(rng.random(SOFT_SHAPE), 0.1, 0.95).astype(np.float32)
    h = (50 * rng.random(SOFT_SHAPE)).astype(np.float32)
    hb = np.where(h > 25, np.float32(50), np.float32(0))
    w = rng.random(SOFT_SHAPE).astype(np.float32)
    return labels, occ, h, hb, w


def _soft_fn(pkg, name, t, labels, group):
    """The case's transform of one input, through either package's
    ``models.soft``, with the same positional arguments (``group`` at
    JAX's ``axis_name`` position: None for the JAX package)."""
    if name == "multilabel":
        return lambda x: pkg.multilabel_edtsq(labels, x, (1.0, 1.0, 2.0),
                                              True, 150.0, t, group)
    if name == "multilabel_counts":
        counts = pkg.wall_counts_for(labels, True, group)
        return lambda x: pkg.multilabel_edtsq(labels, x, (1.0, 1.0, 2.0),
                                              True, 150.0, t, group, None,
                                              counts)
    if name == "soft_edtsq":
        return lambda x: pkg.soft_edtsq(x, (2.0, 1.0, 3.0), True, 64.0, t,
                                        group)
    if name == "soft_sdfsq":
        return lambda x: pkg.soft_sdfsq(x, (2.0, 1.0, 3.0), True, 64.0, t,
                                        group)
    # axis 0 first: at t = 0 the closed form runs on the rotated rows
    return lambda x: pkg.edtsq_from_heights(x, (1.0, 2.0, 3.0), False, t,
                                            group, t == 0.0)


def _soft_input(name, t):
    _, occ, h, hb, _ = _soft_inputs()
    if name == "heights":
        return hb if t == 0.0 else h
    return occ


# ---------------- the ranks ----------------


def _rank_results(rank):
    """Every case on this rank; the results as NumPy arrays (whole
    volumes, gathered)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from edt_tpu_torch.models import soft
    from edt_tpu_torch.parallel import sharded

    mesh = sharded.default_mesh(device="cpu")
    group = mesh.get_group("sp")
    res = {}

    def full(d):
        return d.full_tensor().numpy()

    def rows_per_rank(d):
        rows = [None] * WORLD
        dist.all_gather_object(rows, d.to_local().shape[0], group=group)
        return np.asarray(rows)

    for shape in SHAPES:
        lab = torch.from_numpy(_labels(shape))
        for bb in BB:
            for binary in (False, True):
                x = (lab != 0).to(torch.uint8) if binary else lab
                for an in ANISOS:
                    out = sharded.edtsq_sharded(x, an, bb, mesh=mesh,
                                                binary=binary)
                    res[_key("edtsq", shape, bb, binary, an)] = full(out)
        res[_key("rows", shape)] = rows_per_rank(out)
        # a DTensor input: its own slabs where axes 0 and 2 divide the
        # ranks, gathered and cut again where they do not
        dt = distribute_tensor(lab, mesh, [Shard(0)])
        res[_key("dtensor", shape)] = full(sharded.edtsq_sharded(
            dt, ANISOS[1], True, mesh=mesh))

    shape, an = AUTO
    lab = torch.from_numpy(_labels(shape))
    for bb in BB:
        out = sharded.edtsq_sharded_auto(lab, an, bb, mesh=mesh)
        res[_key("auto", bb)] = full(out)
        res[_key("auto_dim", bb)] = np.asarray(out.placements[0].dim)

    shape, an = SDF
    lab = torch.from_numpy(_labels(shape))
    for bb in BB:
        res[_key("sdf", bb)] = full(sharded.sdf_sharded(lab, an, bb,
                                                        mesh=mesh))
        res[_key("edt", bb)] = full(sharded.edt_sharded(lab, an, bb,
                                                        mesh=mesh))

    for shape in VG_SHAPES:
        lab, graph = map(torch.from_numpy, _vg_inputs(shape))
        for bb in BB:
            res[_key("vg", shape, bb)] = full(
                sharded.edtsq_voxel_graph_sharded(lab, graph, (1.0, 1.0, 1.0),
                                                  bb, mesh=mesh))

    labels, *_, w = _soft_inputs()
    c = SOFT_SHAPE[0] // WORLD
    sl = slice(rank * c, (rank + 1) * c)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(WORLD)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts).numpy()

    for name, t in SOFT_CASES:
        x = torch.from_numpy(_soft_input(name, t)[sl]).requires_grad_()
        out = _soft_fn(soft, name, t, torch.from_numpy(labels[sl]), group)(x)
        (g,) = torch.autograd.grad((out * torch.from_numpy(w[sl])).sum(), x)
        res[_key(name, t, "out")] = gather(out.detach())
        res[_key(name, t, "grad")] = gather(g)
    return res


def _rank_main(rank, rendezvous, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=WORLD)
    try:
        res = _rank_results(rank)
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks once; their results by case key."""
    tmp = tmp_path_factory.mktemp("sharded")
    out = tmp / "results.npz"
    ctx = mp.spawn(_rank_main, args=(str(tmp / "rendezvous"), str(out)),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    with np.load(out) as z:
        return dict(z)


# ---------------- the JAX side ----------------


@functools.cache
def _jax_mesh():
    import jax

    return jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]), ("sp",))


def _same(got, ref):
    """Bit-exact: the same shape and INF pattern, equal finite values."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[fin], ref[fin])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bb", BB)
def test_edtsq_sharded_matches_jax(ranks, shape, bb):
    import jax
    import jax.numpy as jnp

    from edt_tpu.parallel import edtsq_sharded

    lab = _labels(shape).astype(np.uint32)
    for binary in (False, True):
        x = (lab != 0).astype(np.uint8) if binary else lab
        fn = jax.jit(lambda v, a: edtsq_sharded(  # noqa: B023
            v, a, bb, mesh=_jax_mesh(), binary=binary))  # noqa: B023
        for an in ANISOS:
            ref = fn(jnp.asarray(x), jnp.asarray(an, jnp.float32))
            _same(ranks[_key("edtsq", shape, bb, binary, an)], ref)


def test_sharded_layout_and_dtensor_inputs(ranks):
    """The result's slabs are DTensor's uneven layout (c = ceil(s0 / 4)
    rows a rank, the rest on the last ranks), and a DTensor input gives
    the plain input's result."""
    for shape in SHAPES:
        c = -(-shape[0] // WORLD)
        want = [max(0, min(c, shape[0] - r * c)) for r in range(WORLD)]
        assert ranks[_key("rows", shape)].tolist() == want
        _same(ranks[_key("dtensor", shape)],
              ranks[_key("edtsq", shape, True, False, ANISOS[1])])
    # auto's result is sharded along the input axis of the largest pitch
    assert int(ranks[_key("auto_dim", True)]) == int(np.argmax(AUTO[1]))


@pytest.mark.parametrize("bb", BB)
def test_edtsq_sharded_auto_matches_jax(ranks, bb):
    import jax
    import jax.numpy as jnp

    from edt_tpu.parallel import edtsq_sharded_auto

    shape, an = AUTO
    ref = jax.jit(lambda v: edtsq_sharded_auto(v, an, bb, mesh=_jax_mesh()))(
        jnp.asarray(_labels(shape).astype(np.uint32)))
    _same(ranks[_key("auto", bb)], ref)


@pytest.mark.parametrize("bb", BB)
def test_sdf_and_edt_sharded_match_jax(ranks, bb):
    import jax
    import jax.numpy as jnp

    from edt_tpu.parallel import edt_sharded, sdf_sharded

    shape, an = SDF
    lab = jnp.asarray(_labels(shape).astype(np.uint32))
    for name, fn in (("sdf", sdf_sharded), ("edt", edt_sharded)):
        ref = jax.jit(lambda v: fn(v, an, bb, mesh=_jax_mesh()))(lab)  # noqa: B023
        _same(ranks[_key(name, bb)], ref)


@pytest.mark.parametrize("shape", VG_SHAPES)
@pytest.mark.parametrize("bb", BB)
def test_voxel_graph_sharded_matches_jax(ranks, shape, bb):
    """Axis 0 padded before doubling: black_border's tail plane lies at an
    offset inside an earlier rank's slab."""
    import jax
    import jax.numpy as jnp

    from edt_tpu.parallel import edtsq_voxel_graph_sharded

    lab, graph = _vg_inputs(shape)
    ref = jax.jit(lambda v, g: edtsq_voxel_graph_sharded(
        v, g, (1.0, 1.0, 1.0), bb, mesh=_jax_mesh()))(
            jnp.asarray(lab.astype(np.uint32)), jnp.asarray(graph))
    _same(ranks[_key("vg", shape, bb)], ref)


@pytest.mark.parametrize("name,t", SOFT_CASES)
def test_soft_passes_with_axis_name_match_jax(ranks, name, t):
    import jax
    import jax.numpy as jnp

    from edt_tpu.models import soft as jsoft

    labels, *_, w = _soft_inputs()
    x = _soft_input(name, t)

    def loss(v):
        out = _soft_fn(jsoft, name, t, jnp.asarray(labels.astype(np.uint32)),
                       None)(v)
        return jnp.sum(out * w), out

    (_, ref), rg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x))
    ref, rg = np.asarray(ref), np.asarray(rg)
    out, g = ranks[_key(name, t, "out")], ranks[_key(name, t, "grad")]
    if t == 0.0:
        _same(out, ref)
        rtol = 1e-5
    else:
        assert out.shape == ref.shape and out.dtype == ref.dtype
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))
        rtol = 1e-4
    np.testing.assert_allclose(g, rg, rtol=rtol,
                               atol=rtol * float(np.abs(rg).max() or 1.0))


def test_axis_name_errors():
    """axis_name on a volume that is not 3-D raises ValueError, as in the
    JAX package; one that is not a process group raises TypeError; the
    sharded transforms take 3-D volumes only."""
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.parallel import sharded

    x2 = torch.ones((4, 4))
    lab2 = torch.ones((4, 4), dtype=torch.int32)
    for call in (lambda a: soft.edtsq_from_heights(x2, (1.0, 1.0), False,
                                                   0.0, a),
                 lambda a: soft.soft_edtsq(x2, (1.0, 1.0), False, None, 0.0,
                                           a),
                 lambda a: soft.soft_sdfsq(x2, (1.0, 1.0), False, None, 0.0,
                                           a),
                 lambda a: soft.multilabel_edtsq(lab2, None, None, False,
                                                 None, 0.0, a),
                 lambda a: soft.wall_counts_for(lab2, False, a)):
        with pytest.raises(ValueError, match="3-D"):
            call("sp")
    with pytest.raises(TypeError, match="ProcessGroup"):
        soft.soft_edtsq(torch.ones((4, 4, 4)), (1.0,) * 3, False, None, 0.0,
                        "sp")
    with pytest.raises(ValueError, match="3-D"):
        sharded.edtsq_sharded(lab2, (1.0, 1.0), mesh=None)


def test_minplus_fn_and_wall_counts_positions_match_jax():
    """compose's transforms take ``minplus_fn`` at the JAX package's fourth
    position, and ``wall_counts_for`` takes ``axis_name`` at its third: the
    same positional calls to both packages give the same bits, and the
    given min-plus is the one that runs."""
    import jax
    import jax.numpy as jnp

    import edt_tpu.jax_api as japi
    from edt_tpu.models import soft as jsoft
    from edt_tpu.ops import compose as jcompose
    from edt_tpu.ops import core as jcore

    import edt_tpu_torch.torch_api as tapi
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.ops import compose, core

    m = (np.random.default_rng(0).random((8, 9, 10)) > 0.5).astype(np.uint8)
    an = (1.0, 2.0, 3.0)
    _same(tapi.edtsq(torch.from_numpy(m), an, True, None, True).numpy(),
          jax.jit(lambda v: japi.edtsq(v, an, True, None, True))(
              jnp.asarray(m)))

    calls = []

    def port_minplus(f, start, end, w2, masked):
        calls.append(masked)
        return core.minplus_masked(f, None, w2)

    def jax_minplus(f, start, end, w2, masked):
        return jcore.minplus_masked(f, None, w2)

    lab = _labels((8, 9, 10), nl=3)
    for name, x, tail in (("edtsq", lab, ()), ("edtsq", m, (True,)),
                          ("edt", lab, ()), ("sdfsq", lab, ()),
                          ("sdf", lab, ())):
        ref = jax.jit(lambda v: getattr(jcompose, name)(  # noqa: B023
            v, an, True, jax_minplus, *tail))(jnp.asarray(x))  # noqa: B023
        calls.clear()
        got = getattr(compose, name)(torch.from_numpy(x), an, True,
                                     port_minplus, *tail).numpy()
        _same(got, ref)
        # masked on the multi-label passes, not on the binary ones
        want = [not tail] * 2 + ([False] * 2 if name.startswith("sdf") else [])
        assert calls == want

    got = soft.wall_counts_for(lab, True, None, device="cpu")
    ref = jax.jit(lambda v: jsoft.wall_counts_for(v, True, None))(
        jnp.asarray(lab))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _same(g.numpy(), r)
