"""The NumPy API's auto-sharding over several devices of one process
(``edt_tpu_torch.parallel.local``) against the JAX package on the CPU.

The port's single controller runs over four ``cpu`` slabs (the same
device four times: the slab code, the exchange and the crop are those of
four cards); the JAX side runs over a mesh of four of conftest's eight
virtual CPU devices, jitted. Transforms are bit-exact (equal finite
values, the same INF pattern); the voxel graph is held to JAX's own test
tolerance (``tests/test_sharded.py``, ``np.allclose`` on the finite
values). The API's gate (``_shard_devices``, ``_shard_min_voxels``) is
driven with ``EDT_TPU_SHARD_MIN_VOXELS`` and monkeypatched devices.
"""

import functools

import numpy as np
import pytest
import torch

from edt_tpu_torch import api
from edt_tpu_torch.parallel import local
from edt_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

WORLD = 4
CPUS = [torch.device("cpu")] * WORLD
# host axis 0 is the sharded axis, the middle pass's, the closed form's
ANISOS = ((4.0, 1.0, 2.0), (6.0, 6.0, 30.0), (1.0, 2.0, 4.0))
ENV = "EDT_TPU_SHARD_MIN_VOXELS"


def _labels(shape, nl=4):
    return np.random.default_rng(sum(shape)).integers(
        0, nl, size=shape).astype(np.uint32)


def _vg_inputs(shape):
    rng = np.random.default_rng(shape[0])
    labels = rng.integers(0, 3, size=shape).astype(np.uint32)
    return labels, rng.integers(0, 64, size=shape).astype(np.uint8)


def _same(got, ref):
    """Bit-exact: the same shape and INF pattern, equal finite values."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[fin], ref[fin])


def _close(got, ref):
    """JAX's tolerance for its sharded voxel graph: the same INF pattern,
    ``np.allclose`` on the finite values."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.allclose(got[fin], ref[fin])


@functools.cache
def _jax_mesh():
    import jax

    return jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]), ("sp",))


@pytest.fixture
def four_cpu_slabs(monkeypatch):
    """The API's gate opened at any size, over four ``cpu`` slabs."""
    monkeypatch.setenv(ENV, "1")
    monkeypatch.setattr(api, "_shard_devices", lambda device: CPUS)
    counters.reset()


@pytest.mark.parametrize("shape", [(16, 16, 16), (17, 9, 14)])
@pytest.mark.parametrize("bb", [True, False])
def test_local_edtsq_matches_jax_sharded_auto(shape, bb):
    """Multi-label and binary, host axis 0 at each place of the pass
    order (re-cut on the cards where it is not the sharded axis);
    (17, 9, 14) pads every sharded and rotated axis."""
    import jax
    import jax.numpy as jnp

    from edt_tpu.parallel import edtsq_sharded_auto

    lab = _labels(shape)
    for binary in (False, True):
        x = (lab != 0).astype(np.uint8) if binary else lab
        for an in ANISOS:
            ref = jax.jit(lambda v: edtsq_sharded_auto(  # noqa: B023
                v, an, bb, mesh=_jax_mesh(), binary=binary))(  # noqa: B023
                    jnp.asarray(x))
            got = local.edtsq_sharded_local(
                api._as_device_labels(x), an, bb, binary=binary,
                devices=CPUS)
            _same(got, ref)


@pytest.mark.parametrize("shape", [(9, 6, 7), (16, 8, 12)])
@pytest.mark.parametrize("bb", [True, False])
def test_local_voxel_graph_matches_jax(shape, bb):
    """Axis 0 padded before doubling on (9, 6, 7): black_border's tail
    plane lies inside an earlier slab."""
    import jax
    import jax.numpy as jnp

    from edt_tpu.parallel import edtsq_voxel_graph_sharded

    lab, graph = _vg_inputs(shape)
    an = (2.0, 1.0, 1.5)
    ref = jax.jit(lambda v, g: edtsq_voxel_graph_sharded(
        v, g, an, bb, mesh=_jax_mesh()))(jnp.asarray(lab), jnp.asarray(graph))
    got = local.edtsq_voxel_graph_sharded_local(
        (lab != 0).astype(np.uint8), graph, an, bb, devices=CPUS)
    _close(got, ref)


@pytest.mark.parametrize("case", ["multi-label", "bool", "F order"])
def test_api_dispatch_shards_bit_exact(monkeypatch, case):
    """api.edtsq past the threshold goes to the single controller once,
    bit-equal to the unsharded port call and to the JAX API."""
    import edt_tpu

    monkeypatch.delenv(ENV, raising=False)
    lab = _labels((17, 9, 14))
    if case == "bool":
        lab = lab != 0
    elif case == "F order":
        lab = np.asfortranarray(lab)
    an = (4.0, 1.0, 2.0)
    want = api.edtsq(lab, an, True, device="cpu")
    jax_want = edt_tpu.edtsq(lab, anisotropy=an, black_border=True)
    monkeypatch.setenv(ENV, "1")
    monkeypatch.setattr(api, "_shard_devices", lambda device: CPUS)
    counters.reset()
    got = api.edtsq(lab, an, True, device="cpu")
    assert counters.sharded_dispatches == 1
    _same(got, want)
    _same(got, jax_want)
    assert got.flags.f_contiguous == (case == "F order")


def test_api_sdf_and_edt_shard(monkeypatch):
    """``sdf`` and ``edt`` inherit the dispatch through ``edtsq``: two
    sharded calls a signed field."""
    monkeypatch.delenv(ENV, raising=False)
    lab = _labels((13, 10, 12), nl=2)
    want_sdf = api.sdf(lab, (1.0, 2.0, 3.0), True, device="cpu")
    want_edt = api.edt(lab, (1.0, 2.0, 3.0), False, device="cpu")
    monkeypatch.setenv(ENV, "1")
    monkeypatch.setattr(api, "_shard_devices", lambda device: CPUS)
    counters.reset()
    _same(api.sdf(lab, (1.0, 2.0, 3.0), True, device="cpu"), want_sdf)
    assert counters.sharded_dispatches == 2
    _same(api.edt(lab, (1.0, 2.0, 3.0), False, device="cpu"), want_edt)
    assert counters.sharded_dispatches == 3


def test_api_voxel_graph_shards_on_the_doubled_size(monkeypatch):
    """The voxel graph's gate is data.size * 8: a volume of v voxels
    shards at the threshold 8 v, not at 8 v + 1. C and F order,
    against the unsharded port call and the JAX API at JAX's tolerance."""
    import edt_tpu

    lab, graph = _vg_inputs((9, 6, 7))
    an = (2.0, 1.0, 1.0)
    monkeypatch.delenv(ENV, raising=False)
    want = api.edtsq(lab, an, True, voxel_graph=graph, device="cpu")
    jax_want = edt_tpu.edtsq(lab, anisotropy=an, black_border=True,
                             voxel_graph=graph)
    monkeypatch.setattr(api, "_shard_devices", lambda device: CPUS)
    counters.reset()
    monkeypatch.setenv(ENV, str(lab.size * 8 + 1))
    api.edtsq(lab, an, True, voxel_graph=graph, device="cpu")
    assert counters.sharded_dispatches == 0
    monkeypatch.setenv(ENV, str(lab.size * 8))
    got = api.edtsq(lab, an, True, voxel_graph=graph, device="cpu")
    assert counters.sharded_dispatches == 1
    _same(got, want)
    _close(got, jax_want)
    labf, gf = np.asfortranarray(lab), np.asfortranarray(graph)
    got_f = api.edtsq(labf, an, True, voxel_graph=gf, device="cpu")
    assert counters.sharded_dispatches == 2 and got_f.flags.f_contiguous
    monkeypatch.delenv(ENV)
    _same(got_f, api.edtsq(labf, an, True, voxel_graph=gf, device="cpu"))


def test_shard_devices_gate(monkeypatch):
    """None where the caller pinned a device, with fewer than two cards,
    and under a torch.distributed group of more than one rank; else every
    card."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert api._shard_devices(None) == cards
    assert api._shard_devices("cuda:1") is None
    assert api._shard_devices("cpu") is None
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    assert api._shard_devices(None) is None
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    assert api._shard_devices(None) == cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert api._shard_devices(None) is None


def test_shard_min_voxels_default_and_override(monkeypatch):
    """The JAX package's default, 600^3, and its environment variable."""
    monkeypatch.delenv(ENV, raising=False)
    assert api._shard_min_voxels() == 600 ** 3
    monkeypatch.setenv(ENV, "12345")
    assert api._shard_min_voxels() == 12345


def test_below_threshold_and_low_dimensions_stay_on_one_device(
        four_cpu_slabs, monkeypatch):
    """One voxel under the threshold, and 2-D volumes at any size, take
    the single-device path."""
    lab = _labels((8, 8, 8))
    monkeypatch.setenv(ENV, str(lab.size + 1))
    api.edtsq(lab, device="cpu")
    monkeypatch.setenv(ENV, "1")
    api.edtsq(_labels((12, 12)), device="cpu")
    assert counters.sharded_dispatches == 0
    api.edtsq(lab, device="cpu")
    assert counters.sharded_dispatches == 1


def test_peer_exchange_is_tiled_all_to_all():
    """Block j of slab i lands on slab j at position i of the concat axis,
    as ``lax.all_to_all(tiled=True)`` orders it."""
    x = torch.arange(4 * 3 * 8).reshape(4, 3, 8)
    slabs = list(x.tensor_split(2, 0))  # two slabs of 2 rows
    rotated = local.peer_exchange([torch.device("cpu")] * 2)(slabs, 2, 0)
    # slab j holds columns [4 j, 4 j + 4) of every row, rows in slab order
    for j, r in enumerate(rotated):
        assert torch.equal(r, x[:, :, 4 * j:4 * j + 4])
    back = local.peer_exchange([torch.device("cpu")] * 2)(rotated, 0, 2)
    for s, b in zip(slabs, back):
        assert torch.equal(s, b)
