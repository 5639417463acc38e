"""The trainers' sharded steps (``edt_tpu_torch.models.distance_net`` and
``.unet3d`` over a (dp, sp) ``DeviceMesh``) against the JAX package's
single-device steps, on four gloo ranks on the CPU.

A module fixture takes the JAX package's ``init_params`` (jitted) as
NumPy, spawns four ranks once (``torch.multiprocessing``, start method
spawn, a file rendezvous under ``tmp_path``), and every rank runs every
case through the kernels' plain versions; rank 0 writes the results, the
rank-local ones gathered. The JAX side is the jitted single-device
``make_train_step`` and ``apply``: ``tests/test_distance_net.py`` and
``tests/test_unet3d.py`` hold JAX's sharded steps equal to them. Shapes
and tolerances are those tests':

- DistanceFieldNet, SGD, on a 2 x 2 mesh: loss rtol 1e-4, parameters
  atol 1e-5;
- the reduce-scatter step (Adam) against the psum step: loss rtol 1e-5,
  parameters atol 1e-6; its moments, gathered in block order
  sp * n_dp + dp, against the psum step's (atol 1e-6) and against the
  flat padded moments of JAX's Adam (the gradients' tolerance, rtol 1e-4
  with atol 1e-4 max|ref|; the second moments square the gradient, 2e-4);
  its second step, which consumes the sharded state, against JAX's second
  step (loss rtol 1e-4, parameters atol 1e-5);
- UNet3D's sharded apply on a 1-D mesh of four: rtol 1e-4, atol 1e-5;
- UNet3D's sharded step (Adam) on 2 x 2: loss rtol 1e-5, parameters rtol
  1e-4, atol 1e-5; the input gradient, through the halo exchange's
  backward, rtol 1e-4 with atol 1e-4 max|grad| (``tests/test_torch_soft.py``
  at t > 0).

jax is imported inside the tests and the fixture only: each spawned rank
imports this module again, and needs torch alone.
"""

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

WORLD = 4
AN = (1.0, 1.0, 1.0)
T = 0.3
DN_SHAPE = (2, 4, 4, 4, 4)  # B, X, Y, Z, C
DN_BARRIER = 192.0  # soft.default_barrier((4, 4, 4), AN)
RS_BARRIER = 12.0
UN_APPLY_SHAPE = (2, 16, 8, 8, 4)
UN_STEP_SHAPE = (2, 8, 4, 4, 4)
UN_BARRIER = 50.0
SPAWN_TIMEOUT_S = 240
ERRORS = ("barrier None, DistanceFieldNet", "barrier None, UNet3D",
          "reduce-scatter with a replicated optimizer", "batch over dp",
          "X over sp", "Z over sp", "UNet3D slab over 2**levels")


def _data(shape, seed):
    """feats (B, X, Y, Z, C) and a target (B, X, Y, Z), as the JAX tests
    draw them."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(shape).astype(np.float32)
    target = (rng.standard_normal(shape[:4]) ** 2).astype(np.float32)
    return feats, target


def _flat_padded(t, n=WORLD):
    flat = np.asarray(t, np.float32).reshape(-1)
    return np.concatenate([flat, np.zeros((-flat.size) % n, np.float32)])


# ---------------- the ranks ----------------


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _gather(x, group=None):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _assemble(blocks, coords, shape):
    """A whole batch from the ranks' (dp, sp) blocks."""
    out = np.zeros(shape, np.float32)
    for blk, (i, j) in zip(blocks, coords):
        b, c = blk.shape[:2]
        out[i * b:(i + 1) * b, j * c:(j + 1) * c] = blk.numpy()
    return out


def _errors(mesh, dn, un, feats, target):
    """The ValueError message of each case in ``ERRORS`` ("" if none)."""
    from edt_tpu_torch.models import distance_net, unet3d

    sgd = torch.optim.SGD(dn.parameters(), 1e-2)
    step = distance_net.make_sharded_train_step(dn, mesh, sgd, AN, T,
                                                DN_BARRIER)
    ustep = unet3d.make_sharded_train_step(
        un, mesh, torch.optim.SGD(un.parameters(), 1e-2), AN, T, UN_BARRIER)
    calls = (
        lambda: distance_net.make_sharded_train_step(dn, mesh, sgd, AN, T),
        lambda: unet3d.make_sharded_train_step(un, mesh, sgd, AN, T),
        lambda: distance_net.make_sharded_train_step(
            dn, mesh, sgd, AN, T, DN_BARRIER, grad_reduce_scatter=True),
        lambda: step(feats[:1], target[:1]),
        lambda: step(feats[:, :3], target[:, :3]),
        lambda: step(feats[..., :3, :], target[..., :3]),
        lambda: ustep(torch.zeros((2, 6, 4, 4, 4)), torch.zeros((2, 6, 4, 4))),
    )
    out = {}
    for name, call in zip(ERRORS, calls):
        try:
            call()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e) or "ValueError"
    return out


def _rank_results(rank, params):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from edt_tpu_torch.models import distance_net, unet3d
    from edt_tpu_torch.parallel import train

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dp", "sp"))
    dp, sp = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    coords = [tuple(int(v) for v in c)
              for c in _gather(torch.tensor([dp, sp]))]
    res = {}

    def dfn(name):
        model = distance_net.DistanceFieldNet(4, 8)
        model.load_state_dict(distance_net.params_from_jax(params[name]))
        return model

    # DistanceFieldNet, the psum step with SGD
    feats, target = (torch.from_numpy(a) for a in _data(DN_SHAPE, 0))
    model = dfn("dn_sgd")
    step = distance_net.make_sharded_train_step(
        model, mesh, torch.optim.SGD(model.parameters(), 1e-2), AN, T,
        DN_BARRIER)
    res["dn_sgd loss"] = float(step(feats, target))
    res["dn_sgd params"] = _state(model)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    res["dn_sgd spread"] = max(float((q - flat).abs().max())
                               for q in _gather(flat))
    whole = train.batch_block(feats, mesh)
    res["dtensor block"] = bool(torch.equal(
        train.batch_block(distribute_tensor(feats, mesh,
                                            [Shard(0), Shard(1)]), mesh),
        whole))

    # the reduce-scatter step against the psum step, Adam
    feats, target = (torch.from_numpy(a) for a in _data(DN_SHAPE, 2))
    model = dfn("dn_adam")
    adam = torch.optim.Adam(model.parameters(), 1e-2)
    step = distance_net.make_sharded_train_step(model, mesh, adam, AN, T,
                                                RS_BARRIER)
    res["psum loss"] = float(step(feats, target))
    res["psum params"] = _state(model)
    res["psum moments"] = [
        [_flat_padded(adam.state[p][k]) for p in model.parameters()]
        for k in ("exp_avg", "exp_avg_sq")]
    model = dfn("dn_adam")
    opt = distance_net.init_sharded_opt_state(
        mesh, lambda ts: torch.optim.Adam(ts, 1e-2), model)
    step = distance_net.make_sharded_train_step(
        model, mesh, opt, AN, T, RS_BARRIER, grad_reduce_scatter=True)
    res["rs loss"] = float(step(feats, target))
    res["rs params"] = _state(model)
    slices = opt.param_groups[0]["params"]
    res["rs moments"] = []
    for k in ("exp_avg", "exp_avg_sq"):
        per_param = []
        for s in slices:
            parts = _gather(opt.state[s][k])
            blocks = [None] * WORLD
            for part, (i, j) in zip(parts, coords):
                blocks[j * 2 + i] = part.numpy()  # sp * n_dp + dp
            per_param.append(np.concatenate(blocks))
        res["rs moments"].append(per_param)
    res["rs loss 2"] = float(step(feats, target))
    res["rs params 2"] = _state(model)

    # UNet3D: the sharded apply on a 1-D sp mesh of four
    mesh1 = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("sp",))
    group = mesh1.get_group("sp")
    r = mesh1.get_local_rank("sp")
    un = unet3d.UNet3D(4, 8, 2)
    un.load_state_dict(unet3d.params_from_jax(params["un_apply"]))
    feats, _ = _data(UN_APPLY_SHAPE, 3)
    c = UN_APPLY_SHAPE[1] // WORLD
    with torch.no_grad():
        out = un(torch.from_numpy(feats[:, r * c:(r + 1) * c]), group)
    res["un apply"] = torch.cat(_gather(out, group), dim=1).numpy()

    # UNet3D: the input gradient and the sharded step, Adam, on 2 x 2
    un = unet3d.UNet3D(4, 8, 1)
    un.load_state_dict(unet3d.params_from_jax(params["un_step"]))
    feats, target = (torch.from_numpy(a) for a in _data(UN_STEP_SHAPE, 4))
    groups = (mesh.get_group("dp"), mesh.get_group("sp"))
    fl = train.batch_block(feats, mesh).clone().requires_grad_(True)
    loss = unet3d.loss_fn(un, fl, train.batch_block(target, mesh), AN, T,
                          UN_BARRIER, groups[1], None, groups)
    (g,) = torch.autograd.grad(loss, fl)
    res["un input grad"] = _assemble(_gather(g), coords, UN_STEP_SHAPE)
    step = unet3d.make_sharded_train_step(
        un, mesh, torch.optim.Adam(un.parameters(), 1e-3), AN, T, UN_BARRIER)
    res["un loss"] = float(step(feats, target))
    res["un params"] = _state(un)

    res["errors"] = _errors(mesh, dfn("dn_sgd"), un,
                            *(torch.from_numpy(a) for a in _data(DN_SHAPE, 0)))
    return res


def _rank_main(rank, rendezvous, params_path, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=WORLD)
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not os.path.exists(params_path):
            if time.monotonic() > deadline:
                raise TimeoutError("no parameters from the JAX package")
            time.sleep(0.05)
        params = np.load(params_path, allow_pickle=True)[0]
        res = _rank_results(rank, params)
        if rank == 0:
            np.save(out, np.asarray([res], dtype=object), allow_pickle=True)
    finally:
        dist.destroy_process_group()


# ---------------- the JAX side ----------------


def _jax_cases():
    """The JAX package's parameters of every case and, from them, its
    jitted single-device results, each case's compiles in a thread of its
    own. Returns (params, a function that computes the results)."""
    import jax
    import jax.numpy as jnp
    import optax

    from edt_tpu.models import distance_net as jdn
    from edt_tpu.models import unet3d as jun

    def init(fn, seed, **kw):
        p = jax.jit(functools.partial(fn, **kw))(jax.random.PRNGKey(seed))
        return jax.tree.map(np.asarray, p)

    inits = {"dn_sgd": (jdn.init_params, 0, dict(c_in=4, hidden=8)),
             "dn_adam": (jdn.init_params, 2, dict(c_in=4, hidden=8)),
             "un_apply": (jun.init_params, 1, dict(c_in=4, c0=8, levels=2)),
             "un_step": (jun.init_params, 2, dict(c_in=4, c0=8, levels=1))}
    with ThreadPoolExecutor(len(inits)) as ex:
        futures = {k: ex.submit(init, fn, seed, **kw)
                   for k, (fn, seed, kw) in inits.items()}
        params = {k: f.result() for k, f in futures.items()}

    def steps(module, optimizer, name, shape, seed, barrier, n):
        step = module.make_train_step(optimizer, anisotropy=AN,
                                      temperature=T, barrier=barrier)
        p, opt_state = params[name], optimizer.init(params[name])
        feats, target = (jnp.asarray(a) for a in _data(shape, seed))
        out = []
        for _ in range(n):
            p, opt_state, loss = step(p, opt_state, feats, target)
            out.append((jax.tree.map(np.asarray, p),
                        jax.tree.map(np.asarray, opt_state), float(loss)))
        return out

    def apply():
        feats, _ = _data(UN_APPLY_SHAPE, 3)
        return np.asarray(jax.jit(jun.apply)(params["un_apply"],
                                             jnp.asarray(feats)))

    def input_grad():
        feats, target = (jnp.asarray(a) for a in _data(UN_STEP_SHAPE, 4))
        grad = jax.jit(jax.grad(
            lambda p, f, t: jun.loss_fn(p, f, t, AN, T, UN_BARRIER),
            argnums=1))
        return np.asarray(grad(params["un_step"], feats, target))

    cases = {
        "dn_sgd": lambda: steps(jdn, optax.sgd(1e-2), "dn_sgd", DN_SHAPE, 0,
                                DN_BARRIER, 1),
        "dn_adam": lambda: steps(jdn, optax.adam(1e-2), "dn_adam", DN_SHAPE,
                                 2, RS_BARRIER, 2),
        "un_apply": apply,
        "un_step": lambda: steps(jun, optax.adam(1e-3), "un_step",
                                 UN_STEP_SHAPE, 4, UN_BARRIER, 1),
        "un_grad": input_grad,
    }

    def results():
        with ThreadPoolExecutor(len(cases)) as ex:
            futures = {k: ex.submit(fn) for k, fn in cases.items()}
            return {k: f.result() for k, f in futures.items()}

    return params, results


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(rank 0's results, the JAX package's): the four ranks spawned once,
    the JAX side computed while they start and run."""
    tmp = tmp_path_factory.mktemp("sharded_models")
    params_path, out = tmp / "params.npy", tmp / "results.npy"
    ctx = mp.spawn(_rank_main, args=(str(tmp / "rendezvous"),
                                     str(params_path), str(out)),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        params, results = _jax_cases()
        np.save(tmp / "params.tmp.npy", np.asarray([params], dtype=object),
                allow_pickle=True)
        os.replace(tmp / "params.tmp.npy", params_path)
        ref = results()
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return np.load(out, allow_pickle=True)[0], ref


def _as_port(module, tree):
    return {k: v.numpy() for k, v in module.params_from_jax(tree).items()}


def _assert_params(got, ref, rtol, atol):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _close_grad(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max() or 1.0))


def test_distance_net_psum_step_matches_jax(both):
    from edt_tpu_torch.models import distance_net

    got, ref = both
    ((params, _, loss),) = ref["dn_sgd"]
    np.testing.assert_allclose(got["dn_sgd loss"], loss, rtol=1e-4)
    _assert_params(got["dn_sgd params"], _as_port(distance_net, params),
                   0.0, 1e-5)


def test_parameters_stay_replicated_and_dtensor_blocks(both):
    """Every rank holds the same parameters after the step, and a DTensor
    placed (Shard(0), Shard(1)) gives the rank the block the whole batch
    gives."""
    got, _ = both
    assert got["dn_sgd spread"] == 0.0
    assert got["dtensor block"]


def test_reduce_scatter_step_matches_psum_step(both):
    got, _ = both
    np.testing.assert_allclose(got["rs loss"], got["psum loss"], rtol=1e-5)
    _assert_params(got["rs params"], got["psum params"], 0.0, 1e-6)
    # the moments gathered in block order sp * n_dp + dp are the psum
    # step's on the flat padded layout (zero-initialised moments hide a
    # block permutation from the parameters, not from these)
    for rs, psum in zip(got["rs moments"], got["psum moments"]):
        for g, r in zip(rs, psum):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=0.0, atol=1e-6)


def test_reduce_scatter_moments_match_jax_adam(both):
    from edt_tpu_torch.models import distance_net

    got, ref = both
    adam = ref["dn_adam"][0][1][0]
    for k, (rs, moment) in enumerate(zip(got["rs moments"],
                                         (adam.mu, adam.nu))):
        want = _as_port(distance_net, moment)  # in the model's order
        for g, r in zip(rs, want.values()):
            _close_grad(g, _flat_padded(r), 1e-4 * (k + 1))


def test_reduce_scatter_second_step_matches_jax(both):
    from edt_tpu_torch.models import distance_net

    got, ref = both
    (p1, _, l1), (p2, _, l2) = ref["dn_adam"]
    np.testing.assert_allclose(got["rs loss"], l1, rtol=1e-4)
    np.testing.assert_allclose(got["rs loss 2"], l2, rtol=1e-4)
    _assert_params(got["rs params"], _as_port(distance_net, p1), 0.0, 1e-5)
    _assert_params(got["rs params 2"], _as_port(distance_net, p2), 0.0,
                   1e-5)


def test_unet3d_sharded_apply_matches_jax(both):
    got, ref = both
    np.testing.assert_allclose(got["un apply"], ref["un_apply"], rtol=1e-4,
                               atol=1e-5)


def test_unet3d_sharded_step_matches_jax(both):
    from edt_tpu_torch.models import unet3d

    got, ref = both
    ((params, _, loss),) = ref["un_step"]
    np.testing.assert_allclose(got["un loss"], loss, rtol=1e-5)
    _assert_params(got["un params"], _as_port(unet3d, params), 1e-4, 1e-5)


def test_unet3d_input_gradient_through_the_halo(both):
    got, ref = both
    _close_grad(got["un input grad"], ref["un_grad"], 1e-4)


@pytest.mark.parametrize("case", ERRORS)
def test_value_errors(both, case):
    """A missing barrier, the reduce-scatter mode without the sharded
    optimizer, a batch, X or Z that does not split over the mesh and a
    UNet3D slab that is not a multiple of 2**levels raise ValueError on
    every rank before any collective."""
    got, _ = both
    assert got["errors"][case], f"{case}: no ValueError"
