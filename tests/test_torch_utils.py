"""edt_tpu_torch's utils on the CPU: checkpointing, export with K1 as a
custom op, and the profiling helpers, against edt_tpu where it has the
same function. Inputs are made from a seed with numpy.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from edt_tpu.ops import compose as jcompose
from edt_tpu_torch import api
from edt_tpu_torch.models import distance_net
from edt_tpu_torch.ops import compose, core, minplus
from edt_tpu_torch.utils import checkpoint as ckpt
from edt_tpu_torch.utils import export as edt_export
from edt_tpu_torch.utils import profiling

torch.set_num_threads(1)

OP = "edt_tpu_torch.minplus_walls.default"


def _op_nodes(program):
    return [n for n in program.graph.nodes
            if n.op == "call_function" and str(n.target) == OP]


def _model_and_opt(seed):
    model = distance_net.DistanceFieldNet(
        4, 8, generator=torch.Generator().manual_seed(seed), device="cpu")
    opt = torch.optim.Adam(model.parameters(), 1e-2)
    return model, opt


def _adam_step(model, opt, x):
    opt.zero_grad(set_to_none=True)
    loss = (model(x) ** 2).mean()
    loss.backward()
    opt.step()
    return float(loss.detach())


def test_manager_round_trip_and_retention(tmp_path):
    model, opt = _model_and_opt(0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, 4), dtype=np.float32))
    mgr = ckpt.Manager(str(tmp_path / "run"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({})
    saved = {}
    for step in range(4):
        _adam_step(model, opt, x)
        state = {"params": model.state_dict(), "opt_state": opt.state_dict(),
                 "step": step, "note": "adam"}
        mgr.save(step, state)
        saved[step] = {k: v.clone() for k, v in model.state_dict().items()}
    assert mgr.latest_step() == 3 and mgr.steps() == [2, 3]
    assert sorted(os.listdir(mgr.directory)) == [
        "ckpt_000000000002.pt", "ckpt_000000000003.pt"]
    for step in (2, None):
        fresh, fresh_opt = _model_and_opt(1)
        template = {"params": fresh.state_dict(),
                    "opt_state": fresh_opt.state_dict()}
        got = mgr.restore(template, step=step)
        want = saved[3 if step is None else step]
        assert got["step"] == (3 if step is None else step)
        assert got["note"] == "adam"
        for k, v in want.items():
            assert torch.equal(got["params"][k], v)
            assert got["params"][k].device == template["params"][k].device


def test_resume_continues_training_exactly(tmp_path):
    """Save mid-run, restore into fresh objects, and the next step's loss
    and parameters equal those of the run that went on."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 4), dtype=np.float32))
    model, opt = _model_and_opt(2)
    for _ in range(3):
        _adam_step(model, opt, x)
    mgr = ckpt.Manager(str(tmp_path / "run"))
    mgr.save(3, {"params": model.state_dict(), "opt_state": opt.state_dict()})
    fresh, fresh_opt = _model_and_opt(3)
    state = mgr.restore({"params": fresh.state_dict(),
                         "opt_state": fresh_opt.state_dict()})
    fresh.load_state_dict(state["params"])
    fresh_opt.load_state_dict(state["opt_state"])
    assert _adam_step(fresh, fresh_opt, x) == _adam_step(model, opt, x)
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)


def test_minplus_op_matches_plain_and_is_the_default():
    rng = np.random.default_rng(2)
    f = torch.from_numpy((rng.random((6, 40)) * 50).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 3, (6, 40)).astype(np.int32))
    f = torch.where(lab == 0, 0.0, f)
    ss, se = core.segment_bounds(lab)
    for masked in (False, True):
        for bb in (False, True):
            args = (ss, se) if masked else (None, None)
            got = torch.ops.edt_tpu_torch.minplus_walls(f, *args, 1.69, bb,
                                                        masked)
            want = minplus.minplus_walls_plain(f, *args, 1.69, bb, masked)
            assert torch.equal(got, want)
    before = minplus.launches
    fn = minplus.make_parabolic_fn()
    program = edt_export.export_fn(lambda a, b: fn(a, b, 1.69, True, False),
                                   f, lab)
    assert len(_op_nodes(program)) == 1
    assert minplus.launches == before  # CPU tensors run the plain version


@pytest.mark.parametrize("case", ["multilabel", "binary-sqrt"])
def test_export_round_trip_bit_equal(case):
    rng = np.random.default_rng(5 if case == "multilabel" else 6)
    if case == "multilabel":
        labels = rng.integers(0, 4, size=(12, 13, 14)).astype(np.uint32)
        kw = dict(anisotropy=(2.0, 1.0, 3.0), black_border=True)
        data = edt_export.serialize_transform(labels.shape, np.uint32,
                                              device="cpu", **kw)
        assert isinstance(data, bytes) and len(data) > 0
        run = edt_export.load(data)
        x = torch.from_numpy(labels.view(np.int32))
        want = compose.edtsq(x, kw["anisotropy"], True)
        jax_want = np.asarray(jcompose.edtsq(
            jnp.asarray(labels), jnp.asarray(kw["anisotropy"], jnp.float32),
            True))
    else:
        labels = (rng.random((10, 11, 12)) > 0.5).astype(np.uint8)
        program = edt_export.export_transform(
            labels.shape, np.uint8, binary=True, sqrt=True, black_border=True,
            device="cpu")
        assert len(_op_nodes(program)) == 2
        run = edt_export.load(program)
        x = torch.from_numpy(labels)
        want = torch.sqrt(compose.edtsq(x, (1.0, 1.0, 1.0), True,
                                        binary=True))
        jax_want = np.sqrt(np.asarray(jcompose.edtsq(
            jnp.asarray(labels), jnp.ones(3, jnp.float32), True,
            binary=True)))
    got = run(x)
    assert got.dtype == torch.float32 and got.shape == labels.shape
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), jax_want)


def test_export_records_k1_twice_and_maps_label_dtypes():
    program = edt_export.export_transform((6, 7, 8), np.uint16,
                                          anisotropy=(1, 2, 3), device="cpu")
    assert len(_op_nodes(program)) == 2
    assert program.example_inputs is None  # no volume saved with the graph
    # The program takes what the NumPy API passes for the same labels.
    labels = np.random.default_rng(8).integers(
        0, 40000, (6, 7, 8)).astype(np.uint16)
    x = torch.from_numpy(api._as_device_labels(labels))
    assert torch.equal(edt_export.load(program)(x),
                       compose.edtsq(x, (1.0, 2.0, 3.0), False))


def test_export_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edt_export.export_transform((4, 4, 4))


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.from_numpy(np.random.default_rng(7).integers(
        0, 3, (8, 9, 10)).astype(np.int32))
    with profiling.trace(str(tmp_path / "trace")):
        compose.edtsq(x, (1.0, 1.0, 1.0), True)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("minplus_walls" in str(e.get("name")) for e in events)
