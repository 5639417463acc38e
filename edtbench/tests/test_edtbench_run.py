"""The harness driven end to end on the CPU at test sizes: the result line's
keys, the metrics each cell reports, and ``correct`` coming out false
under each fault the cells can have, planted in the program's call."""

import functools
import json
import types

import pytest
import torch
import torch.distributed as dist

from edtbench import ranks, run, spec
from conftest import FOUR_CARD, ROOT

LISTED = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CELLS = LISTED + [FOUR_CARD]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CPU = torch.device("cpu")


def _run(cell, trace=0, seed=2 ** 31 + 11, seconds=0.3, target=None):
    """A run on the CPU: one process, or a gloo rank a chip the cell asks
    for (this process rank 0)."""
    if cell.chips == 1:
        return run.run_cell(cell, seed, seconds, trace, CPU,
                            setup_clock=lambda: 1.0)
    job = functools.partial(run.rank_job, seed=seed, seconds=seconds,
                            trace=trace)
    return ranks.launch(cell.root, cell.name, cell.chips, job, backend="gloo",
                        device_type="cpu", config=cell.config,
                        target=target or ranks.worker)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_has_the_contract_keys(tiny_cell, name, trace):
    cell = tiny_cell(name)
    result, lines = _run(cell, trace)
    line = json.loads(json.dumps(result))
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["device"]["count"] == cell.chips
    want = {m.name for m in cell.metrics if m.end_to_end != bool(trace)}
    assert set(line["metrics"]) <= want
    if not trace:  # a CPU run has no device trace, but every end-to-end metric
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["checks"]) == set(cell.traffic["limits"])
    assert len(lines) == len(line["checks"])


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", LISTED[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_run_refuses_a_process_that_holds_jax(tiny_cell, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    with pytest.raises(SystemExit, match="jax"):
        _run(tiny_cell("cube511.fwd"))


def _plant(monkeypatch, fault, loop):
    """Break the program's call underneath the harness."""
    if loop == "fwd":
        from edt_tpu_torch import torch_api
        real, target, attr = torch_api.edtsq, torch_api, "edtsq"
    else:
        from edt_tpu_torch.models import soft
        real, target, attr = soft.multilabel_edtsq, soft, "multilabel_edtsq"
    first = {}

    def broken(vol, *args, **kw):
        if fault == "stale" and loop == "fwd":
            # every call answers the first call's input
            first.setdefault("out", real(vol, *args, **kw))
            return first["out"].clone()
        if fault == "stale":
            occ = args[0]
            first.setdefault("occ", occ.detach().clone())
            # the first step's occupancy, the gradient still reaching occ
            return real(vol, occ + (first["occ"] - occ).detach(), *args[1:], **kw)
        out = real(vol, *args, **kw)
        if fault == "half":  # the second half of the rows left out
            keep = torch.ones_like(out)
            keep[out.shape[0] // 2:] = 0
            return out * keep
        flip = torch.zeros(out.shape, dtype=out.dtype)  # one answer altered
        flip.view(-1)[out.numel() // 3] = 1.0
        return out + flip

    monkeypatch.setattr(target, attr, broken)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_program_is_not_correct(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    _plant(monkeypatch, fault, cell.traffic["loop"])
    result, lines = _run(cell)
    assert result["correct"] is False and result["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def test_kept_calls_are_drawn_from_the_seed(tiny_cell):
    from edtbench import loops

    a = loops.make(tiny_cell("ml512.fwd"), 7, CPU)
    b = loops.make(tiny_cell("ml512.fwd"), 7, CPU)
    c = loops.make(tiny_cell("ml512.fwd"), 8, CPU)
    assert a.plan == b.plan and torch.equal(a.pos, b.pos)
    assert torch.equal(a.vol, b.vol) and not torch.equal(a.pos, c.pos)
    assert a.plan[-1] == -1 and all(0 <= k < 32 for k in a.plan[:-1])
    # every cleared voxel is foreground, so each call's answer differs
    assert bool((a.vol.reshape(-1)[a.pos] != 0).all())


def test_every_cell_is_listed(tiny_cell):
    assert set(LISTED) == set(spec.load(ROOT))
    assert tiny_cell(FOUR_CARD).chips == 4


def _no_exchange(x, group, split_axis, concat_axis):
    """The program's all-to-all with the exchange left out: each rank keeps
    its own blocks where the others' should arrive."""
    n = dist.get_world_size(group)
    send = x.movedim(split_axis, 0)
    send = send.reshape(n, send.shape[0] // n, *send.shape[1:])
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return send.movedim(1, split_axis + 1).movedim(0, concat_axis).reshape(shape)


def _plant_no_exchange(patch):
    from edt_tpu_torch.models import soft
    from edt_tpu_torch.parallel import sharded

    patch(sharded, "all_to_all", _no_exchange)
    patch(soft, "all_to_all", _no_exchange)


def no_exchange_worker(*args):
    """A spawned rank whose program leaves the exchange out."""
    _plant_no_exchange(setattr)
    ranks.worker(*args)


def test_a_left_out_exchange_is_not_correct(tiny_cell, monkeypatch):
    _plant_no_exchange(monkeypatch.setattr)
    result, _ = _run(tiny_cell(FOUR_CARD), target=no_exchange_worker)
    assert result["correct"] is False and result["failed"] >= 1
