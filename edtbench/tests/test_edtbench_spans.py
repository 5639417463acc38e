"""The ``program_span`` readers on the CPU at test sizes: a traced run of
each cell reports the span metrics that list it, an untraced one none; two
traced runs in one process read their own calls; the four-rank cell's
traced run records each rotation with its copies and its exchange."""

import json

import pytest

from conftest import FOUR_CARD, ROOT
from edtbench import run, spans
from edt_tpu_torch.utils import profiling
from test_edtbench_run import CELLS, CPU, _run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"
                and not m["name"].startswith("loss.")]


def _listed(name):
    """The span metrics a cell reports (the four-card cell: the loss's)."""
    cell = "ml512.loss" if name == FOUR_CARD else name
    return {m["name"] for m in SPAN_METRICS if cell in m["workloads"]}


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_its_span_metrics(tiny_cell, name):
    cell = tiny_cell(name)
    want = _listed(name)
    assert len(want) == 4
    result, _ = _run(cell, trace=1)
    got = result["metrics"]
    assert want <= set(got), sorted(want - set(got))
    for m in want:
        assert got[m]["value"] >= 0
    roof = [m for m in want if m.startswith("transpose_roofline")]
    assert all(0 < got[m]["value"] <= 100 for m in roof)
    untraced, _ = _run(cell, trace=0)
    assert not want & set(untraced["metrics"])


def test_readers_give_none_without_a_trace_or_enough_calls():
    class Rec:
        trace, calls = None, 3

    assert spans.window(Rec) is None
    Rec.trace, Rec.calls = object(), 10 ** 9
    assert spans.window(Rec) is None
    assert spans.ms_a_call(Rec, spans.TRANSPOSE) is None


def test_two_traced_runs_in_one_process_read_their_own_calls(tiny_cell):
    cell = tiny_cell("ml512.fwd")
    profiling.reset_spans()
    first, _ = run.run_cell(cell, 11, 0.2, 1, CPU, setup_clock=lambda: 1.0)
    before = {r["call"] for r in profiling.spans()}
    second, _ = run.run_cell(cell, 12, 0.4, 1, CPU, setup_clock=lambda: 1.0)

    class Rec:
        trace, calls = True, second["attempted"]

    recs = spans.window(Rec)
    calls = {r["call"] for r in recs}
    assert len(calls) == second["attempted"] and not calls & before
    assert len(before) == first["attempted"]
    got = second["metrics"]["transpose_ms.fwd"]["value"]
    mine = sum(r["ms"] for r in recs if r["name"] == spans.TRANSPOSE)
    assert got == pytest.approx(mine / second["attempted"])


def test_the_four_rank_run_records_its_rotations(tiny_cell):
    profiling.reset_spans()
    result, _ = _run(tiny_cell(FOUR_CARD), trace=1)
    assert _listed(FOUR_CARD) <= set(result["metrics"])
    recs = profiling.spans()  # rank 0's, this process
    rotations = [r for r in recs if r["name"] == "edt_tpu_torch.rotate"]
    # a step: f there and back, the labels there, the backward's two
    assert len(rotations) == 5 * result["attempted"]
    for r in rotations:
        kids = [k["name"] for k in recs if k["parent"] == r["id"]]
        assert kids == [profiling.TRANSPOSE, "edt_tpu_torch.exchange",
                        profiling.TRANSPOSE]
        assert r["attrs"]["ranks"] == 4
    ex = [r for r in recs if r["name"] == "edt_tpu_torch.exchange"]
    assert all(e["attrs"]["bytes"] > 0 for e in ex)
    roots = {r["call"] for r in recs if r["parent"] is None}
    assert {r["call"] for r in rotations} <= roots
