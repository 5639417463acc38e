"""The port's spans (``edt_tpu_torch.utils.profiling.span``) on the CPU:
off without a profiler, the tree of one call under one (its passes and
leaves, the backward under the forward pass that saved it), the
transposes' byte counts, the names in the Chrome trace, and results
bit-equal with spans on and off. Sizes of about 12^3."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from edt_tpu_torch import api
from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import compose, minplus
from edt_tpu_torch.utils import export as edt_export
from edt_tpu_torch.utils import profiling

torch.set_num_threads(1)

ANISO = (6.0, 6.0, 30.0)
LEAVES = {"edt_tpu_torch.transpose", "edt_tpu_torch.bounds",
          "edt_tpu_torch.first_pass", "edt_tpu_torch.kernel",
          "edt_tpu_torch.mask"}


def _labels(shape=(12, 13, 14), seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 3, shape).astype(np.int32))


@contextlib.contextmanager
def _profiled():
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof


def _loss(lab, temperature=0.0, occupancy=None):
    occ = ((lab != 0).to(torch.float32) if occupancy is None
           else occupancy).requires_grad_(True)
    out = soft.multilabel_edtsq(lab, occ, ANISO, black_border=True,
                                temperature=temperature,
                                binary_occupancy=occupancy is None)
    (g,) = torch.autograd.grad(out.sum(), occ)
    return out, g


def _children(recs, rid):
    return [r for r in recs if r["parent"] == rid]


def test_no_profiler_leaves_the_registry_empty():
    profiling.reset_spans()
    lab = _labels()
    compose.edtsq(lab, ANISO, True)
    compose.edtsq(lab != 0, ANISO, True, binary=True)
    _loss(lab)
    assert profiling.spans() == []
    assert profiling.span("edt_tpu_torch.x", lab, a=1) is profiling.OFF
    assert profiling.current() is None and not profiling.on()


@pytest.mark.parametrize("binary", [False, True])
def test_edtsq_span_tree(binary):
    lab = _labels() != 0 if binary else _labels()
    with _profiled():
        compose.edtsq(lab, ANISO, True, binary=binary)
    recs = profiling.spans()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "edt_tpu_torch.edtsq"
    assert root["attrs"]["binary"] is binary
    assert {r["call"] for r in recs} == {root["id"]}
    passes = _children(recs, root["id"])
    assert [p["name"] for p in passes] == ["edt_tpu_torch.pass"] * 3
    assert [p["attrs"]["axis"] for p in passes] == [2, 1, 0]
    mode = "binary" if binary else "segment"
    assert [(p["attrs"]["kind"], p["attrs"]["mode"]) for p in passes] == [
        ("closed_form", None), ("K1", mode), ("K1", mode)]
    assert [p["attrs"]["n"] for p in passes] == [14, 13, 12]
    assert all(p["attrs"]["rows"] * p["attrs"]["n"] == lab.numel()
               for p in passes)
    kids = [[c["name"].rsplit(".", 1)[1] for c in _children(recs, p["id"])]
            for p in passes]
    later = ["transpose", "kernel"] if binary else ["transpose", "bounds",
                                                      "kernel"]
    assert kids == [["transpose", "bounds", "first_pass"], later, later]
    leaves = [r for r in recs if not _children(recs, r["id"])]
    assert {r["name"] for r in leaves} <= LEAVES
    assert all(r["ms"] >= 0 for r in recs)


@pytest.mark.parametrize("occupancy", ["binary", "soft"])
def test_loss_span_tree_and_backward_under_its_pass(occupancy):
    lab = _labels()
    occ = None
    if occupancy == "soft":
        occ = torch.from_numpy(np.random.default_rng(4).random(
            lab.shape).astype(np.float32))
    with _profiled():
        _loss(lab, occupancy=occ)
    recs = profiling.spans()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "edt_tpu_torch.multilabel_edtsq"
    assert {r["call"] for r in recs} == {root["id"]}
    kids = _children(recs, root["id"])
    assert [k["name"] for k in kids] == ["edt_tpu_torch.pass"] * 3 + [
        "edt_tpu_torch.mask"]
    passes = kids[:3]
    first = "closed_form" if occupancy == "binary" else "K2"
    assert [p["attrs"]["kind"] for p in passes] == [first, "K2", "K2"]
    assert [p["attrs"]["axis"] for p in passes] == [1, 0, 2]
    by_id = {r["id"]: r for r in recs}
    backs = [r for r in recs if r["name"] == "edt_tpu_torch.backward"]
    # one backward a pass, last pass first, each under the pass that saved it
    assert [by_id[b["parent"]]["id"] for b in backs] == [
        p["id"] for p in reversed(passes)]
    for p in passes:
        names = [c["name"].rsplit(".", 1)[1] for c in _children(recs, p["id"])]
        work = "first_pass" if p["attrs"]["kind"] == "closed_form" else "kernel"
        assert names == ["bounds", "transpose", work, "backward"]
    kernels = [[c["attrs"].get("kernel") for c in _children(recs, b["id"])]
               for b in backs]
    last = "K4" if occupancy == "binary" else "K3"
    assert kernels == [[None, "K3"], [None, "K3"], [None, last]]


def test_soft_passes_have_their_root_and_k5_k6():
    lab = _labels((8, 9, 10))
    occ = torch.from_numpy(np.random.default_rng(5).random(
        lab.shape).astype(np.float32)).requires_grad_(True)
    with _profiled():
        out = soft.soft_edtsq(occ, (1.0, 2.0, 3.0), True, temperature=0.3)
        torch.autograd.grad(out.sum(), occ)
    recs = profiling.spans()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "edt_tpu_torch.multilabel_edtsq"
    assert root["attrs"]["temperature"] == 0.3
    kinds = [r["attrs"]["kernel"] for r in recs
             if r["name"] == "edt_tpu_torch.kernel"]
    assert kinds == ["K5"] * 3 + ["K6"] * 3
    assert {r["call"] for r in recs} == {root["id"]}


def test_transpose_bytes_count_each_copy_made():
    lab = _labels()
    with _profiled():
        compose.edtsq(lab, ANISO, True)
    moves = [r["attrs"]["bytes"] for r in profiling.spans()
             if r["name"] == profiling.TRANSPOSE]
    n = lab.numel()
    # axis 2 is last already; axes 1 and 0 copy f (f32) and the labels
    assert moves == [0, 2 * n * 4 * 2, 2 * n * 4 * 2]
    x = torch.arange(24, dtype=torch.int16).reshape(2, 3, 4)
    with _profiled():
        a, b = profiling.contiguous(x, x.movedim(0, -1))
        (c,) = profiling.contiguous(x.movedim(2, -1))
    assert a is x and b.is_contiguous() and torch.equal(b, x.movedim(0, -1))
    assert c.data_ptr() == x.data_ptr()  # a view that is contiguous
    assert [r["attrs"]["bytes"] for r in profiling.spans()] == [2 * 24 * 2, 0]


def test_chrome_trace_holds_the_span_names(tmp_path, capsys):
    lab = _labels()
    profiling.reset_spans()
    with profiling.trace(str(tmp_path)):
        compose.edtsq(lab, ANISO, True)
        _loss(lab)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        names = {str(e.get("name")) for e in json.load(fh)["traceEvents"]}
    spans = {r["name"] for r in profiling.spans()}
    assert spans <= names
    assert {"edt_tpu_torch.edtsq", "edt_tpu_torch.multilabel_edtsq",
            "edt_tpu_torch.pass", "edt_tpu_torch.backward"} <= spans
    assert all(s.startswith("edt_tpu_torch.") for s in spans)
    # the custom ops' namespace holds the ops alone, never a span
    ops = {n for n in names if n.startswith("edt_tpu_torch::")}
    assert ops and all(n.split("::")[1] in {
        "minplus_walls", "minplus_argmin", "minplus_grad",
        "binary_grad_scan"} for n in ops)


@pytest.mark.parametrize("case", ["edtsq", "binary", "loss", "soft_loss"])
def test_results_bit_equal_with_spans_on_and_off(case):
    lab = _labels(seed=6)

    def run():
        if case == "edtsq":
            return (compose.edtsq(lab, ANISO, False),)
        if case == "binary":
            return (compose.edtsq(lab != 0, ANISO, True, binary=True),)
        return _loss(lab, 0.3 if case == "soft_loss" else 0.0)

    off = run()
    with _profiled():
        on = run()
    assert profiling.spans()
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_api_call_has_its_stages():
    labels = _labels().numpy().astype(np.uint16)
    with _profiled():
        got = api.edtsq(labels, ANISO, True, device="cpu")
    recs = profiling.spans()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "edt_tpu_torch.api"
    kids = _children(recs, root["id"])
    assert [k["name"] for k in kids] == [
        "edt_tpu_torch.api.copy_in", "edt_tpu_torch.api.transform",
        "edt_tpu_torch.api.copy_out"]
    # the card's labels: uint16 widened as the API widens it
    assert kids[0]["attrs"]["bytes"] == api._as_device_labels(labels).nbytes
    assert kids[2]["attrs"]["bytes"] == got.nbytes
    (inner,) = _children(recs, kids[1]["id"])
    assert inner["name"] == "edt_tpu_torch.edtsq"
    assert {r["call"] for r in recs} == {root["id"]}


def test_export_under_a_profiler_records_no_span():
    with _profiled():
        program = edt_export.export_transform((6, 7, 8), np.uint16,
                                              anisotropy=(1, 2, 3),
                                              device="cpu")
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and str(n.target) == "edt_tpu_torch.minplus_walls.default"]
    assert len(nodes) == 2
    assert profiling.spans() == []


def test_two_calls_get_their_own_call_ids_and_reset_empties():
    lab = _labels((6, 7, 8))
    with _profiled():
        compose.edtsq(lab, ANISO, True)
        compose.edtsq(lab, ANISO, True)
    roots = [r for r in profiling.spans() if r["parent"] is None]
    assert len(roots) == 2
    calls = [r["call"] for r in profiling.spans()]
    assert calls == sorted(calls) and set(calls) == {r["id"] for r in roots}
    profiling.reset_spans()
    assert profiling.spans() == []


def test_k1_mode_names_the_kernel_instantiation():
    assert minplus.k1_mode(512, True) == "segment"
    assert minplus.k1_mode(minplus.SEGMENT_FLOOR_AXIS + 1, True) == "row"
    assert minplus.k1_mode(512, False) == "binary"
    assert minplus.k1_mode(minplus.MAX_AXIS + 1, True) == "long"


@pytest.mark.cuda
def test_card_spans_are_timed_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' CUDA events time the card")
    lab = _labels((64, 64, 64)).cuda()
    _loss(lab)
    with _profiled():
        _loss(lab)
    recs = profiling.spans(sync=True)
    assert recs and all(r["ms"] is not None and r["ms"] >= 0 for r in recs)
    (root,) = [r for r in recs if r["parent"] is None]
    backs = [r for r in recs if r["name"] == "edt_tpu_torch.backward"]
    assert len(backs) == 3 and all(b["call"] == root["id"] for b in backs)
