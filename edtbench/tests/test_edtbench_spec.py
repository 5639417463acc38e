"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files; a new cell, traffic mix or metric needs new files
and entries only."""

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from conftest import ROOT, shrink
from edtbench import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = ["command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"]


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert list(b) == TOP
    assert b["paths"] == ["edtbench"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(b["end_to_end"]) <= 16
    # a full check of 24 cells fits its 43200 s
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (b["run_seconds"] + 60)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("edtbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", ())) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "bound" not in m
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_resolves_to_its_files():
    cells = spec.load(ROOT)
    assert set(cells) == {w["name"] for w in _bench()["workloads"]}
    for cell in cells.values():
        e2e = [m.name for m in cell.metrics if m.end_to_end]
        layer = [m.name for m in cell.metrics if not m.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, cell.name
        assert cell.traffic["loop"] in ("fwd", "loss")
        assert set(cell.traffic["limits"]), cell.name
        for m in cell.metrics:
            assert callable(m.read)


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A dummy cell with its own configuration, traffic mix and per-layer
    metric, added as files and entries beside a copy of the benchmark,
    resolves and runs, and no file of the copy changed."""
    shutil.copytree(ROOT / "edtbench", tmp_path / "edtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "edtbench").rglob("*")
              if p.is_file()}
    b = _bench()
    cfg = json.loads((ROOT / "edtbench/configs/bin_cube511_iso.json").read_text())
    cfg.update(name="dummy_cube", anisotropy=[1.0, 2.0, 3.0])
    (tmp_path / "edtbench/configs/dummy_cube.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "edtbench/traffic/fwd.json").read_text())
    traffic["cleared_voxels"] = 3
    (tmp_path / "edtbench/traffic/dummy.json").write_text(json.dumps(traffic))
    (tmp_path / "edtbench/metrics/dummy_calls.py").write_text(
        "def read(rec):\n    return rec.calls\n")
    b["configs"].append({"name": "dummy_cube", "source": cfg["source"],
                         "file": "edtbench/configs/dummy_cube.json",
                         "reduced": [], "why": "a test's cell"})
    b["workloads"].append({"name": "dummy.fwd", "config": "dummy_cube",
                           "traffic": "dummy", "chips": 1, "why": "a test's cell"})
    for m in b["end_to_end"]:
        if m["name"].startswith("fwd_"):
            m["workloads"].append("dummy.fwd")
    b["per_layer"].append({"name": "dummy_calls", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "fwd_voxels_per_s",
                           "workloads": ["dummy.fwd"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = shrink(spec.load(tmp_path, only="dummy.fwd")["dummy.fwd"], 16)
    # the metrics that list the cell, and setup_s, which lists none
    assert [m.name for m in cell.metrics] == [
        "fwd_voxels_per_s", "fwd_call_p95_ms", "setup_s", "dummy_calls"]
    result, _ = run.run_cell(cell, 5, 0.2, 1, torch.device("cpu"),
                             setup_clock=lambda: 1.0)
    assert result["correct"]
    assert result["metrics"]["dummy_calls"]["value"] == result["attempted"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_reader_serves_every_suffix_of_its_name():
    """``glue_share.loss`` and ``glue_share.fwd`` read through one
    ``glue_share.py``; an exact file comes first; every reader is used; a
    name with neither file is refused."""
    read = {m.name: m.read for c in spec.load(ROOT).values() for m in c.metrics}
    files = {n: Path(r.__code__.co_filename).name for n, r in read.items()}
    assert files["glue_share.loss"] == files["glue_share.fwd"] == "glue_share.py"
    assert files["idle_share.loss"] == files["idle_share.fwd"] == "idle_share.py"
    assert files["loss.fwd_ms"] == "loss.fwd_ms.py"
    assert set(files.values()) == {p.name for p in (ROOT / spec.METRICS_DIR).glob("*.py")}
    with pytest.raises(FileNotFoundError):
        spec._reader(ROOT, "no_such_metric.loss")
