"""``BENCHMARK.json`` resolved to files by name.

A cell names a configuration (its ``file``), a traffic mix
(``edtbench/traffic/<traffic>.json``) and, through the metrics that list
it, the readers ``edtbench/metrics/<metric>.py`` (or the reader of the
name before its first dot, which serves every suffix). So a later cell,
traffic mix or metric is new files and new entries, and no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

TRAFFIC_DIR = "edtbench/traffic"
METRICS_DIR = "edtbench/metrics"


@dataclass
class Metric:
    name: str
    unit: str
    end_to_end: bool
    read: object  # the reader's ``read(record) -> float | None``


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list = field(default_factory=list)  # end to end, then per layer


def _reader(root: Path, name: str):
    """``read`` of ``metrics/<name>.py``, or, where there is none, of the
    reader of the name before its first dot: one ``glue_share.py`` reads
    ``glue_share.loss`` and ``glue_share.fwd``."""
    path = root / METRICS_DIR / f"{name}.py"
    if not path.is_file():
        path = root / METRICS_DIR / f"{name.split('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name}: no reader "
                                f"{root / METRICS_DIR / name}.py or {path}")
    spec = importlib.util.spec_from_file_location(f"edtbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str, moved: set) -> bool:
    """Whether ``cell`` reports ``metric``: those its ``workloads`` list, or,
    without the key, every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in moved


def load(root, only=None) -> dict:
    """{cell name: Cell} of ``root``/BENCHMARK.json (only the cell named
    ``only``, if given), every file resolved."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {}
    for w in bench["workloads"]:
        if only is not None and w["name"] != only:
            continue
        cfg = dict(_json(root / configs[w["config"]]["file"]))
        traffic = _json(root / TRAFFIC_DIR / f"{w['traffic']}.json")
        cell = Cell(w["name"], int(w["chips"]), cfg, traffic)
        moved = set()
        for m in bench["end_to_end"]:
            if _reports(m, w["name"], moved):
                cell.metrics.append(Metric(m["name"], m["unit"], True,
                                           _reader(root, m["name"])))
        moved = {m.name for m in cell.metrics}
        for m in bench["per_layer"]:
            if _reports(m, w["name"], moved):
                cell.metrics.append(Metric(m["name"], m["unit"], False,
                                           _reader(root, m["name"])))
        cells[w["name"]] = cell
    if only is not None and only not in cells:
        raise KeyError(f"no workload {only!r} in {root / 'BENCHMARK.json'}")
    return cells
