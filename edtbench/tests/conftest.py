"""Helpers of the benchmark's own tests: the real cells of BENCHMARK.json,
shrunk to sizes a CPU test holds (every other setting as committed), and a
four-card cell added to a copy of the benchmark as new files and entries."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from edtbench import spec  # noqa: E402

torch.set_num_threads(1)

FOUR_CARD = "ml1024x4.loss"


def four_card_root(tmp: Path) -> Path:
    """A copy of the benchmark under ``tmp`` with the cell ``FOUR_CARD``
    added as data only: the 512^3 configuration's labels and pitch at
    1024^3, sharded along axis 0 over four ranks, under the ``loss``
    traffic, reporting every metric of the one-card loss cell."""
    if not (tmp / "BENCHMARK.json").is_file():
        shutil.copytree(ROOT / "edtbench", tmp / "edtbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        b = json.loads((ROOT / "BENCHMARK.json").read_text())
        cfg = json.loads((ROOT / "edtbench/configs/conn_ml512_aniso.json").read_text())
        cfg.update(name="conn_ml1024_aniso_x4", shape=[1024] * 3)
        cfg["barrier"] = float(sum((w * 1024) ** 2 for w in cfg["anisotropy"]))
        (tmp / "edtbench/configs/conn_ml1024_aniso_x4.json").write_text(json.dumps(cfg))
        b["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": "edtbench/configs/conn_ml1024_aniso_x4.json",
                             "reduced": [], "why": "a test's cell"})
        b["workloads"].append({"name": FOUR_CARD, "config": cfg["name"],
                               "traffic": "loss", "chips": 4, "why": "a test's cell"})
        for m in b["end_to_end"] + b["per_layer"]:
            if "ml512.loss" in m.get("workloads", ()):
                m["workloads"].append(FOUR_CARD)
        (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp


def shrink(cell, size=None, block=8):
    """The cell at a test size: block volumes 32^3 in blocks of ``block`` (the
    barrier recomputed as the configuration's rule gives it), others
    ``size``^3 (default 24)."""
    cfg = cell.config
    if cfg["volume"]["kind"] == "blocks":
        cfg["shape"] = [size or 32] * 3
        cfg["volume"] = dict(cfg["volume"], block=block)
        if "barrier" in cfg:
            cfg["barrier"] = float(sum((w * s) ** 2 for w, s in
                                       zip(cfg["anisotropy"], cfg["shape"])))
    else:
        cfg["shape"] = [size or 24] * 3
    return cell


@pytest.fixture
def tiny_cell(tmp_path):
    """make(name, size, block): the cell at a test size, with ``root``, the
    checkout its spawned ranks load it from."""
    def make(name, size=None, block=8):
        root = four_card_root(tmp_path) if name == FOUR_CARD else ROOT
        cell = shrink(spec.load(root, only=name)[name], size, block)
        cell.root = root
        return cell
    return make
