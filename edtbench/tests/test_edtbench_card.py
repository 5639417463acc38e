"""On the card only: each cell at its own size, the program's answers
within their limits and the bfloat16 control's outside them.

    python3 -m pytest edtbench/tests/test_edtbench_card.py -q
"""

import functools

import pytest
import torch

from conftest import ROOT
from edtbench import control, ranks, spec

CELLS = sorted(spec.load(ROOT))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_at_cell_size(name):
    cell = spec.load(ROOT, only=name)[name]
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA cards")
    limits = cell.traffic["limits"]
    job = functools.partial(control.sweep, seeds=[17], control_seeds=[17],
                            seconds=1.0)
    if cell.chips == 1:
        [(_, prog, ctrl)] = job(cell, torch.device("cuda", 0), None)
    else:
        [(_, prog, ctrl)] = ranks.launch(ROOT, name, cell.chips, job)
    assert all(prog[n] <= limits[n] for n in limits), prog
    assert any(ctrl[n] > limits[n] for n in limits), ctrl
