"""The frozen reference against the program at 16^3-32^3 on the CPU
(forward and gradient, bit for bit), and the bfloat16 control, which has
to fail every cell's comparison."""

import numpy as np
import pytest
import torch

from edt_tpu_torch import torch_api
from edt_tpu_torch.models import soft
from edtbench import loops, reference, volumes

CPU = torch.device("cpu")
CASES = [((16, 16, 16), 4, (6.0, 6.0, 30.0)), ((24, 20, 28), 4, (6.0, 6.0, 30.0)),
         ((20, 17, 32), 3, (1.0, 2.0, 3.0)), ((16, 16, 16), 4, (1.0, 1.0, 1.0))]


def _labels(shape, block, seed):
    return volumes.make({"kind": "blocks", "dtype": "uint32", "values": 6,
                         "block": block}, shape, seed, CPU)


@pytest.mark.parametrize("black_border", [True, False])
@pytest.mark.parametrize("shape,block,aniso", CASES)
def test_forward_matches_the_program(shape, block, aniso, black_border):
    for seed in (1, 2):
        lab = _labels(shape, block, seed)
        got = torch_api.edtsq(lab, aniso, black_border=black_border)
        want = reference.edtsq(lab, aniso, black_border)
        assert loops.gap(got, want) == 0.0
        mask = lab != 0
        got = torch_api.edtsq(mask, aniso, black_border=black_border, binary=True)
        want = reference.edtsq(mask, aniso, black_border, binary=True)
        assert loops.gap(got, want) == 0.0


@pytest.mark.parametrize("black_border", [True, False])
@pytest.mark.parametrize("shape,block,aniso", CASES)
def test_loss_and_gradient_match_the_program(shape, block, aniso, black_border):
    lab = _labels(shape, block, 3)
    occ = (lab != 0).to(torch.float32)
    fg = torch.nonzero(lab.reshape(-1)).flatten()
    occ.reshape(-1)[fg[:: max(1, len(fg) // 5)]] = 0.0  # sources inside labels
    occ.requires_grad_(True)
    barrier = float(np.sum((np.asarray(aniso) * np.asarray(shape)) ** 2))
    out = soft.multilabel_edtsq(lab, occ, aniso, black_border=black_border,
                                barrier=barrier, binary_occupancy=True)
    (grad,) = torch.autograd.grad(out.sum(), occ)
    want_out, want_grad = reference.loss_forward_grad(
        lab, occ.detach(), aniso, black_border, barrier)
    assert loops.gap(out.detach(), want_out) == 0.0
    assert loops.gap(grad, want_grad) == 0.0
    assert float(want_grad.abs().max()) > 0


def test_runs_and_walls():
    lab = torch.tensor([[0, 1, 1, 2, 2, 2, 0]])
    li, ri, ol, orr = reference.runs(lab)
    assert li.tolist() == [[1, 1, 2, 1, 2, 3, 1]]
    assert ri.tolist() == [[1, 2, 1, 3, 2, 1, 1]]
    assert ol.tolist() == [[True] + [False] * 6]
    assert orr.tolist() == [[False] * 6 + [True]]
    # a lone foreground voxel with black borders: one pitch to either wall
    d = reference.edtsq(torch.ones((1, 1, 1), dtype=torch.int32), (1, 1, 5.0), True)
    assert d.item() == 1.0


@pytest.mark.parametrize("name,size,block", [("ml512.loss", 48, 16),
                                             ("ml512.fwd", 48, 16),
                                             ("cube511.fwd", 80, 8)])
def test_bfloat16_control_is_not_correct(tiny_cell, name, size, block):
    """The reference in bfloat16 in the program's place fails the cell's
    comparison on three seeds; the program passes it. The sizes are where
    some distance always needs more than bfloat16's 8 significant bits:
    runs of 16 voxels, and a cube of 80 (at 40 one cleared voxel can pull
    every distance under them, about one call in 14)."""
    from edtbench import run

    cell = tiny_cell(name, size, block)
    limits = cell.traffic["limits"]
    for seed in (4, 5, 6):
        loop = loops.make(cell, seed, CPU)
        run.window(loop, 0.05)
        ctrl = loop.check(answer_of=lambda k: loop.reference(k, torch.bfloat16))
        prog = loop.check()
        assert all(r[n] <= limits[n] for _, r in prog for n in limits)
        assert all(any(r[n] > limits[n] for n in limits) for _, r in ctrl)


def test_bfloat16_control_is_not_correct_over_ranks(tiny_cell):
    """The same over four gloo ranks, each holding its slab: the program
    (sharded) passes, the control (the reference's own exchange) fails."""
    import functools

    from conftest import FOUR_CARD
    from edtbench import control, ranks

    cell = tiny_cell(FOUR_CARD, 48, 16)
    limits = cell.traffic["limits"]
    job = functools.partial(control.sweep, seeds=[4], control_seeds=[4, 5, 6],
                            seconds=0.05)
    rows = ranks.launch(cell.root, cell.name, cell.chips, job, backend="gloo",
                        device_type="cpu", config=cell.config)
    assert len(rows) == 3
    for _, prog, ctrl in rows:
        assert all(prog[n] <= limits[n] for n in limits)
        assert any(ctrl[n] > limits[n] for n in limits)
