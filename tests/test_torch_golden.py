"""The reference's golden tests (tests/test_golden_*.py) run against the
port on the CPU: each golden test function is called with its module's
``edt`` swapped for ``edt_tpu_torch`` bound to ``device="cpu"``."""

import functools
import types

import pytest
import torch

import edt_tpu_torch
import test_golden_1d
import test_golden_2d3d

torch.set_num_threads(1)

PORT_CPU = types.SimpleNamespace(
    edt=functools.partial(edt_tpu_torch.edt, device="cpu"),
    edtsq=functools.partial(edt_tpu_torch.edtsq, device="cpu"),
)

GOLDENS = [
    (test_golden_1d, "test_one_d_black_border"),
    (test_golden_1d, "test_one_d"),
    (test_golden_1d, "test_1d_scipy_comparison"),
    (test_golden_2d3d, "test_two_d_ident_no_border"),
    (test_golden_2d3d, "test_two_d_ident_black_border"),
    (test_golden_2d3d, "test_two_d"),
    (test_golden_2d3d, "test_three_d"),
    (test_golden_2d3d, "test_zero_trailing_2d"),
    (test_golden_2d3d, "test_column_off_by_one"),
]


@pytest.mark.parametrize("module,name", GOLDENS,
                         ids=[f"{m.__name__}.{n}" for m, n in GOLDENS])
def test_golden_on_port(monkeypatch, module, name):
    monkeypatch.setattr(module, "edt", PORT_CPU)
    getattr(module, name)()


@pytest.mark.parametrize("dtype", test_golden_1d.TYPES)
def test_one_d_simple_on_port(monkeypatch, dtype):
    monkeypatch.setattr(test_golden_1d, "edt", PORT_CPU)
    test_golden_1d.test_one_d_simple(dtype)
