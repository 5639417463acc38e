"""K3's and K6's row-split modes (the long-row modes) as their host twins
in ``chip_smoke.py`` (``k3_split``, ``k6_split``), against the plain
versions on the CPU, at tiles cut down to a few dozen voxels so that a
short row spans many.

- K3: bit-equal to ``minplus_grad_plain`` (``scatter_add_`` on the CPU
  sums each target's sources onto 0.0 in ascending i, as the kernel's
  modes do), on rows whose runs cross tile ends, one run longer than a
  tile, inert voxels at tile ends, links that leave the row, and rows
  whose links do not ascend, which must be marked for the one-warp mode.
- K6: within the kernels' tolerance (df within rtol=1e-4, atol=1e-4
  max|df|; sum(g e) within rtol=1e-3), on rows whose pairs cross tile
  ends into the halos, and rows whose pairs reach past the halo, which
  must be marked.

The CUDA kernels themselves run only on a card: tests/test_torch_long_rows.py
and ``chip_smoke.py long``.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import argmin, grad, softmin

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(x):
    return x.contiguous().view(torch.int32)


def _descends(targets):
    """1 where a row's live targets (>= 0) ever descend."""
    out = []
    for row in targets:
        live = row[row >= 0]
        out.append(int(bool((live[1:] < live[:-1]).any())))
    return torch.tensor(out, dtype=torch.int32)


@pytest.mark.parametrize("tile,n", [(64, 700), (100, 450)])
def test_k3_split_twin_bit_equal_to_plain_on_stress_rows(tile, n):
    cs = _chip_smoke()
    g, o, sent, marks = cs.k3_split_rows(np.random.default_rng(n), n, tile)
    g, o = torch.from_numpy(g), torch.from_numpy(o)
    targets = cs.k3_targets(o, sent)
    df, got_marks = cs.k3_split(g, targets, tile)
    ref = grad.minplus_grad_plain(g, offsets=o, off_sent=sent)
    assert torch.equal(_bits(df), _bits(ref))
    assert torch.equal(got_marks, torch.from_numpy(marks))
    assert torch.equal(got_marks, _descends(targets))


def test_k3_split_twin_on_k2_links():
    """K2's links on label rows (the main path's), int16 and int32: the
    twin bit-equal to the plain version, marking exactly the rows whose
    links descend."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    f, lab = cs.long_label_rows(rng, 6, 900, run=24)
    lt = torch.from_numpy(lab)
    cnt = soft._wall_counts(lt, 1, True).contiguous()
    _, o = argmin.minplus_argmin_plain(torch.from_numpy(f), 36.0, cnt, True)
    g = torch.from_numpy(rng.uniform(-1, 1, f.shape).astype(np.float32))
    for offsets in (o, o.to(torch.int32)):
        sent = torch.iinfo(o.dtype).min
        targets = cs.k3_targets(offsets, sent)
        df, marks = cs.k3_split(g, targets, 64)
        ref = grad.minplus_grad_plain(g, offsets=offsets, off_sent=sent)
        assert torch.equal(_bits(df), _bits(ref))
        assert torch.equal(marks, _descends(targets))


def _k6_rows(case, rng):
    """(f, w2, marks the row-split mode must give) at n = 500."""
    n = 500
    if case == "sources":  # the long cell's rows: 30 % zeros, heights 0..900
        return _chip_smoke().long_soft_rows(rng, 4, n), 36.0, [0, 0, 0, 0]
    f = (rng.random((4, n)) * 50).astype(np.float32)
    f[rng.random((4, n)) < 0.05] = 0.0  # pairs up to 8 voxels away
    if case == "sparse":
        return f, 1.0, [0, 0, 0, 0]
    f[1] = np.inf  # one source: pairs up to the row's length away
    f[1, 7] = 0.0
    return f, 1.0, [0, 1, 0, 0]


@pytest.mark.parametrize("case", ["sources", "sparse", "far"])
def test_k6_split_twin_close_to_plain(case):
    cs = _chip_smoke()
    rng = np.random.default_rng(len(case))
    f, w2, want = _k6_rows(case, rng)
    f = torch.from_numpy(f)
    t = 0.3
    d = softmin.softmin_plain(f, w2, t)
    g = torch.from_numpy(rng.uniform(-1, 1, f.shape).astype(np.float32))
    df, e, marks = cs.k6_split(f, d, g, w2, t, tile=32, halo=32)
    rdf, re = softmin.softmin_grad_plain(f, d, g, w2, t)
    assert marks.tolist() == want
    torch.testing.assert_close(df, rdf, rtol=1e-4,
                               atol=1e-4 * float(rdf.abs().max()))
    torch.testing.assert_close((g * e).sum(), (g * re).sum(), rtol=1e-3,
                               atol=0.0)
