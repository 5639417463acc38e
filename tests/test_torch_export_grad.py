"""The exported gradient of the port's differentiable transforms on the
CPU, against the JAX package's.

K2 to K6 are ``torch.library`` custom ops (``edt_tpu_torch::minplus_argmin``,
``::minplus_grad``, ``::binary_grad_scan``, ``::softmin``,
``::softmin_grad``), and the passes' ``autograd.Function``s call them, so
``utils.export.export_fn`` takes a function that calls
``torch.autograd.grad``, as the JAX package's ``export_fn`` takes
``jax.grad`` (``tests/test_export.py``). Each case exports such a gradient
on ``device="cpu"`` (the ops run the kernels' plain versions there),
saves it to bytes, loads it, and holds the loaded gradient bit-exact to
the live one and to the JAX package's jitted gradient on the same NumPy
inputs: at temperature 0 within rtol=1e-5, atol=0 (the backward sums the same
cotangents in another order), at t > 0 within rtol=1e-4, atol=1e-4
max|grad| (``tests/test_torch_soft.py``). Each op's fake implementation
gives the shapes and dtypes the op gives, and ``torch.library.opcheck``
passes on each op.
"""

import io

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from edt_tpu.models import soft as jsoft
from edt_tpu_torch.models import soft
from edt_tpu_torch.ops import argmin, grad, softmin
from edt_tpu_torch.utils import export as edt_export

torch.set_num_threads(1)

OPS = ("minplus_argmin", "minplus_grad", "binary_grad_scan", "softmin",
       "softmin_grad")


def _op_counts(program):
    """{op name: its nodes in the graph} for the kernels' ops."""
    counts = dict.fromkeys(OPS, 0)
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("edt_tpu_torch."):
            counts[name.split(".")[1]] = counts.get(name.split(".")[1], 0) + 1
    return counts


def _grad_fn(transform):
    """(args..., x) -> d sum(transform(args..., x)) / dx, as a function
    ``export_fn`` takes."""
    def gfn(*args):
        *rest, x = args
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            return torch.autograd.grad(transform(*rest, x).sum(), x)[0]
    return gfn


def _round_trip(gfn, *args):
    """The loaded program of ``export_fn(gfn, *args)`` after a save to
    bytes, and the exported program itself."""
    program = edt_export.export_fn(gfn, *args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return edt_export.load(buf.getvalue()), program


def _jax_grad(transform, *args):
    x = args[-1]
    rest = args[:-1]
    fn = jax.jit(jax.grad(lambda o: jnp.sum(transform(*rest, o))))
    return np.asarray(fn(jnp.asarray(x)))


def _multilabel_case(seed=7, shape=(8, 9, 10)):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 3, size=shape).astype(np.uint32)
    return rng, lab, (lab != 0).astype(np.float32)


def test_export_fn_generic_multilabel_grad():
    """The counterpart of tests/test_export.py's: grad of the wall-faithful
    multi-label transform at bench flags, round-tripped; K2, K3 and K4 are
    op nodes of the graph."""
    _, lab, occ = _multilabel_case()
    kw = dict(black_border=True, barrier=600.0, binary_occupancy=True)

    def transform(lab, o):
        return soft.multilabel_edtsq(lab, o, (1.0, 1.0, 2.0), **kw)

    gfn = _grad_fn(transform)
    lt = torch.from_numpy(lab.view(np.int32))
    ot = torch.from_numpy(occ)
    run, program = _round_trip(gfn, lt, ot)
    assert _op_counts(program) == {"minplus_argmin": 2, "minplus_grad": 2,
                                   "binary_grad_scan": 1, "softmin": 0,
                                   "softmin_grad": 0}
    got = run(lt, ot)
    assert torch.equal(got, gfn(lt, ot))
    want = _jax_grad(lambda lab, o: jsoft.multilabel_edtsq(
        lab, o, (1.0, 1.0, 2.0), **kw), jnp.asarray(lab), occ)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=0.0)


def test_export_multilabel_grad_walled_general_path():
    """A soft occupancy on the general path (binary_occupancy=False): K2
    and K3 on every pass, their walls from int16 counts."""
    rng, lab, occ = _multilabel_case(seed=8, shape=(7, 11, 9))
    occ = occ * rng.random(occ.shape).astype(np.float32)

    def transform(lab, o):
        return soft.multilabel_edtsq(lab, o, (2.0, 1.0, 3.0), False,
                                     binary_occupancy=False)

    gfn = _grad_fn(transform)
    lt = torch.from_numpy(lab.view(np.int32))
    ot = torch.from_numpy(occ)
    run, program = _round_trip(gfn, lt, ot)
    counts = _op_counts(program)
    assert counts["minplus_argmin"] == 3 and counts["minplus_grad"] == 3
    assert counts["binary_grad_scan"] == 0
    got = run(lt, ot)
    assert torch.equal(got, gfn(lt, ot))
    want = _jax_grad(lambda lab, o: jsoft.multilabel_edtsq(
        lab, o, (2.0, 1.0, 3.0), False, binary_occupancy=False),
        jnp.asarray(lab), occ)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=0.0)


@pytest.mark.parametrize("fn", ["soft_edtsq", "soft_sdfsq"])
def test_export_softmin_grad(fn):
    """soft_edtsq and soft_sdfsq at t = 0.3: K5 and K6 on every pass."""
    rng = np.random.default_rng(9)
    occ = rng.random((6, 8, 10)).astype(np.float32)
    args = ((1.0, 1.0, 2.0), True, 300.0, 0.3)

    gfn = _grad_fn(lambda o: getattr(soft, fn)(o, *args))
    ot = torch.from_numpy(occ)
    run, program = _round_trip(gfn, ot)
    counts = _op_counts(program)
    per = 3 if fn == "soft_edtsq" else 6
    assert counts["softmin"] == per and counts["softmin_grad"] == per
    assert counts["minplus_argmin"] == 0
    got = run(ot)
    assert torch.equal(got, gfn(ot))
    want = _jax_grad(lambda o: getattr(jsoft, fn)(o, *args), occ)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_exported_grad_reruns_on_new_inputs():
    """The loaded program is the gradient for any occupancy of its shape,
    not a constant of the example: a second occupancy gives the live
    gradient's bits."""
    rng, lab, occ = _multilabel_case(seed=10, shape=(9, 8, 7))
    gfn = _grad_fn(lambda lab, o: soft.multilabel_edtsq(
        lab, o, (1.0, 2.0, 1.0), True, binary_occupancy=False))
    lt = torch.from_numpy(lab.view(np.int32))
    run, _ = _round_trip(gfn, lt, torch.from_numpy(occ))
    other = torch.from_numpy(
        (occ * rng.random(occ.shape)).astype(np.float32))
    assert torch.equal(run(lt, other), gfn(lt, other))


def _fake_calls(n):
    """(op, args, expected (shape, dtype) of each output) for rows of n."""
    f = torch.empty((3, n))
    i16, i32 = torch.empty((3, n), dtype=torch.int16), torch.empty(
        (3, n), dtype=torch.int32)
    link = argmin.link_dtype(n)
    return [
        ("minplus_argmin", (f, 1.0, None, True), [torch.float32, link]),
        ("minplus_argmin", (f, 1.0, i32, False), [torch.float32, torch.int32]),
        ("minplus_grad", (f, None, i16 if link == torch.int16 else i32, -1),
         [torch.float32]),
        ("binary_grad_scan", (f, i32, None), [torch.float32]),
        ("softmin", (f, 1.0, 0.3), [torch.float32]),
        ("softmin_grad", (f, f, f, 1.0, 0.3), [torch.float32, torch.float32]),
    ]


@pytest.mark.parametrize("n", [argmin.I16_MAX_AXIS, argmin.I16_MAX_AXIS + 1,
                               softmin.MAX_AXIS + 1])
def test_register_fake_shapes_and_dtypes(n):
    """Every op's fake implementation: outputs of the rows' shape, f32
    values, K2's link offsets int16 up to I16_MAX_AXIS and int32 past it
    (and past every shared-memory ceiling), absolute args int32."""
    assert grad.MAX_AXIS == argmin.MAX_AXIS
    with FakeTensorMode() as mode:
        for name, args, dtypes in _fake_calls(n):
            args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                         else a for a in args)
            outs = getattr(torch.ops.edt_tpu_torch, name)(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            assert [o.dtype for o in outs] == dtypes, name
            assert all(tuple(o.shape) == (3, n) for o in outs), name
    assert argmin.link_dtype(n) == (torch.int16 if n <= argmin.I16_MAX_AXIS
                                    else torch.int32)


def test_ops_match_the_wrappers_on_cpu():
    """On CPU tensors each op returns its wrapper's values (the plain
    version) bit for bit."""
    rng = np.random.default_rng(11)
    f = torch.from_numpy((rng.random((5, 40)) * 50).astype(np.float32))
    f[:, ::7] = 0.0
    g = torch.from_numpy(rng.uniform(-1, 1, (5, 40)).astype(np.float32))
    ops = torch.ops.edt_tpu_torch
    d, o = ops.minplus_argmin(f, 2.25, emit_offsets=True)
    rd, ro = argmin.minplus_argmin(f, 2.25, emit_offsets=True)
    assert torch.equal(d, rd) and torch.equal(o, ro)
    assert torch.equal(ops.minplus_grad(g, offsets=o),
                       grad.minplus_grad(g, offsets=o))
    z = torch.where(f == 0, torch.iinfo(o.dtype).max, o)
    assert torch.equal(ops.binary_grad_scan(g, z), grad.binary_grad_scan(g, z))
    s = ops.softmin(f, 2.25, 0.3)
    assert torch.equal(s, softmin.softmin(f, 2.25, 0.3))
    for a, b in zip(ops.softmin_grad(f, s, g, 2.25, 0.3),
                    softmin.softmin_grad(f, s, g, 2.25, 0.3)):
        assert torch.equal(a, b)


def _opcheck_cases():
    rng = np.random.default_rng(12)
    f = torch.from_numpy((rng.random((5, 40)) * 50).astype(np.float32))
    f[:, ::7] = 0.0
    g = torch.from_numpy(rng.uniform(-1, 1, (5, 40)).astype(np.float32))
    d, o = argmin.minplus_argmin_plain(f, 2.25, emit_offsets=True)
    z = torch.where(f == 0, torch.iinfo(o.dtype).max, o)
    s = softmin.softmin_plain(f, 2.25, 0.3)
    cnt = torch.from_numpy(rng.integers(1, 30, (5, 40)).astype(np.int16))
    return {"minplus_argmin": (f, 2.25, None, True),
            "minplus_argmin walled": (f, 2.25, cnt, True),
            "minplus_grad": (g, None, o, torch.iinfo(o.dtype).min),
            "binary_grad_scan": (g, z, None),
            "softmin": (f, 2.25, 0.3),
            "softmin_grad": (f, s, g, 2.25, 0.3)}


@pytest.mark.parametrize("case", ["minplus_argmin", "minplus_argmin walled",
                                  "minplus_grad", "binary_grad_scan",
                                  "softmin", "softmin_grad"])
def test_opcheck(case):
    """torch.library.opcheck of each op on CPU tensors: its schema, its
    fake implementation against the real outputs, and its use under
    AOT dispatch."""
    op = getattr(torch.ops.edt_tpu_torch, case.split()[0]).default
    torch.library.opcheck(op, _opcheck_cases()[case])
