"""What the benchmark may import and read: no module of it imports jax,
jaxlib, flax or the JAX package (top-level names compared whole, since the
port's name begins with the JAX package's), the reference imports nothing
of the port, and nothing reads the JAX-era benchmark files."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "edt_tpu"}
# the JAX-era timing script and folder, spelled so that this file does not
# hold them itself
OLD = ("bench" + ".py", "benchmarks" + "/")
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _strings(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_old_benchmark(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert not names & {"bench", "benchmarks"}
    for s in _strings(path):
        assert not any(old in s for old in OLD), s


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py",):
        assert set(_imports(HERE / name)) <= {"__future__", "numpy", "torch"}


def test_top_level_names_are_compared_whole():
    assert "edt_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "edt_tpu.ops".split(".")[0] in FORBIDDEN
