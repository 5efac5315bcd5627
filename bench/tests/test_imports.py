"""Nothing in ``bench/`` imports JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is the port, not ``repro``), nothing reads
``benchmarks/``, and the plain reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

from benchlib.spec import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN
    if path != Path(__file__).resolve():
        assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "typing", "torch", "numpy", "math"}


def test_the_check_compares_whole_names():
    from benchlib import runner

    assert runner.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    assert "repro_torch".split(".")[0] not in runner.FORBIDDEN
