"""Nothing in glmbench imports JAX or the JAX package, and the reference
imports nothing of the program: top-level module names compared whole."""

import ast
import sys
from pathlib import Path

import pytest

from glmbench import harness

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tabmat_tpu"}


def imported_top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not imported_top_levels(path) & (FORBIDDEN | {"tabmat_torch"})


def test_whole_names_are_compared(monkeypatch):
    # the program's name begins with the JAX package's: it is no match
    monkeypatch.setitem(sys.modules, "tabmat_torch_like", sys)
    assert "tabmat_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tabmat_tpu.sub", sys)
    assert harness.forbidden_modules() == ["tabmat_tpu"]
