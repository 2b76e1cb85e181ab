"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared whole: the
part of a module's name before its first dot."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "hyres_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_check_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import hyres_tpu_torch.models\nfrom jax.numpy import zeros\n")
    assert top_level_imports(f) == {"hyres_tpu_torch", "jax"}
    assert not top_level_imports(f) - {"jax"} & BANNED


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & BANNED


def test_the_reference_imports_nothing_of_the_program():
    ref = [p for p in SOURCES if "reference" in p.relative_to(BENCH).parts]
    assert ref
    for p in ref:
        assert "hyres_tpu_torch" not in top_level_imports(p), p
