"""What the benchmark's modules import, by top-level names compared whole."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import common

FORBIDDEN = {"jax", "jaxlib", "flax", "coloc_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    return sorted(p for p in (common.ROOT / sub).rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(common.ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: str(p.relative_to(common.ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    assert "coloc_tpu_torch" not in top_level_imports(path)


def test_whole_names():
    """coloc_tpu_torch begins with coloc_tpu and is not it."""
    from portbench import run
    assert "coloc_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert "coloc_tpu" in run.FORBIDDEN
