"""No module the benchmark runs has a top-level import name of ``jax``,
``jaxlib``, ``flax`` or ``bilevel_gait_gen_tpu`` (compared whole: the
port's ``bilevel_gait_gen_tpu_torch`` is another name), and the reference
imports nothing of the port."""
import ast
from pathlib import Path

import pytest

from benchmark.harness import core

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


def top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_walk_sees_every_file():
    assert len(FILES) > 30
    assert {"bilevel_gait_gen_tpu_torch", "torch"} <= set().union(
        *map(top_names, FILES))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_names(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_names(path)
    assert "bilevel_gait_gen_tpu_torch" not in names
    assert "benchmark" not in names


def test_whole_names():
    import sys
    sys.modules.setdefault("bilevel_gait_gen_tpu_torch", sys)
    assert "bilevel_gait_gen_tpu" not in core.forbidden_modules()
