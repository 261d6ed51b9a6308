"""No module of the harness, the maker or the reference imports JAX or the
JAX package, and the maker and the reference import nothing of the
program: a walk over every import of every module under svbench/, by
top-level name compared whole."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "svim_tpu"}


def _modules():
    for folder, _, files in os.walk(HERE):
        if os.path.basename(folder) == "tests":
            continue
        for name in files:
            if name.endswith(".py"):
                yield os.path.relpath(os.path.join(folder, name), HERE)


def _top_names(path):
    with open(os.path.join(HERE, path)) as handle:
        tree = ast.parse(handle.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()))
def test_no_jax_and_no_program_in_the_yardstick(path):
    names = _top_names(path)
    assert not names & FORBIDDEN, path
    if path.startswith("reference") or path in ("maker.py", "yardstick.py",
                                                "compare.py", "inputs.py"):
        assert "svim_tpu_torch" not in names, path


def test_the_walk_sees_the_modules_it_guards():
    found = set(_modules())
    assert {"run.py", "maker.py", "compare.py", "reference/pipeline.py",
            "reference/collect.py", "metrics/collect_s.py"} <= found
