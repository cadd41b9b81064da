"""No module of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the port.  Top-level names are
compared whole: ``distkeras_tpu_torch`` is the port, not
``distkeras_tpu``."""

from __future__ import annotations

import ast
import sys
import types

import bench_tiny
import pytest

from harness import core

JAX_SIDE = {"jax", "jaxlib", "flax", "distkeras_tpu"}
FILES = sorted(bench_tiny.BENCH.rglob("*.py"))


def imported(path) -> set[str]:
    """Top-level names of every absolute import in the file."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_sees_every_module():
    assert {p.parent.name for p in FILES} >= {
        "benchmark", "harness", "drivers", "reference", "metrics", "tests"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not imported(path) & JAX_SIDE


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.parent.name == "reference"],
    ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "distkeras_tpu_torch" not in imported(path)
    assert imported(path) <= {"__future__", "contextlib", "math", "torch",
                              "reference"}


def test_the_run_time_guard_compares_whole_names():
    assert "distkeras_tpu_torch" not in core.imported_forbidden()
    planted = "distkeras_tpu.planted_by_test"
    sys.modules[planted] = types.ModuleType(planted)
    try:
        assert core.imported_forbidden() == ["distkeras_tpu"]
    finally:
        del sys.modules[planted]
