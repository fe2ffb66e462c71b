"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (henjou_torch and henjou_tpu share a prefix),
and the plain reference imports nothing of the program."""

import ast
import os
import sys

import pytest

from hbench import runner, spec

JAX_NAMES = {"jax", "jaxlib", "flax", "henjou_tpu"}


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    # module names a metric reader hooks or reads a counter of
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Tuple):
            target = {getattr(t, "id", "") for t in node.targets}
            if "HOOKS" in target:
                names |= {e.elts[0].value.split(".")[0] for e in node.value.elts}
            elif "COUNTER" in target:
                names.add(node.value.elts[0].value.split(".")[0])
    return names


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(spec.BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, spec.ROOT))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted(_sources("plainref")),
                         ids=lambda p: os.path.relpath(p, spec.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert "henjou_torch" not in _top_level_imports(path)


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "henjou_tpux", object())
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", object())
    assert "henjou_tpux" not in runner.forbidden_modules()
    assert not set(runner.forbidden_modules()) & {"henjou_tpux", "jaxfoo"}
    monkeypatch.setitem(sys.modules, "henjou_tpu.render", object())
    assert "henjou_tpu" in runner.forbidden_modules()
