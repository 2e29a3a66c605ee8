"""The import guard and the sources: nothing a run loads may be JAX, the
JAX package, ``chip_smoke`` or ``bench``; top-level names are compared
whole, so the program's own name passes."""

import ast
import glob
import os
import sys
import types

import pytest

import harness


def test_guard_flags_the_jax_package_and_passes_the_port():
    assert harness.banned_modules({"eicos_tpu_torch": 1,
                                   "eicos_tpu_torch.ops": 1}) == []
    assert harness.banned_modules({"eicos_tpu_torch": 1,
                                   "eicos_tpu.api": 1}) == ["eicos_tpu"]
    assert harness.banned_modules({"jax._src": 1, "jaxlib": 1,
                                   "flax": 1}) == ["flax", "jax", "jaxlib"]


def test_guard_on_a_planted_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "eicos_tpu",
                        types.ModuleType("eicos_tpu"))
    assert "eicos_tpu" in harness.banned_modules()


def test_main_prints_no_result_where_the_guard_finds_one(monkeypatch,
                                                         capsys):
    """``main`` past its look for a card, with a run planted: the guard
    turns it into an exit without a result."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "card_line", lambda: "planted")
    monkeypatch.setattr(harness, "execute", lambda *a, **k: (dict(
        correct=True, checks={}), None))
    monkeypatch.setitem(sys.modules, "eicos_tpu",
                        types.ModuleType("eicos_tpu"))
    rc = harness.main(["--workload", "mpc_lp.sweep128", "--seed", "1",
                       "--seconds", "1"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_main_without_a_card_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "mpc_lp.sweep128", "--seed", "1",
                       "--seconds", "1"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = [p for p in glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                                recursive=True)
           if os.sep + "tests" + os.sep not in p]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, harness.HERE)
                              for p in SOURCES])
def test_sources_import_nothing_banned(path):
    assert not set(_imports(path)) & set(harness.BANNED)


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(harness.HERE, "reference", "*.py")):
        assert set(_imports(path)) <= {"__future__", "numpy"}, path
