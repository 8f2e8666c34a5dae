"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: module names are compared by
their whole top-level name (the port's name begins with the JAX
package's)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "modem_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = set(imported(path)) & FORBIDDEN
    assert not bad, bad
    if "reference" in path.parts:
        assert "modem_tpu_torch" not in set(imported(path))
    assert not {"chip_smoke", "profile_card", "bench"} & set(imported(path))


def test_the_run_loads_no_jax():
    prog = ("import sys, runpy\n"
            "sys.argv = ['run.py']\n"
            "sys.path.insert(0, 'benchmark')\n"
            "import run\n"
            "from harness import (batch, check, inputs, readings, recording,"
            " trace)\n"
            "import modem_tpu_torch.pipeline\n"
            "bad = run.forbidden_modules()\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", prog], cwd=BENCH.parent,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_the_guard_sees_a_forbidden_module(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "modem_tpu", object())
    assert run.forbidden_modules() == ["modem_tpu"]
    monkeypatch.delitem(sys.modules, "modem_tpu")
    monkeypatch.setitem(sys.modules, "modem_tpu_torch_x", object())
    assert "modem_tpu_torch_x" not in run.forbidden_modules()
