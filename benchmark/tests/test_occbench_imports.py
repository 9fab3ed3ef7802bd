"""What the benchmark imports: nothing of JAX, flax or the JAX package
(top-level names compared whole: the program's name begins with the JAX
package's), and in the reference nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import run

FILES = sorted(p for p in run.HERE.rglob("*.py")
               if "tests" not in p.relative_to(run.HERE).parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(run.HERE)))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((run.HERE / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "contextlib", "dataclasses", "math",
                    "typing", "torch"}


def test_whole_name_match(monkeypatch):
    monkeypatch.setitem(sys.modules, "gaussianformer_tpu_torch_x",
                        sys.modules[__name__])
    assert "gaussianformer_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gaussianformer_tpu.ops",
                        sys.modules[__name__])
    assert "gaussianformer_tpu.ops" in run.forbidden_modules()


def test_reference_loads_no_program_module():
    code = ("import sys; import benchmark.reference.model, "
            "benchmark.check, benchmark.work.flops; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    tops = set(eval(out))
    assert not tops & {"gaussianformer_tpu_torch", *run.FORBIDDEN}
