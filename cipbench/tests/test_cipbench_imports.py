"""Nothing a run executes imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from cipbench.run import BANNED, banned_modules

from .conftest import ROOT

HARNESS = ROOT / "cipbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(folder):
    return [p for p in folder.rglob("*.py") if "tests" not in p.parts]


def test_no_jax_in_the_harness():
    for path in _sources(HARNESS):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(BANNED), path


def test_no_jax_in_the_program():
    # What the harness drives: the port's package.
    for path in (ROOT / "ska_sdp_cip_tpu_torch").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(BANNED), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources(HARNESS / "reference"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "ska_sdp_cip_tpu_torch" not in tops, path
        assert tops <= {"__future__", "math", "numpy", "torch"}, (path, tops)


def test_a_run_loads_no_jax(tiny_root):
    # A whole CPU run in a fresh process, then the run-time guard.
    code = (
        "import sys, torch; from pathlib import Path; from cipbench import run;"
        f"cell = run.load_cell(Path({str(tiny_root)!r}), 'csd3-10k.snapshot');"
        "run.run_cell(cell, 3, 0.1, False, torch.device('cpu'));"
        "print(run.banned_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_guard_compares_whole_top_level_names():
    assert banned_modules(["ska_sdp_cip_tpu_torch.ops", "numpy"]) == []
    assert banned_modules(["ska_sdp_cip_tpu.ops.fft"]) == ["ska_sdp_cip_tpu"]
    assert banned_modules(["jax._src", "flax"]) == ["flax", "jax"]
