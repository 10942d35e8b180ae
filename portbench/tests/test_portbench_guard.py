"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.guard import forbidden_modules

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names, found", [
    (["iterativeclosestpoint_tpu_torch", "iterativeclosestpoint_tpu_torch.x",
      "jaxtyping", "flaxen", "numpy"], []),
    (["iterativeclosestpoint_tpu.ops.se3"], ["iterativeclosestpoint_tpu"]),
    (["jax.numpy", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_top_level_names_are_compared_whole(names, found):
    assert forbidden_modules(names) == found


def test_a_run_loads_no_forbidden_module():
    """The harness, the reference, the control and every module of the
    port that a run reaches, imported in a fresh process."""
    code = (
        "import portbench.run, portbench.check, portbench.calibrate\n"
        "import portbench.reference.control\n"
        "import iterativeclosestpoint_tpu_torch.models.multiscale\n"
        "import iterativeclosestpoint_tpu_torch.cli\n"
        "from portbench.guard import forbidden_modules\n"
        "print(forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    (REPO / "portbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "numpy", "scipy", "torch",
                              "portbench"}


@pytest.mark.parametrize("path", sorted(
    (REPO / "portbench").rglob("*.py")), ids=lambda p: str(p.name))
def test_no_file_reads_the_jax_benchmark(path):
    text = path.read_text()
    imports = _imports(path)
    assert not imports & {"jax", "jaxlib", "flax", "iterativeclosestpoint_tpu",
                          "bench"}
    if path.parent.name != "tests":
        assert "BENCH_r" not in text and "bench.py" not in text
