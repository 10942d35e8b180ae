"""The port stands alone: importing it loads neither JAX nor the JAX
package, a CUDA request without CUDA raises instead of running on the CPU,
and ``chip_smoke.py`` refuses to run without a card. Each check runs in a
fresh interpreter, where nothing else has imported JAX yet."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, **env},
    )


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib\n"
        "import iterativeclosestpoint_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, p.__name__ + '.')]\n"
        "assert 'iterativeclosestpoint_tpu_torch.ops.normals' in names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'iterativeclosestpoint_tpu'"
        " or m.startswith('iterativeclosestpoint_tpu.')]\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_request_without_cuda_raises(device):
    code = (
        "import numpy as np\n"
        "from iterativeclosestpoint_tpu_torch import icp_register\n"
        "from iterativeclosestpoint_tpu_torch.utils.synth import "
        "make_registration_pair\n"
        "src, tgt, _ = make_registration_pair(n=200, seed=1)\n"
        "try:\n"
        f"    icp_register(src, tgt, max_iterations=1, device={device!r})\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n"
        "else:\n"
        "    print('RAN')\n"
    )
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr
    assert "RAISED" in r.stdout and "is_available() is false" in r.stdout


def test_chip_smoke_refuses_without_cuda():
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    source = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in source
    assert "iterativeclosestpoint_tpu." not in source
