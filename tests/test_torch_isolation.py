"""The port stands alone: importing it loads neither JAX nor the JAX
package, nor do the multi-process test workers (they run where JAX is
not installed), a CUDA request without CUDA raises instead of running on
the CPU (through the library and through ``icp-torch``), and
``chip_smoke.py`` refuses to run without a card. Each check runs in a
fresh interpreter, where nothing else has imported JAX yet."""

import json
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
        "expected = {'ops.normals', 'ops.downsample', 'io.las', 'cli',\n"
        "    'utils.config', 'runtime.native', 'runtime.checkpoint',\n"
        "    'runtime.metrics', 'runtime.viz', 'runtime.htmlviz',\n"
        "    'runtime.session', 'runtime.profiling', 'runtime.smoke',\n"
        "    'models.posegraph', 'ops.hashgrid', 'ops.cellblock',\n"
        "    'parallel', 'parallel.mesh', 'parallel.sharded',\n"
        "    'parallel.partition', 'parallel.posegraph', 'parallel.ingest',\n"
        "    'utils.oracle', 'bench'}\n"
        "missing = {e for e in expected if p.__name__ + '.' + e not in names}\n"
        "assert not missing, missing\n"
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


PACKAGE_EXPORTS = ["AppSettings", "ICPConfig", "ICPResult", "icp_register",
                   "icp_register_multiscale", "optimize_pose_graph",
                   "register_scans", "__version__"]
OPS_EXPORTS = ["apply_transform", "compose", "identity_transform",
               "rotation_angle_deg", "se3_from_euler", "translation_norm",
               "kabsch", "kabsch_masked", "nn_bruteforce"]


def test_exports_are_the_jax_packages():
    """The port's package and ``ops`` export the JAX package's names, each
    bound to the port's own object, without loading JAX."""
    code = (
        "import json, sys\n"
        "import iterativeclosestpoint_tpu_torch as p\n"
        "from iterativeclosestpoint_tpu_torch import ops\n"
        "for mod, names in ((p, p.__all__), (ops, ops.__all__)):\n"
        "    for n in names:\n"
        "        v = getattr(mod, n)\n"
        "        assert n == '__version__' or v.__module__.startswith(\n"
        "            'iterativeclosestpoint_tpu_torch.'), (n, v.__module__)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'iterativeclosestpoint_tpu'"
        " or m.startswith('iterativeclosestpoint_tpu.')]\n"
        "assert not bad, bad\n"
        "print('EXPORTS', json.dumps([p.__all__, ops.__all__,"
        " p.__version__]))\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("EXPORTS "))
    pkg, ops, version = json.loads(line[len("EXPORTS "):])
    assert pkg == PACKAGE_EXPORTS and ops == OPS_EXPORTS
    import iterativeclosestpoint_tpu as jax_pkg
    import iterativeclosestpoint_tpu.ops as jax_ops

    assert pkg == jax_pkg.__all__ and ops == jax_ops.__all__
    assert version == jax_pkg.__version__


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


@pytest.mark.parametrize("argv", [
    ["run", "s.las", "t.las", "--max-iterations", "1"],
    ["--device", "cuda", "smoke"],
])
def test_cli_without_cuda_exits_nonzero(tmp_path, argv):
    """``icp-torch`` without ``--device cpu`` and without CUDA exits
    non-zero with the reason; it does not run on the CPU instead."""
    code = (
        "import sys\n"
        "from iterativeclosestpoint_tpu_torch.cli import main\n"
        "from iterativeclosestpoint_tpu_torch.io.las import write_las\n"
        "from iterativeclosestpoint_tpu_torch.utils.synth import "
        "make_registration_pair\n"
        "src, tgt, _ = make_registration_pair(n=200, seed=1)\n"
        f"write_las({str(tmp_path / 's.las')!r}, src)\n"
        f"write_las({str(tmp_path / 't.las')!r}, tgt)\n"
        f"sys.exit(main({argv!r}))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "PYTHONPATH": str(ROOT)},
    )
    assert r.returncode != 0, r.stdout + r.stderr
    assert "is_available() is false" in r.stdout
    assert "starting ICP registration" not in r.stdout
    assert "smoke[" not in r.stdout


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


@pytest.mark.parametrize("worker", ["_torch_multihost_worker",
                                    "_torch_failure_worker"])
def test_workers_load_neither_jax_nor_the_jax_package(worker):
    """A multi-process worker's own module and every port module it
    reaches import no JAX."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        f"import {worker}\n"
        "import iterativeclosestpoint_tpu_torch.parallel\n"
        "import iterativeclosestpoint_tpu_torch.runtime.checkpoint\n"
        "import iterativeclosestpoint_tpu_torch.models.posegraph\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'iterativeclosestpoint_tpu'"
        " or m.startswith('iterativeclosestpoint_tpu.')]\n"
        "print('LOADED', bad)\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout
    source = (ROOT / "tests" / f"{worker}.py").read_text()
    assert "import jax" not in source
    assert "iterativeclosestpoint_tpu." not in source
