"""Fixtures of the benchmark's CPU tests: a checkout in miniature.

``tiny_root`` is a directory laid out as a checkout (``BENCHMARK.json``
and ``portbench/{configs,traffic,metrics,entries}``) whose configurations
are the benchmark's own with fewer points and iterations, so a whole run
fits a test on the CPU, where the kernels run their plain versions.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY = {"n_points": 6000, "coarse_max_points": 1500, "max_iterations": 4,
        "coarse_iterations": 6,
        # One correspondence that a float32 near-tie flips moves the pose
        # of a level of a few thousand points by up to ~1e-3 m (7.9e-4 m
        # seen on 5,000 points), twenty times what it does on the cells'
        # 30,000-point coarse level: the cells' limits do not hold here.
        # These stand between the tiny runs' readings (pose_m under
        # 1.4e-4 m, mean_rel under 1.2e-5) and the control's and the
        # faults' (over 0.05 m, and mean_rel over 7e-3).
        "limits": {"pose_m": 1e-2, "mean_rel": 1e-3, "rmse_rel": 1e-3,
                   "valid_share": 1e-3, "stop_gap": 0}}


def make_root(dest: Path) -> Path:
    """A miniature checkout at ``dest``: every cell of ``BENCHMARK.json``
    on its configuration cut to ``TINY``, each mix with pools of two
    pairs, and the metric readers and entries as they are."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = dest / "portbench"
    shutil.copytree(REPO / "portbench" / "metrics", pb / "metrics")
    shutil.copytree(REPO / "portbench" / "entries", pb / "entries")
    shutil.copytree(REPO / "portbench" / "traffic", pb / "traffic")
    (pb / "configs").mkdir(parents=True)
    for conf in bench["configs"]:
        settings = json.loads((REPO / conf["file"]).read_text())
        settings.update(TINY)
        (dest / conf["file"]).write_text(json.dumps(settings))
    for path in (pb / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        n = TINY["n_points"]
        mix.update(pool_points=2 * n, trace_points=n)
        mix["check"]["points"] = 2 * n
        path.write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path / "checkout")


@pytest.fixture(autouse=True)
def _few_threads():
    """Torch on few threads: the plain versions' small blocks stall on
    one thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
