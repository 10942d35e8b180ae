"""The benchmark's command: no card, no result; on the card, a short run of
each cell is correct.

The card tests carry the repository's ``cuda`` marker and skip here; run
them on the card from the checkout's root with
``python3 -m pytest -m cuda portbench/tests/test_portbench_card.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, seconds, env=None, trace=0):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", str(seconds),
         "--trace", str(trace)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)


def test_without_a_card_no_result_and_a_failing_exit():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(CELLS[0], 1, env)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no card" in out.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_on_the_card_is_correct(card, cell):
    out = _run(cell, 3, trace=1)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
