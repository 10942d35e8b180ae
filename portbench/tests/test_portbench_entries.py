"""A deployment brings its own entry as files: what it calls, its pool,
its work count and its check (``entries/<name>.py``), with a
configuration, a mix, a cell and a metric that reads one of its counters
from ``ctx["meta"]``, and no file that is there edited."""

from __future__ import annotations

import json

import pytest

from portbench.run import run_cell

# Inputs that are not tile pairs: vectors of widgets, each call sums one
# under a span that counts its widgets.
DUMMY_ENTRY = '''
import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.runtime import timing

NUMBERS = ("gap",)


def pool(settings, seed, traffic):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=settings["widgets"])
            for _ in range(traffic["items"])]


def points(settings):
    return settings["widgets"]


def entry(settings, device):
    def call(item):
        with timing.stage("dummy/sum"):
            timing.count("widgets", len(item))
            total = float(torch.as_tensor(item, device=device).sum())
        return {"sum": total + settings["bias"], "steps": 3}

    return call


def iterations(settings, record):
    return record["steps"]


def work(settings, record):
    return settings["widgets"] * record["steps"]


def complete(settings, record):
    return bool(np.isfinite(record["sum"]))


def compare(pool, done, settings, check, seed, log=None):
    return {"gap": max(abs(r["levels"]["sum"] - float(pool[r["pair"]].sum()))
                       for r in done)}
'''

COUNTER_METRIC = '''
def read(ctx):
    meta = ctx["meta"].get("dummy/sum")
    if not meta or not ctx["synced"]:
        return None
    return meta["widgets"] / ctx["synced"]
'''


def _snapshot(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add_dummy(root, bias=0.0):
    """The dummy entry, its configuration, mix, cell and counter metric,
    as new files and new entries of ``BENCHMARK.json``."""
    pb = root / "portbench"
    (pb / "entries" / "dummy-sum.py").write_text(DUMMY_ENTRY)
    (pb / "metrics" / "dummy_widgets.py").write_text(COUNTER_METRIC)
    (pb / "configs" / "widgets.json").write_text(json.dumps(
        {"widgets": 5000, "bias": bias, "limits": {"gap": 1e-9}}))
    (pb / "traffic" / "sums.json").write_text(json.dumps(
        {"entry": "dummy-sum", "items": 3, "trace_points": 10000,
         "check": {}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "widgets", "source": "x",
                             "file": "portbench/configs/widgets.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "widgets.sums", "config": "widgets",
                               "traffic": "sums", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy_widgets", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "dummy", "moves": "icp_pts_per_s",
                               "workloads": ["widgets.sums"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_entry_runs_as_files_alone(tiny_root):
    before = _snapshot(tiny_root)
    bench_before = json.loads((tiny_root / "BENCHMARK.json").read_text())
    _add_dummy(tiny_root)
    plain = run_cell(tiny_root, "widgets.sums", 2**32 + 9, 0.3, False, "cpu")
    traced = run_cell(tiny_root, "widgets.sums", 2**32 + 9, 0.3, True, "cpu")
    for line in (plain, traced):
        assert line["correct"], line["checks"]
        assert list(line["checks"]) == ["gap", "failed"]
        assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(plain["metrics"]) == {"icp_pts_per_s", "setup_s"}
    # The counter the entry counted, read by a metric file from ctx["meta"].
    assert traced["metrics"] == {"dummy_widgets": {"value": 5000.0,
                                                   "unit": "1"}}
    after = _snapshot(tiny_root)
    changed = [str(p) for p, data in before.items()
               if p.name != "BENCHMARK.json" and after[p] != data]
    assert changed == []
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for key, old in bench_before.items():
        assert bench[key] == old or bench[key][:len(old)] == old


@pytest.mark.parametrize("bias, correct", [(0.0, True), (0.5, False)])
def test_the_entry_compare_decides_correct(tiny_root, bias, correct):
    _add_dummy(tiny_root, bias)
    line = run_cell(tiny_root, "widgets.sums", 12, 0.2, False, "cpu")
    assert line["correct"] is correct
    assert (line["checks"]["gap"]["value"] > 1e-9) is not correct
