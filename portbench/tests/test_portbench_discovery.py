"""Cells, configurations, mixes and metrics are found by name, so a later
change adds them as files and entries, never by editing a file."""

from __future__ import annotations

import json

from portbench.run import load_cell, metric_reader, run_cell


def _add_dummies(root):
    """A new configuration, mix, per-layer metric and cell, as files and
    entries only."""
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "terrain1m-point.json").read_text())
    conf["n_points"] = 5000
    (pb / "configs" / "dummy-cfg.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "tiles.json").read_text())
    mix["kind"] = "sphere"
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "dummy_count.py").write_text(
        "def read(ctx):\n    return float(ctx['synced'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-cfg", "source": "x",
                             "file": "portbench/configs/dummy-cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy-cfg.dummy-mix",
                               "config": "dummy-cfg", "traffic": "dummy-mix",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy_count", "unit": "1",
                               "better": "higher", "source": "program_span",
                               "layer": "dummy", "moves": "icp_pts_per_s",
                               "workloads": ["dummy-cfg.dummy-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_are_found_by_name(tiny_root):
    _add_dummies(tiny_root)
    spec = load_cell(tiny_root, "dummy-cfg.dummy-mix")
    assert spec["settings"]["n_points"] == 5000
    assert spec["traffic"]["kind"] == "sphere"
    assert [m["name"] for m in spec["per_layer"]] == ["dummy_count"]
    assert [m["name"] for m in spec["end_to_end"]] == ["icp_pts_per_s",
                                                       "setup_s"]
    assert metric_reader(tiny_root, "dummy_count")({"synced": 3}) == 3.0
    # The other cells do not report the new metric.
    tiles = load_cell(tiny_root, "terrain1m-point.tiles-near")
    assert "dummy_count" not in [m["name"] for m in tiles["per_layer"]]


def test_a_new_cell_runs_with_its_new_metric(tiny_root):
    _add_dummies(tiny_root)
    line = run_cell(tiny_root, "dummy-cfg.dummy-mix", 4, 0.5, True, "cpu")
    assert line["metrics"]["dummy_count"]["value"] >= 0
    assert line["device"]["platform"] == "cpu"
