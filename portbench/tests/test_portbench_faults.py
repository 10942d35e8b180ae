"""Whole runs on the CPU at a tiny size, with the search and the pose
update in the program's plain versions: a sound run is correct; the
bfloat16 control and each fault planted in the timed path are not.

The faults a registration cell can have: a step that returns its state
unchanged; half of the rows left out, the statistics taken over the rest;
the answer altered where it is produced. No cell spans chips, so no
exchange between chips can be left out.
"""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, check, synth
from portbench.run import ENTRIES, load_cell, run_cell

CELLS = ["terrain1m-point.tiles-near", "terrain1m-point.volume-near",
         "terrain10m-plane.tiles-near"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    line = run_cell(tiny_root, cell, 2**32 + 5, 0.2, False, "cpu")
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_fails(tiny_root, cell):
    import json

    limits = json.loads((tiny_root / "portbench" / "configs"
                         / f"{cell.split('.')[0]}.json").read_text())["limits"]
    got = dict((side, r) for _, side, r in calibrate.readings(
        tiny_root, cell, [77], {77}, "cpu"))
    assert all(got["program"][k] <= limits[k] for k in limits)
    assert any(got["control"][k] > limits[k] for k in limits)


def _unchanged(monkeypatch):
    from iterativeclosestpoint_tpu_torch.models import icp

    monkeypatch.setattr(icp, "kabsch_masked", lambda src, dst, mask, *a, **k:
                        torch.eye(4, dtype=src.dtype, device=src.device))


def _half(monkeypatch):
    from iterativeclosestpoint_tpu_torch.models import icp

    real = icp.iteration_statistics

    def half(dist, weight, *a, **k):
        w = weight.clone()
        w[w.shape[0] // 2:] = 0
        return real(dist, w, *a, **k)

    monkeypatch.setattr(icp, "iteration_statistics", half)


def _altered(monkeypatch):
    from iterativeclosestpoint_tpu_torch.models import icp

    real = icp.package_result

    def altered(*a, **k):
        res = real(*a, **k)
        res.transform = res.transform.copy()
        res.transform[0, 3] += 0.05
        return res

    monkeypatch.setattr(icp, "package_result", altered)


@pytest.mark.parametrize("plant", [_unchanged, _half, _altered],
                         ids=["state-unchanged", "half-the-rows",
                              "answer-altered"])
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, plant):
    plant(monkeypatch)
    line = run_cell(tiny_root, "terrain1m-point.tiles-near", 31, 0.2, False,
                    "cpu")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("altered_pair", [0, 1])
def test_a_pair_the_budget_leaves_out_has_its_final_pose_held(tiny_root,
                                                               altered_pair):
    # One pair of two is followed step by step; the other's final poses
    # are held against the reference's last step over a sample of rows.
    # A final pose moved by 5 cm on either pair is caught.
    spec = load_cell(tiny_root, "terrain10m-plane.tiles-near")
    settings = spec["settings"]
    n = settings["n_points"]
    budget = dict(spec["traffic"]["check"], points=n, final_rows=n // 2)
    pool = synth.make_pool(n, 41, spec["traffic"])
    register = ENTRIES["library"](settings, "cpu")
    regs = [{"index": i, "pair": i, "levels": register(pair)}
            for i, pair in enumerate(pool)]
    sound = check.compare(pool, regs, settings, budget, 41)
    assert sound["pose_m"] <= settings["limits"]["pose_m"]
    regs[altered_pair]["levels"][-1]["T"][0, 3] += 0.05
    moved = check.compare(pool, regs, settings, budget, 41)
    assert moved["pose_m"] > settings["limits"]["pose_m"]
