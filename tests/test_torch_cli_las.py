"""``icp-torch run --multiscale --mode cli`` on LAS files written by the
plain LAS writer (``portbench/reference/las_ref.py``), held by the
benchmark's ``cli`` entry (``portbench/entries/cli.py``) against the
plain float64 reference's fine steps and the plain writer's rounding of
its output: a seeded ~20,000-point terrain pair at UTM offsets, with the
configuration ``terrain1m-las``'s settings and limits but 3 fine
iterations.

The configuration's coarse settings are not options of the verb: they
hold only while they are icp_register_multiscale's defaults, which this
file checks too.
"""

import inspect
import json
from pathlib import Path

import numpy as np
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu_torch.cli import main as cli_main
from iterativeclosestpoint_tpu_torch.models.multiscale import (
    icp_register_multiscale,
)
from iterativeclosestpoint_tpu_torch.utils.config import ICPConfig
from portbench.reference import las_ref
from portbench.run import entry_module, load_cell

REPO = Path(__file__).resolve().parents[1]
CELL = "terrain1m-las.las-near"


def test_the_configuration_is_what_the_verb_runs():
    settings = load_cell(REPO, CELL)["settings"]
    defaults = inspect.signature(icp_register_multiscale).parameters
    for key in ("coarse_max_points", "coarse_iterations", "coarse_tolerance"):
        assert settings[key] == defaults[key].default
    cfg = ICPConfig()
    for key in ("nn_backend", "estimator", "sigma_multiplier"):
        assert settings[key] == getattr(cfg, key)
    ICPConfig(tolerance=settings["tolerance"],
              max_iterations=settings["max_iterations"],
              mode=settings["mode"]).validate()


def test_run_on_las_files_matches_the_plain_reference():
    spec = load_cell(REPO, CELL)
    entry = entry_module(REPO, spec["traffic"]["entry"])
    n = 20_000
    settings = dict(spec["settings"], n_points=n, max_iterations=3)
    traffic = dict(spec["traffic"], pool_points=n, pool_min=1)
    (item,) = entry.pool(settings, 2**32 + 17, traffic)
    hdr = las_ref.read_header(item["source_path"])
    assert hdr["point_data_format"] == 1 and hdr["offset"][0] >= 499_000
    rc = cli_main(["--device", "cpu", "run", str(item["source_path"]),
                   str(item["target_path"]), "--multiscale", "--mode", "cli",
                   "--max-iterations", "3", "--tolerance", "1e-10",
                   "-o", str(item["out"]), "--report", str(item["report"])])
    assert rc == 0
    report = json.loads(item["report"].with_suffix(".json").read_text())
    assert report["stop_reason"] == 4 and report["success"]
    levels = [entry.report_record(item["report"].with_suffix(".json"), rc,
                                  item["out"])]
    assert entry.complete(settings, levels)
    assert entry.work(settings, levels) == 3 * n
    done = [{"index": 0, "pair": 0, "levels": levels}]
    got = entry.compare([item], done, settings, spec["traffic"]["check"],
                        17)
    limits = settings["limits"]
    assert all(got[k] <= limits[k] for k in entry.NUMBERS), got
    # The output is the registered source in the source file's scale and
    # offset, every row within one quantum of the plain writer's.
    out = las_ref.read(item["out"])
    assert out["header"]["offset"] == hdr["offset"]
    T = levels[0]["T"]
    moved = item["source"] @ T[:3, :3].T + T[:3, 3]
    assert np.abs(out["xyz"] - moved).max() <= 1.5e-3
    assert got["out_q_max"] <= 1 and got["stop_gap"] == 0
