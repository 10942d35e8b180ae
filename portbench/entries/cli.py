"""The entry ``cli``: one ``icp-torch run`` of a tile pair on LAS files,
in-process, as the reference console program's batch runs
(``icp_registration.cpp:817-949``: two LAS files in, the registration, a
registered LAS and a transform report out).

Pool: ``synth.make_pool``'s pairs, each written in set-up by the plain
writer (``reference/las_ref.py``) as two LAS 1.2 files of the
configuration's point format and scale, each file's offset at its
tile's lower-left corner in whole metres, under a directory of
``TMPDIR`` that is removed when the process ends. An item holds the
files' paths and the coordinates the plain reader decodes from them,
which the check holds the program to.

Call: ``cli.main(["--device", <type>, "run", src, tgt, "--multiscale",
"--mode", ..., "--max-iterations", ..., "--tolerance", ..., "-o",
out_<pair>.las, "--report", out_<pair>.txt])``, its stdout appended to a
log file beside them, as a batch job's would be. The pair's output and
report are removed first, so a call that writes neither is seen to.
``cmd_run`` returns 1 where the result's ``success`` is false (a stop for
too few inliers, by the user or on a numerical error) and 0 otherwise:
20 fine iterations that end without converging stop with code 4
(``MAX_ITERATIONS``), a success, and so does a stop by convergence (1)
or divergence (2). A call that returns anything but 0 has failed.

Record: the fine level as the report's ``.json`` gives it (``levels``
of one entry, so the harness's readers of ``levels[-1]`` read it): its
iterations, stop code, final pose and per-iteration record, the
verb's exit code, the output's path and its header's point count. The
report has no coarse level: the verb writes the result's last level
alone. Work: source points × the fine iterations the report records;
an early stop is less work, not a failure. Failed: a call that raises,
returns non-zero, writes no report or no output, gives a non-finite
pose, or writes an output whose point count is not the source's.

``compare`` decides ``correct`` from two things:

- the report against the float64 reference (``reference/icp_ref.py``)
  on the coordinates the plain reader decodes, with ``check.py``'s
  numbers. The report gives no pose before the first fine step (the
  coarse level's result is not recorded), so the first fine step is
  redone only where the pyramid has one level and that pose is the
  identity; of the other steps, for one registration of each of
  ``check.points`` worth of pairs, one drawn from the seed and the last,
  then the stop rule on the report and every final pose against its
  pair's last reference step. A pair the budget leaves out has that
  last step alone redone over ``check.final_rows`` source rows. The
  library cells check the coarse level on the same code;
- each pair's last written LAS, read back by the plain reader:
  ``out_q_max`` is the largest gap, in quanta, between a written row and
  the plain writer's rounding of the report's final pose applied to the
  decoded source row; ``out_rows_off`` the share of source rows written
  otherwise (a row missing counts); ``header_gap`` the header fields the
  CLI's writer keeps from the source (scale, offset, point count) that
  differ from the source's.

``python3 -m portbench.entries.cli --workload <cell> --seeds 1 2 3
--control-seeds 1`` prints the readings the limits are set from: each
pair of the pool registered once through this entry, then ``compare``'s
readings, and for the control seeds the bfloat16 control's
(``reference/control.py``) at the same poses, with the written rows
computed in bfloat16 too.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

from portbench import check as icp_check
from portbench import synth
from portbench.reference import las_ref
from portbench.reference.icp_ref import (
    center_offset,
    fine_level,
    level_strides,
    pose_gap,
    to_local,
    to_world,
)

NUMBERS = icp_check.NUMBERS + ("out_q_max", "out_rows_off", "header_gap")
# The header fields the CLI's writer keeps from the source file.
KEPT = ("scale", "offset", "number_of_point_records")


def pool(settings: dict, seed: int, traffic: dict) -> list:
    """The pool's pairs as LAS files, with the coordinates the plain
    reader decodes from them."""
    folder = Path(tempfile.mkdtemp(prefix="portbench-las-"))
    atexit.register(shutil.rmtree, folder, ignore_errors=True)
    scale = (settings["las_scale"],) * 3
    items = []
    for i, pair in enumerate(synth.make_pool(settings["n_points"], seed,
                                             traffic)):
        item = {"log": folder / "icp-torch.log",
                "out": folder / f"out_{i}.las",
                "report": folder / f"out_{i}.txt"}
        for side in ("source", "target"):
            path = folder / f"{side}_{i}.las"
            xyz = pair[side]
            las_ref.write(path, xyz, scale=scale,
                          offset=tuple(np.floor(xyz.min(axis=0))),
                          point_format=settings["las_point_format"],
                          gps_time=np.arange(len(xyz)) * 1e-5)
            back = las_ref.read(path)
            item[side] = back["xyz"]
            item[f"{side}_path"] = path
            if side == "source":
                item["header"] = back["header"]
        items.append(item)
    return items


def points(settings: dict) -> int:
    return settings["n_points"]


def entry(settings: dict, device):
    """One ``icp-torch run`` of a pool item; returns its record."""
    import torch

    from iterativeclosestpoint_tpu_torch import cli

    dev = torch.device(device).type
    options = ["--multiscale", "--mode", settings["mode"],
               "--max-iterations", str(settings["max_iterations"]),
               "--tolerance", repr(settings["tolerance"])]

    def call(item):
        for path in (item["out"], item["report"],
                     item["report"].with_suffix(".json")):
            path.unlink(missing_ok=True)
        argv = ["--device", dev, "run", str(item["source_path"]),
                str(item["target_path"]), *options, "-o", str(item["out"]),
                "--report", str(item["report"])]
        with open(item["log"], "a") as log, contextlib.redirect_stdout(log):
            rc = cli.main(argv)
        return [report_record(item["report"].with_suffix(".json"), rc,
                              item["out"])]

    return call


def report_record(json_path: Path, rc: int, out: Path) -> dict:
    """What the check reads of a call: the report's fine level, the exit
    code, the output's path and its header's point count (None where a
    file is missing)."""
    rec = {"stride": 1, "rc": int(rc), "out": out,
           "out_points": (las_ref.read_header(out)["number_of_point_records"]
                          if out.exists() else None)}
    if not json_path.exists():
        return {**rec, "iterations": 0, "stop": 0, "T": None, "hist": None}
    rep = json.loads(json_path.read_text())
    hist = rep["history"]
    return {**rec, "iterations": int(rep["iterations"]),
            "stop": int(rep["stop_reason"]),
            "T": np.array(rep["transform"], np.float64),
            "hist": {
                "T": np.array([h["transform"] for h in hist],
                              np.float64).reshape(-1, 4, 4),
                "rmse": np.array([h["rmse"] for h in hist]),
                "mean": np.array([h["mean_dist"] for h in hist]),
                "valid": np.array([h["valid_points"] for h in hist]),
            }}


def iterations(settings: dict, levels: list) -> int:
    return levels[-1]["iterations"]


def work(settings: dict, levels: list) -> float:
    return settings["n_points"] * levels[-1]["iterations"]


def complete(settings: dict, levels: list) -> bool:
    rec = levels[-1]
    return (rec["rc"] == 0 and rec["T"] is not None
            and bool(np.isfinite(rec["T"]).all())
            and rec["out_points"] == settings["n_points"])


def compare(pool: list, done: list, settings: dict, check: dict, seed: int,
            log=None, control: bool = False) -> dict:
    """The readings of the numbers compared (see the module docstring);
    ``control`` puts the bfloat16 reference in the program's place."""
    rng = np.random.default_rng([int(seed), 1])
    out = dict.fromkeys(NUMBERS, 0.0)
    done = [r for r in done if r["levels"][-1]["T"] is not None]
    present = sorted({r["pair"] for r in done})
    chosen = rng.permutation(present)[
        :max(1, check["points"] // settings["n_points"])].tolist()
    single = level_strides(settings["n_points"],
                           settings["coarse_max_points"]) == (1,)
    for p in present:
        mine = [r for r in done if r["pair"] == p]
        reg = mine[int(rng.integers(len(mine)))]["levels"][-1]
        rows = (settings["n_points"] if p in chosen
                else check["final_rows"])
        offset, lv = fine_level(pool[p]["source"], pool[p]["target"],
                                estimator=settings["estimator"], rows=rows,
                                rng=rng)
        _steps(out, settings, check, rng, reg, mine, offset, lv,
               follow=p in chosen, single=single, control=control)
        last = max(mine, key=lambda r: r["index"])["levels"][-1]
        _output(out, pool[p], last, control)
        if log:
            how = "followed" if p in chosen else f"last step, {rows} rows"
            log(f"check: pair {p} ({how}) "
                + ", ".join(f"{k} {v:.6g}" for k, v in out.items()))
    return {k: float(v) for k, v in out.items()}


def _steps(out, settings, check, rng, rec, mine, offset, lv, *, follow,
           single, control):
    """The report's fine steps that can be redone, against the
    reference's (``follow``: a drawn step and the last, and the stop
    rule; else the last alone), and every final pose of the pair against
    the reference's last step."""
    m = rec["iterations"]
    first = 0 if single else 1  # the pose before step 0 is not recorded
    middle = rng.permutation(np.arange(first, max(first, m - 1)))
    ks = sorted({m - 1, *middle[:check["steps"]].tolist()} if follow
                else {m - 1})
    ks = [k for k in ks if k >= first]
    low = None
    if control:
        from portbench.reference.control import LowLevel

        low = LowLevel(lv)
    est = settings["estimator"]
    T_ref = None
    for k in ks:
        T_k = np.eye(4) if k == 0 else rec["hist"]["T"][k - 1]
        widen = k == 0 and settings["mode"] == "gui"
        T_loc = to_local(T_k, offset)
        ref = lv.step(T_loc, widen=widen, estimator=est)
        if control:
            got = low.step(T_loc, widen=widen, estimator=est)
            got["T"] = to_world(got["T"], offset)
        else:
            h = rec["hist"]
            got = {"mean": h["mean"][k], "rmse": h["rmse"][k],
                   "valid": h["valid"][k], "T": h["T"][k]}
        kept = (not control and k == m - 1
                and rec["stop"] == icp_check.CONVERGED)
        if not kept:  # a converged step keeps the previous pose
            out["pose_m"] = max(out["pose_m"], pose_gap(
                to_local(got["T"], offset), ref["T"], lv.corners))
        if follow:
            out["mean_rel"] = max(out["mean_rel"], abs(
                float(got["mean"]) - ref["mean"]) / ref["mean"])
            out["rmse_rel"] = max(out["rmse_rel"], abs(
                float(got["rmse"]) - ref["rmse"]) / ref["rmse"])
            out["valid_share"] = max(out["valid_share"], abs(
                int(got["valid"]) - ref["valid"]) / ref["n"])
        if k == m - 1:
            T_ref = ref["T"]
    if control:
        return
    if follow:
        extra = None
        if (m < settings["max_iterations"]
                and rec["stop"] in (icp_check.DIVERGED,
                                    icp_check.TOO_FEW_VALID)):
            extra = lv.step(to_local(rec["T"], offset), widen=False,
                            estimator=est)
        if not icp_check.stop_rule_holds(rec, settings["max_iterations"],
                                         settings["tolerance"], extra):
            out["stop_gap"] += 1
    if T_ref is not None:
        for r in mine:
            out["pose_m"] = max(out["pose_m"], pose_gap(
                to_local(r["levels"][-1]["T"], offset), T_ref, lv.corners))


def _output(out, item, rec, control):
    """The pair's last written LAS against the plain writer's rounding of
    the report's final pose applied to the decoded source (in bfloat16
    for the control)."""
    hdr = item["header"]
    xyz = item["source"]
    T = rec["T"]
    if control:
        import torch

        c = center_offset(item["target"])
        T_loc = torch.as_tensor(to_local(T, c)).to(torch.bfloat16)
        moved = (torch.as_tensor(xyz - c).to(torch.bfloat16)
                 @ T_loc[:3, :3].T + T_loc[:3, 3])
        got = las_ref.quantise(moved.double().numpy() + c, hdr["scale"],
                               hdr["offset"])
        out_hdr = hdr
    else:
        written = las_ref.read(rec["out"])
        got, out_hdr = written["ints"], written["header"]
    want = las_ref.quantise(xyz @ T[:3, :3].T + T[:3, 3], hdr["scale"],
                            hdr["offset"])
    n = min(len(got), len(want))
    gap = np.abs(got[:n].astype(np.int64) - want[:n]).max(axis=1)
    out["out_q_max"] = max(out["out_q_max"], float(gap.max(initial=0)))
    off = int((gap > 0).sum()) + abs(len(got) - len(want))
    out["out_rows_off"] = max(out["out_rows_off"], off / len(want))
    out["header_gap"] = max(out["header_gap"], sum(
        out_hdr[k] != hdr[k] for k in KEPT))


def main(argv=None) -> int:
    from portbench.run import ROOT, cache_dirs, entry_module, load_cell, log

    p = argparse.ArgumentParser(prog="python3 -m portbench.entries.cli")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    spec = load_cell(ROOT, args.workload)
    settings, traffic = spec["settings"], spec["traffic"]
    me = entry_module(ROOT, traffic["entry"])
    call = me.entry(settings, args.device)
    for seed in args.seeds:
        items = me.pool(settings, seed, traffic)
        done = [{"index": i, "pair": i, "levels": call(item)}
                for i, item in enumerate(items)]
        sides = ["program"] + (["control"] if seed in args.control_seeds
                               else [])
        for side in sides:
            r = me.compare(items, done, settings, traffic["check"], seed,
                           control=side == "control")
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **r}), flush=True)
            log(f"{side} seed {seed}: {r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
