"""The comparison that decides ``correct``.

Each registration the window completed is an answer: its levels, each
with its iteration count, stop code, final pose and per-iteration record
(pose, mean and sigma of the distances, threshold, inliers, RMSE). The
reference (``reference/icp_ref.py``) follows the program step by step:
for a sample of registrations drawn from the seed, it takes the pose the
program held before a step and computes that step again in float64 from
the host inputs, and the program's record of the step is held against it.
Every step of a level of at most ``FULL_LEVEL_ROWS`` source rows is
checked, and of a larger level the first, the last and ``steps`` more
drawn from the seed; ``points`` worth of pairs are checked. The first step of the first level starts from the
identity, so the start is the reference's own. The stop rule (three
changes of RMSE under the tolerance, a rise over 1.1 times, fewer than 3
inliers, the iteration budget) is applied again to the program's record.
Every registration's final pose is held against the reference's last
step of its pair. For a pair that the ``points`` budget leaves out, that
last step alone is worked out again, from the pose the program held
before it, over ``final_rows`` source rows drawn from the seed (the
target whole): every pair a window registered has its final poses held.

The numbers compared, each the largest over what was checked:

- ``pose_m``: metres between where the program's pose and the reference's
  put a corner of the source's box;
- ``mean_rel``, ``rmse_rel``: the gap in the mean distance and the RMSE,
  over the reference's (the nearest neighbours, and the 3-sigma
  rejection);
- ``valid_share``: the gap in the inlier count, over the rows;
- ``stop_gap``: levels whose stop disagrees with the rule.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.icp_ref import (
    fine_level,
    pose_gap,
    registration_levels,
    to_local,
    to_world,
)

FULL_LEVEL_ROWS = 100_000
NUMBERS = ("pose_m", "mean_rel", "rmse_rel", "valid_share", "stop_gap")

# The program's stop codes.
CONVERGED, DIVERGED, TOO_FEW_VALID, MAX_ITERATIONS = 1, 2, 3, 4


def stop_rule_holds(rec: dict, max_iterations: int, tolerance: float,
                    extra=None) -> bool:
    """Whether the level stopped where the rule says, applied in float32
    to the program's recorded RMSEs and inlier counts. ``extra`` is the
    reference's step after the last recorded one, which decides a stop by
    divergence or too few inliers (such a step leaves no record)."""
    f = np.float32
    rmse = rec["hist"]["rmse"]
    valid = rec["hist"]["valid"]
    m = rec["iterations"]
    prev, noimp, tol = f(1e10), 0, f(tolerance)
    for k in range(m):
        r = f(rmse[k])
        small = abs(prev - r) < tol
        noimp = noimp + 1 if small else 0
        conv = small and noimp >= 3
        div = not conv and r > prev * f(1.1)
        few = not conv and not div and valid[k] < 3
        if conv:
            return k == m - 1 and rec["stop"] == CONVERGED
        if div or few:
            return False  # such a step is not recorded
        prev = r
    if m == max_iterations:
        return rec["stop"] == MAX_ITERATIONS
    if rec["stop"] not in (DIVERGED, TOO_FEW_VALID) or extra is None:
        return False
    return bool(extra["rmse"] > float(prev * f(1.1)) or extra["valid"] < 3)


def _sample_steps(rng, m: int, rows: int, steps: int) -> list:
    if rows <= FULL_LEVEL_ROWS or m <= 2:
        return list(range(m))
    middle = rng.permutation(np.arange(1, m - 1))[:steps]
    return sorted({0, m - 1, *middle.tolist()})


def compare(pool: list, regs: list, settings: dict, check: dict, seed: int,
            control: bool = False, log=None) -> dict:
    """The readings of the numbers compared (see the module docstring).
    ``regs`` are the window's registrations that returned; ``control``
    puts the bfloat16 step in the program's place at the same poses."""
    rng = np.random.default_rng([int(seed), 1])
    out = dict.fromkeys(NUMBERS, 0.0)
    present = sorted({r["pair"] for r in regs})
    pairs = max(1, check["points"] // settings["n_points"])
    chosen = rng.permutation(present)[:pairs].tolist()
    if control:
        from portbench.reference.control import LowLevel
    for p in chosen:
        mine = [r for r in regs if r["pair"] == p]
        reg = mine[int(rng.integers(len(mine)))]
        offset, levels = registration_levels(
            pool[p]["source"], pool[p]["target"],
            coarse_max_points=settings["coarse_max_points"],
            estimator=settings["estimator"])
        if [s for s, _ in levels] != [lv["stride"] for lv in reg["levels"]]:
            out["stop_gap"] += 1
            continue
        T_prev = np.eye(4)
        last_ref = None
        for li, ((_, lv), rec) in enumerate(zip(levels, reg["levels"])):
            fine = li == len(levels) - 1
            est = settings["estimator"] if fine else "point"
            tol = settings["tolerance" if fine else "coarse_tolerance"]
            budget = settings["max_iterations" if fine
                              else "coarse_iterations"]
            low = LowLevel(lv) if control else None
            m = rec["iterations"]
            h = rec["hist"]
            for k in _sample_steps(rng, m, len(lv.src), check["steps"]):
                T_k = T_prev if k == 0 else h["T"][k - 1]
                widen = k == 0 and settings["mode"] == "gui"
                T_loc = to_local(T_k, offset)
                ref = lv.step(T_loc, widen=widen, estimator=est)
                if control:
                    got = low.step(T_loc, widen=widen, estimator=est)
                    got["T"] = to_world(got["T"], offset)
                else:
                    got = {"mean": h["mean"][k], "rmse": h["rmse"][k],
                           "valid": h["valid"][k], "T": h["T"][k]}
                T_ref = to_world(ref["T"], offset)
                kept = (not control and k == m - 1
                        and rec["stop"] == CONVERGED)
                if not kept:  # a converged step keeps the previous pose
                    out["pose_m"] = max(out["pose_m"], pose_gap(
                        to_local(got["T"], offset), ref["T"], lv.corners))
                out["mean_rel"] = max(out["mean_rel"], abs(
                    float(got["mean"]) - ref["mean"]) / ref["mean"])
                out["rmse_rel"] = max(out["rmse_rel"], abs(
                    float(got["rmse"]) - ref["rmse"]) / ref["rmse"])
                out["valid_share"] = max(out["valid_share"], abs(
                    int(got["valid"]) - ref["valid"]) / ref["n"])
                if fine and k == m - 1:
                    last_ref = (T_ref, lv.corners)
            if not control:
                extra = None
                if m < budget and rec["stop"] in (DIVERGED, TOO_FEW_VALID):
                    extra = lv.step(to_local(rec["T"], offset), widen=False,
                                    estimator=est)
                if not stop_rule_holds(rec, budget, tol, extra):
                    out["stop_gap"] += 1
            T_prev = rec["T"]
        if last_ref is not None and not control:
            T_ref, corners = last_ref
            for r in mine:
                out["pose_m"] = max(out["pose_m"], pose_gap(
                    to_local(r["levels"][-1]["T"], offset),
                    to_local(T_ref, offset), corners))
        if log:
            log(f"check: pair {p} (registration {reg['index']}) "
                + ", ".join(f"{k} {v:.6g}" for k, v in out.items()))
    if not control:
        for p in (p for p in present if p not in chosen):
            gap = _final_pose_gap(pool[p], [r for r in regs
                                            if r["pair"] == p],
                                  settings, check["final_rows"], rng)
            out["pose_m"] = max(out["pose_m"], gap)
            if log:
                log(f"check: pair {p}, final poses over "
                    f"{check['final_rows']} rows: pose_m {gap:.6g}")
    return {k: float(v) for k, v in out.items()}


def _final_pose_gap(pair: dict, mine: list, settings: dict, rows: int,
                    rng) -> float:
    """The largest gap between the final pose of a registration of the
    pair and the reference's last fine step from the pose one of them
    (drawn from the seed) held before it, over ``rows`` source rows."""
    reg = mine[int(rng.integers(len(mine)))]
    rec = reg["levels"][-1]
    m = rec["iterations"]
    if m >= 2:
        T_before = rec["hist"]["T"][m - 2]
    else:
        T_before = (reg["levels"][-2]["T"] if len(reg["levels"]) > 1
                    else np.eye(4))
    offset, lv = fine_level(pair["source"], pair["target"],
                            estimator=settings["estimator"], rows=rows,
                            rng=rng)
    ref = lv.step(to_local(T_before, offset),
                  widen=m == 1 and settings["mode"] == "gui",
                  estimator=settings["estimator"])
    return max(pose_gap(to_local(r["levels"][-1]["T"], offset), ref["T"],
                        lv.corners) for r in mine)
