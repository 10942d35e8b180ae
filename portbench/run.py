"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the checkout's root. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration, ``configs/<config>.json``, and a traffic mix,
``traffic/<traffic>.json``; a per-layer metric is read by
``metrics/<name>.py``. Nothing else here knows a cell, a mix or a metric.

A run: a pool of distinct tile pairs made from the seed (set-up), one
warm-up registration of each pair (set-up), then a closed loop of one
client for ``--seconds``: each registration takes the next pair and the
next starts when it has returned, until the time is up; the window ends
when the last one returns. Then, with the program's state freed, the
reference checks what the window returned (``check.py``). With
``--trace 1`` the first ``trace_points`` worth of registrations run under
``torch.profiler`` (the card's activity only) with the program's stage
spans taken unsynced, as many again with neither (the walls the profiled
ones are held against), and the rest with the spans synced, which is what
the span metrics read.

The last stdout line is the result: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, ``breakdown`` (traced runs) and, last, ``checks``
(each compared number with its limit), which also end stderr. No result is
printed, and the exit code is not 0, where no card is found, where a
forbidden module was loaded, or where the run fails.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

from portbench.guard import forbidden_modules

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entries, found by name: the cell, its configuration and
    traffic files, and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(m):
        return workload in m.get("workloads", [workload])

    return {
        "cell": cell,
        "settings": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((root / "portbench" / "traffic"
                               / f"{cell['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def metric_reader(root: Path, name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_dirs(root: Path) -> None:
    """Build and kernel caches of the program inside the checkout, at
    fixed paths (the port builds its kernels into ``build/kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / "build" / "portbench" / sub))
    os.environ.setdefault("USE_FLAX", "0")


def library_entry(settings: dict, device):
    """One registration through ``icp_register_multiscale`` on the
    pair's host float64 arrays; returns its record (``check.py``)."""
    import torch

    from iterativeclosestpoint_tpu_torch.models.multiscale import (
        icp_register_multiscale,
    )

    kwargs = dict(
        coarse_max_points=settings["coarse_max_points"],
        coarse_iterations=settings["coarse_iterations"],
        coarse_tolerance=settings["coarse_tolerance"],
        max_iterations=settings["max_iterations"],
        tolerance=settings["tolerance"],
        sigma_multiplier=settings["sigma_multiplier"],
        mode=settings["mode"],
        estimator=settings["estimator"],
        nn_backend=settings["nn_backend"],
        dtype=getattr(torch, settings["dtype"]),
        return_registered=settings["return_registered"],
        device=device,
    )

    def register(pair):
        res = icp_register_multiscale(pair["source"], pair["target"],
                                      **kwargs)
        return [level_record(s, r) for s, r in res.levels]

    return register


def level_record(stride: int, res) -> dict:
    """What the check reads of one level's result, as host copies."""
    import numpy as np

    return {
        "stride": int(stride),
        "iterations": int(res.iterations),
        "stop": int(res.stop_reason),
        "T": np.array(res.transform, np.float64),
        "hist": {
            "T": np.array(res.history_transform, np.float64),
            "rmse": np.array(res.history_rmse),
            "mean": np.array(res.history_mean_dist),
            "valid": np.array(res.history_valid),
        },
    }


ENTRIES = {"library": library_entry}


@contextlib.contextmanager
def interval_spans(timing):
    """The program's unsynced stage collection (``timing.collect``), each
    span also kept as (name, start, end) on ``perf_counter`` in the
    collector's ``spans``."""
    with timing.collect(sync=False) as col:
        col.spans = []
        add = col.add

        def add_with_interval(name, dt, **meta):
            now = time.perf_counter()
            col.spans.append((name, now - dt, now))
            add(name, dt, **meta)

        col.add = add_with_interval
        yield col


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi not read ({type(e).__name__})"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device) -> dict:
    """One run of the cell; returns the result line's object."""
    import numpy as np
    import torch

    from iterativeclosestpoint_tpu_torch.runtime import timing
    from portbench import check, stats, synth
    from portbench.trace import DeviceTrace, profiled

    spec = load_cell(root, workload)
    settings, traffic = spec["settings"], spec["traffic"]
    register = ENTRIES[traffic["entry"]](settings, device)
    pool = synth.make_pool(settings["n_points"], seed, traffic)
    order = synth.schedule(seed, len(pool), len(pool))
    on_card = torch.device(device).type == "cuda"
    warm = []
    for p in order:  # warm-up: every pair once, so every shape is seen
        ta = time.perf_counter()
        register(pool[p])
        warm.append(time.perf_counter() - ta)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    log(f"setup: {setup_s:.3f} s, pool of {len(pool)}; warm-up s by pair: "
        + ", ".join(f"{t:.4f}" for t in warm))

    regs, failed = [], 0
    profiled_spans = []
    prof_out = None
    n_trace = (max(1, traffic["trace_points"] // settings["n_points"])
               if trace else 0)
    t0 = time.perf_counter()
    t_end = t0

    def one(i):
        nonlocal failed, t_end
        p = order[i % len(order)]
        ta = time.perf_counter()
        try:
            levels = register(pool[p])
        except Exception:  # a registration that raises counts as failed
            log(traceback.format_exc())
            levels = None
        t_end = time.perf_counter()
        ok = (levels is not None
              and levels[-1]["iterations"] == settings["max_iterations"]
              and bool(np.isfinite(levels[-1]["T"]).all()))
        failed += not ok
        regs.append({"index": i, "pair": p, "seconds": t_end - ta,
                     "levels": levels})

    i = 0
    if n_trace:
        with profiled() as prof_out, interval_spans(timing) as col:
            t_prof = time.perf_counter()  # the profiler is up
            while i < n_trace:
                one(i)
                i += 1
        profiled_spans = col.spans
        t_prof_end = t_end
        # As many again with neither profiler nor spans: the walls the
        # profiled ones are held against (``trace_stretch``).
        while i < 2 * n_trace:
            one(i)
            i += 1
    with timing.collect(sync=True) as synced:
        first_synced = i
        while time.perf_counter() - t0 < seconds:
            one(i)
            i += 1
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.empty_cache()

    done = [r for r in regs if r["levels"] is not None]
    n = settings["n_points"]
    work = sum(n * r["levels"][-1]["iterations"] for r in done)
    metrics, breakdown, dev_extra = {}, None, {}
    if not trace:
        values = {"icp_pts_per_s": stats.rate(work, window_s),
                  "reg_s_p90": stats.percentile(
                      [r["seconds"] for r in regs], 90),
                  "setup_s": setup_s}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        dtrace = None
        if prof_out is not None and prof_out["ops"]:
            off = prof_out["offset_ns"]

            def ns(t):
                return int(t * 1e9) + off

            dtrace = DeviceTrace(
                prof_out["ops"], (ns(t_prof), ns(t_prof_end)),
                [(nm, ns(a), ns(b)) for nm, a, b in profiled_spans])
            dev_extra = {"busy_s": dtrace.busy_s,
                         "window_s": dtrace.window_s}
            breakdown = {"device_ops": dtrace.top_ops(),
                         "idle_gaps": dtrace.idle_gaps()}
        synced_regs = [r for r in regs[first_synced:]
                       if r["levels"] is not None]
        ctx = {
            "settings": settings, "traffic": traffic,
            "stages": dict(synced.stages),
            "synced": len(synced_regs),
            "fine_iterations": sum(r["levels"][-1]["iterations"]
                                   for r in synced_regs),
            "trace": dtrace,
            "profiled": [r for r in regs[:n_trace]
                         if r["levels"] is not None],
            "unprofiled": [r for r in regs[n_trace:first_synced]
                           if r["levels"] is not None],
        }
        for m in spec["per_layer"]:
            value = metric_reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"window: {window_s:.3f} s, {len(regs)} registrations, "
        f"{failed} failed; registration s: "
        + ", ".join(f"{r['seconds']:.4f}" for r in regs))

    t_check = time.perf_counter()
    readings = check.compare(pool, done, settings, traffic["check"], seed,
                             log=log)
    log(f"check: {time.perf_counter() - t_check:.1f} s")
    limits = settings["limits"]
    correct = failed == 0 and bool(done) and all(
        readings[k] <= limits[k] for k in check.NUMBERS)
    checks = {k: {"value": readings[k], "limit": limits[k]}
              for k in check.NUMBERS}
    checks["failed"] = {"value": failed, "limit": 0}
    line = {
        "correct": correct,
        "attempted": len(regs),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": (torch.cuda.get_device_name() if on_card else "cpu"),
            "count": 1,
            "memory_peak_bytes": peak,
            **dev_extra,
        },
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_cell(ROOT, args.workload)
    cache_dirs(ROOT)

    import torch

    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"no card: the cell needs {need} CUDA device(s), torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    try:
        line = run_cell(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda")
    except Exception:  # the command's boundary: report, exit non-zero
        log(traceback.format_exc())
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for k, v in line["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
