"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the checkout's root. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration, ``configs/<config>.json``, and a traffic mix,
``traffic/<traffic>.json``, whose ``entry`` names what the cell calls,
``entries/<entry>.py``; a per-layer metric is read by
``metrics/<name>.py``. Nothing else here knows a cell, a mix, an entry or
a metric.

A run: the entry's pool of call inputs made from the seed (set-up), one
warm-up call on each (set-up), then a closed loop of one client for
``--seconds``: each call takes the next input and the next starts when it
has returned, until the time is up; the window ends when the last one
returns. Then, with the program's state freed, the entry's ``compare``
checks what the window returned. With ``--trace 1`` the first
``trace_points`` worth of calls run under ``torch.profiler`` (the card's
activity only) with the program's stage spans taken unsynced, as many
again with neither (the walls the profiled ones are held against), and
the rest with the spans synced, which is what the span metrics read.

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


def _module(root: Path, folder: str, kind: str, name: str):
    """The module ``portbench/<folder>/<name>.py`` of the checkout."""
    path = root / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    return _module(root, "metrics", "metric", name).read


def entry_module(root: Path, name: str):
    """``entries/<name>.py``: ``pool``, ``points``, ``entry``,
    ``iterations``, ``work``, ``complete``, ``NUMBERS`` and ``compare``
    (``README.md``, "Adding an entry")."""
    return _module(root, "entries", "entry", name)


def cache_dirs(root: Path) -> None:
    """Build and kernel caches of the program inside the checkout, at
    fixed paths (the port builds its kernels into ``build/kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / "build" / "portbench" / sub))
    os.environ.setdefault("USE_FLAX", "0")


def library_entry(settings: dict, device):
    """The call of ``entries/library.py``, imported when first asked for
    so that its imports count in ``setup_s``."""
    from portbench.entries import library

    return library.library_entry(settings, device)


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
    import torch

    from iterativeclosestpoint_tpu_torch.runtime import timing
    from portbench import stats, synth
    from portbench.trace import DeviceTrace, profiled

    spec = load_cell(root, workload)
    settings, traffic = spec["settings"], spec["traffic"]
    entry = entry_module(root, traffic["entry"])
    call = entry.entry(settings, device)
    pool = entry.pool(settings, seed, traffic)
    order = synth.schedule(seed, len(pool), len(pool))
    on_card = torch.device(device).type == "cuda"
    warm = []
    for p in order:  # warm-up: every input once, so every shape is seen
        ta = time.perf_counter()
        call(pool[p])
        warm.append(time.perf_counter() - ta)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    log(f"setup: {setup_s:.3f} s, pool of {len(pool)}; warm-up s by pair: "
        + ", ".join(f"{t:.4f}" for t in warm))

    regs, failed = [], 0
    profiled_spans = []
    prof_out = None
    n_trace = (max(1, traffic["trace_points"] // entry.points(settings))
               if trace else 0)
    t0 = time.perf_counter()
    t_end = t0

    def one(i):
        nonlocal failed, t_end
        p = order[i % len(order)]
        ta = time.perf_counter()
        try:
            record = call(pool[p])
        except Exception:  # a call that raises counts as failed
            log(traceback.format_exc())
            record = None
        t_end = time.perf_counter()
        failed += record is None or not entry.complete(settings, record)
        # The call's record under "levels", the name check.py and the
        # metric readers know it by.
        regs.append({"index": i, "pair": p, "seconds": t_end - ta,
                     "levels": record})

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
    work = sum(entry.work(settings, r["levels"]) for r in done)
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
            "meta": {k: dict(v) for k, v in synced.meta.items()},
            "synced": len(synced_regs),
            "fine_iterations": sum(entry.iterations(settings, r["levels"])
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
    readings = entry.compare(pool, done, settings, traffic["check"], seed,
                             log)
    log(f"check: {time.perf_counter() - t_check:.1f} s")
    limits = settings["limits"]
    correct = failed == 0 and bool(done) and all(
        readings[k] <= limits[k] for k in entry.NUMBERS)
    checks = {k: {"value": readings[k], "limit": limits[k]}
              for k in entry.NUMBERS}
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
