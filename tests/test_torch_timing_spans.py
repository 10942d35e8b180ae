"""The port's spans and counters (``runtime/timing.py``): what a collector
records of each span (entries, interval, enclosing span, registration
call, counters), that nothing is recorded and nothing changes without
one, the repair chain's counters on an overflow of its brute budget, and
``icp-torch run --profile`` / ``--metrics``.

The card tests (``-m cuda``) hold the loop's ``read/*`` spans against the
synchronisations the card reports, and the stage track of a profile
against its kernels. They import no JAX, so on a machine with a card::

    python -m pytest --noconftest -m cuda tests/test_torch_timing_spans.py
"""

import collections
import contextvars
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu_torch import icp_register_multiscale
from iterativeclosestpoint_tpu_torch.cli import main as cli_main
from iterativeclosestpoint_tpu_torch.ops import sweep_nn as tsn
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    build_pallas_grid,
    grouped_tile_order,
)
from iterativeclosestpoint_tpu_torch.runtime import timing
from iterativeclosestpoint_tpu_torch.runtime.profiling import (
    STAGE_TRACK,
    trace,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import (
    call,
    collect,
    count,
    scope,
    stage,
)
from iterativeclosestpoint_tpu_torch.utils.synth import (
    make_cloud,
    make_registration_pair,
)


def _by_name(col):
    return {iv.name: (i, iv) for i, iv in enumerate(col.intervals)}


def test_nested_spans_keep_parent_and_call():
    with collect(sync=False) as col:
        with call():
            with scope("fine"):
                with stage("loop"):
                    with call():  # a nested call keeps the outer id
                        with stage("nn"):
                            pass
                    with stage("read/stop"):
                        pass
        with stage("between"):
            pass
        with call():
            with stage("next"):
                pass
    ivs = col.intervals
    assert [iv.name for iv in ivs] == ["fine", "fine/loop", "fine/nn",
                                       "fine/read/stop", "between", "next"]
    assert [iv.parent for iv in ivs] == [None, 0, 1, 1, None, None]
    assert [iv.call for iv in ivs] == [0, 0, 0, 0, None, 1]
    for iv in ivs:
        assert iv.start_ns <= iv.end_ns
        if iv.parent is not None:
            p = ivs[iv.parent]
            assert p.start_ns <= iv.start_ns and iv.end_ns <= p.end_ns
    # Seconds are still summed by name, as the intervals show them.
    assert col.stages["fine/nn"] == pytest.approx(
        (ivs[2].end_ns - ivs[2].start_ns) / 1e9)


def test_every_span_counts_its_entries():
    with collect(sync=True) as col:
        for _ in range(3):
            with scope("coarse"):
                for _ in range(4):
                    with stage("read/gate"):
                        pass
        with stage("upload", bytes=10):
            pass
    assert col.meta["coarse"]["calls"] == 3
    assert col.meta["coarse/read/gate"]["calls"] == 12
    assert col.meta["upload"] == {"calls": 1, "bytes": 10}
    assert col.summary()["coarse/read/gate"]["calls"] == 12
    assert len(col.intervals) == 3 + 12 + 1


def test_count_reaches_the_innermost_span_and_never_add():
    added = []
    with collect(sync=False) as col:
        add = col.add

        def spy(name, dt, **meta):
            added.append((name, meta))
            add(name, dt, **meta)

        col.add = spy
        count("orphan", 5)  # outside every span: nothing
        with stage("outer"):
            count("tiles", 2)
            with stage("inner"):
                count("tiles", 3)
                count("fallbacks")
            count("tiles", 0)
    assert col.meta["outer"] == {"calls": 1, "tiles": 2}
    assert col.meta["inner"] == {"calls": 1, "tiles": 3, "fallbacks": 1}
    # Each span's end calls add once, with the stage's own metadata only.
    assert added == [("inner", {}), ("outer", {})]
    assert "orphan" not in str(col.meta)


def test_nothing_is_recorded_without_a_collector():
    assert timing.active() is None
    # One shared, empty context manager: nothing allocated, nothing read.
    assert stage("a") is stage("b") is scope("c") is call()
    with stage("a") as done:
        done(torch.ones(3))
        assert count("tiles", 3) is None
        with call():
            with scope("c"):
                pass
    assert timing._open.get() is None and timing._call.get() is None


def test_threads_keep_their_own_open_spans():
    """A thread run in a copy of the caller's context nests its spans under
    the span open at the copy, not under the caller's later spans."""
    inside, go_on = threading.Event(), threading.Event()
    with collect(sync=False) as col:
        with stage("run"):
            ctx = contextvars.copy_context()

            def rank():
                with stage("rank"):
                    inside.set()
                    assert go_on.wait(10)

            th = threading.Thread(target=ctx.run, args=(rank,))
            th.start()
            assert inside.wait(10)
            with stage("caller"):
                go_on.set()
                th.join(10)
            assert not th.is_alive()
    spans = _by_name(col)
    run = spans["run"][0]
    assert spans["rank"][1].parent == run
    assert spans["caller"][1].parent == run


@pytest.fixture(scope="module")
def pair():
    src, tgt, _ = make_registration_pair(n=6000, seed=12, noise_sigma=0.02)
    return src, tgt


@pytest.mark.parametrize("estimator", ["point", "plane"])
def test_registration_bit_identical_with_and_without_spans(pair, estimator):
    src, tgt = pair
    kw = dict(coarse_max_points=1500, coarse_iterations=6, max_iterations=4,
              tolerance=0.0, nn_backend="pallas", estimator=estimator,
              device="cpu")
    runs, cols = [], []
    runs.append(icp_register_multiscale(src, tgt, **kw))
    for sync in (False, True):
        with collect(sync=sync) as col:
            runs.append(icp_register_multiscale(src, tgt, **kw))
        cols.append(col)
    for res in runs[1:]:
        assert len(res.levels) == len(runs[0].levels) == 2
        for (_, a), (_, b) in zip(runs[0].levels, res.levels):
            for f in ("transform", "history_transform", "history_rmse",
                      "history_valid", "history_mean_dist"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for col in cols:
        s = col.summary()
        fine_iters = runs[0].final.iterations
        assert s["fine/nn"]["calls"] == s["fine/read/stop"]["calls"] \
            == s["fine/stats"]["calls"] == s["fine/solve"]["calls"] \
            == fine_iters
        assert s["fine/nn/window"]["calls"] >= fine_iters
        assert s["fine/nn/sweep"]["calls"] >= fine_iters
        assert s["fine/read/gate"]["calls"] >= fine_iters
        rep = s["fine/nn/repair"]
        assert rep["calls"] == fine_iters
        assert {"bad_tiles", "repair_tiles", "unproven_tiles",
                "fallbacks"} <= set(rep)
        assert rep["unproven_tiles"] == 0
        for part in ("occupancy", "params", "boost"):
            assert s[f"grid_est/{part}"]["calls"] == 1
        # The other calls that synchronise on the card: the loop's three
        # scalars, the point SVD; and the plain slab window's two edge
        # scalars, which the card's window kernel does without.
        assert s["fine/read/const"]["calls"] == 3
        assert s["fine/read/inf"]["calls"] == 2 * s["fine/nn/window"][
            "calls"]
        assert s["fine/nn/window"]["window_kernels"] == 0
        assert s.get("fine/read/svd", {}).get("calls", 0) == (
            fine_iters if estimator == "point" else 0)
        assert s["coarse/read/stop"]["calls"] == runs[0].levels[0][1] \
            .iterations
        # One multiscale call: every span shares its id.
        assert {iv.call for iv in col.intervals} == {0}


def test_repair_counters_show_an_overflow_of_the_brute_budget():
    """F7's fault in miniature: the query layout is keyed at one pose and
    the queries searched at a far one, so most tiles are not compact and
    stay uncertified; a budget of one brute tile leaves the rest
    unproven, unless the global fallback runs."""
    tgt = make_cloud(4000, seed=21)
    R = 16
    grid = build_pallas_grid(tgt, R, trange=2048, device="cpu")
    q0 = tgt[:2560] + np.random.default_rng(5).normal(0, 0.05, (2560, 3))
    rows, _ = grouped_tile_order(q0, grid, R)
    q0 = q0[rows]
    a = np.deg2rad(25.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]])
    c = q0.mean(axis=0)
    far = (q0 - c) @ rot.T + c + np.array([3.0, -2.0, 0.0])
    q = torch.as_tensor(far, dtype=torch.float32)
    t = torch.as_tensor(tgt, dtype=torch.float32)
    tiles = -(-len(far) // 128)
    got = {}
    for fb in (False, True):
        with collect(sync=False) as col:
            *_, cert = tsn.nn_colsweep_exact(
                q, t, grid, resolution=R, brute_batch=128, brute_passes=1,
                global_fallback=fb, return_certified=True)
        got[fb] = col.meta["nn/repair"]
        if not fb:
            pad = torch.ones(tiles * 128, dtype=torch.bool)
            pad[:len(far)] = cert
            left = int((~pad.reshape(tiles, 128)).any(dim=1).sum())
    off, on = got[False], got[True]
    assert off["bad_tiles"] > 1 and off["bad_tiles"] == on["bad_tiles"]
    assert off["unproven_tiles"] == off["bad_tiles"] - 1 > 0
    assert off["unproven_tiles"] == left  # the tiles left unproven
    assert off["fallbacks"] == 0
    assert on["unproven_tiles"] == 0 and on["fallbacks"] == 1
    assert off["repair_tiles"] == on["repair_tiles"] == 2  # 2 one-tile passes
    assert col.meta["read/gate"]["calls"] == 1  # no coarse grid: one gate


def test_profile_trace_holds_the_stage_track(tmp_path):
    """The stage track is on the profiler's clock: a torch operation run
    inside a span lies inside it in the trace."""
    with collect(sync=False) as col, trace(str(tmp_path), col):
        with stage("mine"):
            time.sleep(0.002)
            torch.ones(64).add_(1.0)
            time.sleep(0.002)
    doc = json.loads((tmp_path / "trace.json").read_text())
    ev = doc["traceEvents"]
    mine = [e for e in ev if e.get("cat") == "icp_stage"
            and e["name"] == "mine"]
    op = [e for e in ev if e.get("name") == "aten::add_"]
    assert len(mine) == 1 and op
    m, o = mine[0], op[-1]
    assert m["ts"] < o["ts"] and o["ts"] + o["dur"] < m["ts"] + m["dur"]
    names = [e["args"]["name"] for e in ev if e.get("ph") == "M"
             and e.get("name") == "thread_name"]
    assert STAGE_TRACK in names


def test_cli_profile_and_metrics_write_the_spans(tmp_path):
    sp, tp = tmp_path / "s.las", tmp_path / "t.las"
    assert cli_main(["synth", str(sp), str(tp), "--n", "3000", "--seed",
                     "11", "--noise", "0.02"]) == 0
    assert cli_main(["--device", "cpu", "run", str(sp), str(tp), "-o",
                     str(tmp_path / "r.las"), "--nn-backend", "pallas",
                     "--max-iterations", "5", "--metrics",
                     str(tmp_path / "m.jsonl"), "--profile",
                     str(tmp_path / "prof")]) == 0
    last = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    assert last["kind"] == "stages"
    st = last["stages"]
    for name in ("load_source", "load_target", "loop", "nn", "read/stop",
                 "write_las", "report"):
        assert st[name]["calls"] >= 1 and st[name]["seconds"] >= 0, name
    iters = sum(1 for line in (tmp_path / "m.jsonl").read_text()
                .splitlines() if json.loads(line)["kind"] == "iteration")
    assert st["read/stop"]["calls"] == st["nn"]["calls"] == iters
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    track = [e for e in doc["traceEvents"] if e.get("cat") == "icp_stage"]
    names = {e["name"] for e in track}
    assert {"load_source", "loop", "nn/window", "read/stop",
            "write_las"} <= names
    loop = next(e for e in track if e["name"] == "loop")
    inner = [e for e in track if e["args"]["parent"] == "loop"]
    assert inner and all(loop["ts"] <= e["ts"] and e["ts"] + e["dur"]
                         <= loop["ts"] + loop["dur"] + 1.0 for e in inner)


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _syncs(col, fn):
    """Run ``fn`` under ``set_sync_debug_mode("warn")``; returns the
    interval index of the innermost open span at each synchronisation."""
    at = []

    def show(*_a, **_k):
        sp = timing._open.get()
        at.append(sp[1] if sp is not None else None)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        old, warnings.showwarning = warnings.showwarning, show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = old
    return at


def _in(col, idx, name):
    while idx is not None:
        if col.intervals[idx].name == name:
            return True
        idx = col.intervals[idx].parent
    return False


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["terrain", "uniform"])
def test_card_loop_syncs_are_its_read_spans(card, kind):
    """The loops' ``read/*`` spans are where they synchronise: a 1M
    registration with one fine iteration (the slab sweep on terrain, the
    z-column sweep on a box) and its coarse level. Every sync inside a
    loop is in a read span, and every read span synchronises: once, but
    the SVD (``read/svd``), which syncs twice. The windows are one kernel
    launch each (``window_kernels``) and open no ``read/inf``."""
    src, tgt, _ = make_registration_pair(n=1_000_000, seed=5, kind=kind,
                                         noise_sigma=0.02)
    kw = dict(max_iterations=1, nn_backend="pallas", coarse_iterations=15,
              coarse_max_points=30000, device=card)
    icp_register_multiscale(src, tgt, **kw)  # warm
    torch.cuda.synchronize()
    with collect(sync=False) as col:
        at = _syncs(col, lambda: icp_register_multiscale(src, tgt, **kw))
    for lv in ("coarse", "fine"):
        per_read = collections.Counter(
            i for i in at if _in(col, i, f"{lv}/loop"))
        reads = [i for i, iv in enumerate(col.intervals)
                 if iv.name.startswith(f"{lv}/read/")
                 and _in(col, i, f"{lv}/loop")]
        assert sorted(per_read) == reads, (lv, [
            col.intervals[i].name for i in set(per_read) - set(reads)])
        for i in reads:
            want = 2 if col.intervals[i].name.endswith("/read/svd") else 1
            assert per_read[i] == want, col.intervals[i].name
        assert not [i for i in reads
                    if col.intervals[i].name.endswith("/read/inf")], lv
    win = col.summary()["fine/nn/window"]
    assert win["window_kernels"] == win["calls"] >= 1


@pytest.mark.cuda
def test_card_profile_loop_encloses_its_k1_kernels(card, tmp_path):
    sp, tp = tmp_path / "s.las", tmp_path / "t.las"
    assert cli_main(["synth", str(sp), str(tp), "--n", "1000000", "--seed",
                     "11", "--noise", "0.02"]) == 0
    run = ["run", str(sp), str(tp), "--multiscale", "--nn-backend",
           "pallas", "--max-iterations", "3"]
    assert cli_main(run) in (0, 1)  # warm: builds the kernels
    cli_main(run + ["--profile", str(tmp_path / "prof")])
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    ev = doc["traceEvents"]
    loop = [e for e in ev if e.get("cat") == "icp_stage"
            and e["name"] == "fine/loop"]
    k1 = [e for e in ev if e.get("cat") == "kernel"
          and "colsweep_fused" in e["name"]]
    assert len(loop) == 1 and len(k1) >= 3
    a, b = loop[0]["ts"], loop[0]["ts"] + loop[0]["dur"]
    assert all(a <= e["ts"] and e["ts"] + e["dur"] <= b for e in k1)
