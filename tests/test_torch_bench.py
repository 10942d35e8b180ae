"""``icp-torch bench`` (``iterativeclosestpoint_tpu_torch/bench.py``) on the
CPU at a small size: 4,000 points, 3 fine iterations, one timed run, no
kernel smoke, the parity pair at 4,000 points (``PARITY_N``; the bench's
50,000 points are ~2.5e9 brute-force pairs an iteration on the CPU).

The JSON line must carry the root ``bench.py``'s keys, and its terrain row
the RMSE of the port's ``icp_register_multiscale`` at the same kwargs, bit
for bit (``test_torch_icp.py`` holds that function against the JAX
package; the JAX package's bench and its interpret-mode sweep are not run
here). An enabled section that fails exits non-zero with no JSON line.
The native octree sections run wherever ``native/`` builds; the tests of
them skip, naming the build's output, only where it does not.
"""

import contextlib
import io
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu_torch import bench, icp_register_multiscale
from iterativeclosestpoint_tpu_torch.cli import main as cli_main
from iterativeclosestpoint_tpu_torch.runtime import native
from iterativeclosestpoint_tpu_torch.utils.synth import make_registration_pair

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"BENCH_N": "4000", "BENCH_ITERS": "3", "BENCH_REPS": "1",
         "BENCH_VOLUME_N": "4000", "BENCH_BASELINE_N": "4000",
         "BENCH_SMOKE": "0"}
VARIABLES = ("BENCH_N", "BENCH_ITERS", "BENCH_BASELINE_N", "BENCH_REPS",
             "BENCH_SMOKE", "BENCH_VOLUME", "BENCH_VOLUME_N", "BENCH_PLANE",
             "BENCH_BASELINE", "BENCH_PARITY", "BENCH_VOLUME_DEADLINE_S",
             "BENCH_PLANE_DEADLINE_S")
# The keys of the root bench.py's line (its final print and its rows).
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "rows"}
ROW_KEYS = {"blended_pts_per_s", "seconds", "rmse", "fine_loop_pts_per_s",
            "fine_ms_per_iter"}


def _no_native_reason():
    return ("the native octree library (native/) cannot be built here, "
            "native_available() is false: " + native.native_failure())


def _bench(env, patches=()):
    """``icp-torch --device cpu bench`` in this process with exactly the
    ``BENCH_*`` variables ``env``; returns (rc, stdout, stderr)."""
    with pytest.MonkeyPatch.context() as mp:
        for k in VARIABLES:
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(bench, "SOL_REPS", 2)  # CPU times of the plain versions
        mp.setattr(bench, "PARITY_N", 4000)
        for obj, name, value in patches:
            mp.setattr(obj, name, value)
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(["--device", "cpu", "bench"])
    return rc, out.getvalue(), err.getvalue()


def _no_sol(*a):
    """The standalone reports, left out where a test runs a failing
    section (the whole run covers them)."""
    return 0.0, 0.0


@pytest.fixture(scope="module")
def bench_run():
    """One whole run; the native sections are switched off (and their
    tests skip) only where the library does not build."""
    env = dict(SMALL)
    if not native.native_available():
        env.update(BENCH_BASELINE="0", BENCH_PARITY="0")
    rc, out, err = _bench(env)
    assert rc == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1]), out, err


def test_json_line_has_bench_py_keys(bench_run):
    line, out, _ = bench_run
    source = (ROOT / "bench.py").read_text()
    for key in TOP_KEYS | ROW_KEYS:
        assert f'"{key}"' in source, key
    assert len(out.strip().splitlines()) == 1  # nothing else on stdout
    assert set(line) == TOP_KEYS
    assert line["metric"] == "icp_points_per_sec_per_chip"
    assert line["unit"] == "points/s/chip"
    assert set(line["rows"]) == {"terrain", "volume", "plane"}
    for name, row in line["rows"].items():
        assert set(row) == ROW_KEYS, name
        assert all(v > 0 for v in row.values()), (name, row)
    assert line["value"] == line["rows"]["terrain"]["blended_pts_per_s"]


def test_terrain_row_is_the_library_call(bench_run):
    """The headline's RMSE is the port's multiscale call's at the bench's
    kwargs and size, bit for bit (the stderr line carries its repr)."""
    line, _, err = bench_run
    src, tgt, _ = make_registration_pair(n=4000, seed=7, noise_sigma=0.02,
                                         kind="terrain", extent=100.0)
    res = icp_register_multiscale(
        src, tgt, coarse_max_points=30_000, coarse_iterations=15,
        max_iterations=3, tolerance=0.0, dtype=torch.float32,
        nn_backend="pallas", return_registered=False, device="cpu")
    m = re.search(r"^terrain: .*rmse=([^,]+), fine iterations (\d+)\)$",
                  err, re.M)
    assert m, err[-3000:]
    assert float(m.group(1)) == res.final.rmse
    assert int(m.group(2)) == res.final.iterations == 3
    assert line["rows"]["terrain"]["rmse"] == round(res.final.rmse, 5)


def test_sections_are_logged(bench_run):
    _, _, err = bench_run
    lines = err.splitlines()
    assert lines[0].startswith("card: none (--device cpu")
    assert "host CPU: " in lines[0]
    for head in ("smoke: skipped (BENCH_SMOKE=0)", "nn-slab-sweep: ",
                 "nn-slab-sweep kernel: ", "reject+moments: ",
                 "breakdown: fine/loop: ", "breakdown: synced total ",
                 "volume: ", "nn-zcol: ", "nn-zcol kernel: ", "plane: ",
                 "launches: "):
        assert any(ln.startswith(head) for ln in lines), head
    assert re.search(r"nn-slab-sweep: .*K1 fused, R=\d+, trange \d+, "
                     r"\d+ tiles x 4 slots, [\d.]+% of real rows certified",
                     err)
    # No card: no issue floor, and no CUDA launch is counted.
    assert "of the floor" not in err
    assert json.loads(next(ln for ln in lines if ln.startswith(
        "launches: "))[len("launches: "):]) == {
            "colsweep_fused": 0, "colsweep": 0, "brute_nn": 0}


def test_baseline_and_parity(bench_run):
    if not native.native_available():
        pytest.skip(_no_native_reason())
    line, _, err = bench_run
    base = re.search(r"^baseline: ([\d.]+)s for (\d+) iters of 4000 pts on "
                     r".+ -> ([\d,]+) points/s -> speedup", err, re.M)
    assert base, err[-3000:]
    assert int(base.group(2)) == 3
    assert isinstance(line["vs_baseline"], float) and line["vs_baseline"] > 0
    par = re.search(r"^parity: reference iters=(\d+) .* transform error vs "
                    r"reference = (\S+) m \(PASS 0.0001 gate\)$", err, re.M)
    assert par, err[-3000:]
    assert float(par.group(2)) < 1e-4


def test_failing_section_exits_nonzero_without_json():
    def boom(*a, **k):
        raise RuntimeError("plane row failed on purpose")

    env = dict(SMALL, BENCH_VOLUME="0", BENCH_BASELINE="0",
               BENCH_PARITY="0")
    rc, out, err = _bench(env, [(bench, "_measure_plane", boom),
                                (bench, "_measure_kernel_sol", _no_sol)])
    assert rc != 0
    assert out == ""
    assert "bench failed: RuntimeError: plane row failed on purpose" in err
    assert "volume: skipped (BENCH_VOLUME=0)" in err


def test_unbuildable_native_library_is_an_error():
    """``BENCH_BASELINE=1`` without the library fails, naming the build's
    output, instead of printing ``vs_baseline: null``."""
    env = dict(SMALL, BENCH_VOLUME="0", BENCH_PLANE="0", BENCH_PARITY="0")
    rc, out, err = _bench(env, [
        (bench, "_measure_kernel_sol", _no_sol),
        (native, "native_available", lambda: False),
        (native, "native_failure", lambda: "make exited 2:\nno g++ here"),
    ])
    assert rc != 0 and out == ""
    assert "cannot be built or loaded" in err and "no g++ here" in err


def test_parity_above_the_gate_is_an_error(monkeypatch):
    if not native.native_available():
        pytest.skip(_no_native_reason())
    monkeypatch.setattr(bench, "PARITY_N", 4000)
    monkeypatch.setattr(bench, "PARITY_GATE_M", 1e-15)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(bench.BenchError,
                                                        match="above"):
        bench._parity(torch.device("cpu"))
    assert "(FAIL 1e-15 gate)" in err.getvalue()


@pytest.mark.parametrize("row", ["volume", "plane"])
def test_deadline_skip_is_logged(row):
    cfg = bench.BenchSettings.from_environ(
        dict(SMALL, BENCH_VOLUME_DEADLINE_S="0", BENCH_PLANE_DEADLINE_S="0"))
    rows, err = {}, io.StringIO()
    with contextlib.redirect_stderr(err):
        if row == "volume":
            bench._measure_volume(cfg, {}, time.perf_counter() - 1.0,
                                  torch.device("cpu"), rows)
        else:
            bench._measure_plane(cfg, {}, time.perf_counter() - 1.0,
                                 torch.device("cpu"), rows, None, None)
    assert rows == {}
    assert f"{row}: skipped (past the 0 s deadline" in err.getvalue()


def test_settings_are_bench_py_defaults_read_when_called(monkeypatch):
    d = bench.BenchSettings.from_environ({})
    assert (d.n, d.iters, d.baseline_n, d.reps, d.volume_n) == (
        1_000_000, 20, 1_000_000, 8, 1_000_000)
    assert bench.PARITY_N == 50_000
    assert d.smoke and d.volume and d.plane and d.baseline and d.parity
    assert (d.volume_deadline_s, d.plane_deadline_s) == (2400.0, 3000.0)
    monkeypatch.setenv("BENCH_N", "123")
    monkeypatch.setenv("BENCH_PLANE", "0")
    s = bench.BenchSettings.from_environ()
    assert (s.n, s.baseline_n, s.volume_n, s.plane) == (123, 123, 123, False)
    assert np.isclose(s.volume_deadline_s, 2400.0)


@pytest.mark.parametrize("props, rate, source", [
    # An H100 SXM as torch reports it: HBM3 at 2,619 MHz on 5,120 bits.
    (dict(memory_clock_rate=2_619_000, memory_bus_width=5120), 3.35232e12,
     "torch: 5120-bit bus at 2619 MHz"),
    # A torch that reports neither: the data sheet's rate.
    ({}, 3.35e12, "H100 SXM data sheet"),
])
def test_covariance_report_against_the_hbm_rate(props, rate, source):
    """The reject-plus-moments report: 28 B and 30 operations a point,
    held to the larger of bytes over the HBM rate and operations over the
    issue rate (bytes bind it on an H100)."""
    from types import SimpleNamespace

    from iterativeclosestpoint_tpu_torch.runtime.profiling import (
        CardSpec,
        _hbm_rate,
        covariance_kernel_report,
    )

    hbm, said = _hbm_rate(SimpleNamespace(**props))
    assert hbm == pytest.approx(rate, rel=1e-12) and said == source
    card = CardSpec("NVIDIA H100 80GB HBM3", 132, 1.98e9, hbm, said)
    r = covariance_kernel_report(1_016_320, 5e-4, card)
    assert r.bytes == 1_016_320 * 28
    assert r.floor_s == pytest.approx(r.bytes / hbm)
    assert r.floor_s > 1_016_320 * 30 / card.issue_rate
    assert r.share == pytest.approx(r.floor_s / 5e-4)
    assert source in r.line() and "of the floor" in r.line()
