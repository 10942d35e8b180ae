"""The metric arithmetic on made-up timings and a made-up trace."""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench import stats
from portbench.reference.icp_ref import level_strides
from portbench.run import metric_reader
from portbench.trace import DeviceTrace, clock_offset

REPO = Path(__file__).resolve().parents[2]


def test_rate_and_p90_see_a_stall():
    steady = [0.45] * 100
    stalled = [0.45] * 89 + [3.0] * 11
    work = 1_000_000 * 20
    assert stats.rate(work * 100, sum(steady)) == pytest.approx(
        work / 0.45)
    # A stall of a tenth of the registrations moves both metrics.
    assert stats.rate(work * 100, sum(stalled)) < 0.7 * stats.rate(
        work * 100, sum(steady))
    assert stats.percentile(steady, 90) == pytest.approx(0.45)
    assert stats.percentile(stalled, 90) == pytest.approx(3.0)


def test_percentile_interpolates_like_numpy():
    np = pytest.importorskip("numpy")
    xs = [0.3, 0.9, 0.41, 0.5, 0.47, 0.44, 0.62]
    for q in (50, 90, 95):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def _trace():
    s = 10**9
    ops = [("void colsweep_fused_kernel<true>(...)", 0, s // 10),
           ("void colsweep_fused_kernel<true>(...)", s // 20, s // 5),
           ("brute_nn_kernel", s // 2, s // 2 + s // 10),
           ("Memcpy HtoD", 9 * s // 10, 2 * s)]  # past the window's end
    spans = [("grid_est", s // 5, s // 2), ("fine/loop", s // 2, s),
             ("fine", 9 * s // 20, s)]
    return DeviceTrace(ops, (0, s), spans)


def test_busy_is_the_union_of_the_device_intervals():
    tr = _trace()
    assert tr.window_s == pytest.approx(1.0)
    assert tr.busy_s == pytest.approx(0.2 + 0.1 + 0.1)


def test_top_ops_and_idle_gaps_by_host_span():
    tr = _trace()
    top = dict(tr.top_ops())
    assert top["void colsweep_fused_kernel<true>(...)"] == pytest.approx(
        0.25)
    gaps = dict(tr.idle_gaps())
    assert gaps["grid_est"] == pytest.approx(0.3)
    # The innermost span holds the gap: fine/loop, not its scope fine.
    assert gaps["fine/loop"] == pytest.approx(0.3)
    assert "fine" not in gaps


def _ctx(**kw):
    base = {"settings": {"n_points": 1_000_000, "coarse_max_points": 30000,
                         "estimator": "point"},
            "stages": {"host_prep": 0.06, "upload": 0.02, "grid_est": 0.12,
                       "grid_build": 0.01, "coarse": 0.05, "fine/loop": 0.16,
                       "fine": 0.2},
            "synced": 1, "fine_iterations": 20, "trace": _trace(),
            "profiled": [{"seconds": 0.6,
                          "levels": [{"stride": 34, "iterations": 15},
                                     {"stride": 1, "iterations": 20}]}],
            "unprofiled": [{"seconds": 0.5}]}
    base.update(kw)
    return base


@pytest.mark.parametrize("name, want", [
    ("host_prep_ms", 200.0), ("grid_build_ms", 10.0), ("coarse_ms", 50.0),
    ("fine_ms_per_iter", 8.0), ("device_idle_share", 60.0),
    ("trace_stretch", 20.0)])
def test_span_and_trace_readers(name, want):
    read = metric_reader(REPO, name)
    assert read(_ctx()) == pytest.approx(want)
    assert read(_ctx(synced=0, fine_iterations=0, trace=None,
                     stages={})) is None


def test_nn_roofline_counts_bytes_once_per_iteration():
    read = metric_reader(REPO, "nn_roofline")
    strides = level_strides(1_000_000, 30000)
    assert strides == (34, 1)
    rows = -(-1_000_000 // 34)
    nbytes = 15 * rows * 32 + 20 * 1_000_000 * 32
    kernel_s = 0.25 + 0.1  # the colsweep and brute_nn kernels in the window
    assert read(_ctx()) == pytest.approx(100 * nbytes / 3.35e12 / kernel_s)
    plane = _ctx(settings={"n_points": 1_000_000, "coarse_max_points": 30000,
                           "estimator": "plane"})
    assert read(plane) == pytest.approx(
        100 * (15 * rows * 32 + 20 * 1_000_000 * 56) / 3.35e12 / kernel_s)


def test_the_marker_puts_host_and_device_on_one_clock():
    # The marker is the trace's first device operation; its start less
    # the host's time of its launch is the offset.
    ops = [("kernel b", 5_000_300, 5_000_900), ("marker", 5_000_010, 5_000_020)]
    assert clock_offset(ops, 1_000) == 5_000_010 - 1_000
    with pytest.raises(RuntimeError):
        clock_offset([], 1_000)
