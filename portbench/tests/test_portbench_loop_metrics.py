"""The fine loop's span readers on a made-up run: the right value where
the program has the spans, None where it has not (a program without the
loop's spans gives no such stage)."""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench.run import metric_reader
from portbench.trace import DeviceTrace

REPO = Path(__file__).resolve().parents[2]


def _trace(spans):
    return DeviceTrace([("k", 0, 10)], (0, 100), spans)


def _ctx(**kw):
    """Two profiled registrations of 20 fine iterations, each with 3
    gate reads and a stop read an iteration, and 40 synced ones."""
    reads = [(name, 0, 1) for name in ["fine/read/gate"] * 120
             + ["fine/read/stop"] * 40]
    others = [("fine/loop", 0, 9), ("coarse/read/stop", 0, 1),
              ("fine/nn/window", 0, 1)]
    base = {"stages": {"fine/loop": 0.28, "fine/read/gate": 0.024,
                       "fine/read/stop": 0.008, "fine/nn/window": 0.048,
                       "coarse/read/stop": 5.0, "fine/nn": 0.1},
            "synced": 2, "fine_iterations": 40,
            "trace": _trace(reads + others),
            "profiled": [{"levels": [{"iterations": 15},
                                     {"iterations": 20}]}] * 2}
    base.update(kw)
    return base


@pytest.mark.parametrize("name, want", [
    ("fine_wait_ms_per_iter", 0.8), ("fine_window_ms_per_iter", 1.2),
    ("fine_host_reads_per_iter", 4.0)])
def test_loop_readers(name, want):
    assert metric_reader(REPO, name)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["fine_wait_ms_per_iter",
                                  "fine_window_ms_per_iter",
                                  "fine_host_reads_per_iter"])
def test_loop_readers_none_without_their_spans(name):
    read = metric_reader(REPO, name)
    # The parent's program: the loop is one span, nothing inside it.
    parent = _ctx(stages={"fine/loop": 0.28, "fine": 0.3},
                  trace=_trace([("fine/loop", 0, 9), ("fine", 0, 10)]))
    assert read(parent) is None
    assert read(_ctx(fine_iterations=0, trace=None, profiled=[])) is None
