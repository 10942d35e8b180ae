"""The ``cli`` entry (``entries/cli.py``) on the CPU at a tiny size: its
pool is the same for the same seed, a sound ``icp-torch run`` reads
``correct``, and the bfloat16 control and each fault planted in the
verb's outputs do not.

The faults: one output row moved by 5 cm, half the output rows dropped,
the report's transform moved by 5 cm, and an output header whose offset
is not the source's. Each is planted in the program's writers
(``runtime/session.py``), so the call runs as it does in the cell.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest

from portbench.run import entry_module, load_cell
from portbench.tests.conftest import REPO

CELL = "terrain1m-las.las-near"
N = 4000


def _setup(seed=2**32 + 3, pairs=2):
    spec = load_cell(REPO, CELL)
    entry = entry_module(REPO, spec["traffic"]["entry"])
    settings = dict(spec["settings"], n_points=N, max_iterations=4)
    traffic = dict(spec["traffic"], pool_points=pairs * N)
    check = dict(traffic["check"], points=pairs * N)
    return entry, settings, traffic, check, seed


def _digest(item):
    h = hashlib.sha256()
    for side in ("source_path", "target_path"):
        h.update(item[side].read_bytes())
    return h.hexdigest()


def test_the_pool_is_the_same_for_the_same_seed():
    entry, settings, traffic, _, seed = _setup()
    a = entry.pool(settings, seed, traffic)
    b = entry.pool(settings, seed, traffic)
    c = entry.pool(settings, seed + 1, traffic)
    assert len(a) == 2 and a[0]["source_path"] != b[0]["source_path"]
    assert [_digest(i) for i in a] == [_digest(i) for i in b]
    assert [_digest(i) for i in a] != [_digest(i) for i in c]
    for x, y in zip(a, b):
        assert np.array_equal(x["source"], y["source"])
        assert np.array_equal(x["target"], y["target"])
        assert x["header"] == y["header"]
        assert x["header"]["point_data_format"] == 1


def _readings(entry, settings, traffic, check, seed, control=False):
    items = entry.pool(settings, seed, traffic)
    call = entry.entry(settings, "cpu")
    done = [{"index": i, "pair": i, "levels": call(item)}
            for i, item in enumerate(items)]
    failed = sum(not entry.complete(settings, r["levels"]) for r in done)
    return failed, entry.compare(items, done, settings, check, seed,
                                 control=control)


def test_a_sound_run_is_correct_and_the_control_is_not():
    entry, settings, traffic, check, seed = _setup()
    limits = settings["limits"]
    failed, got = _readings(entry, settings, traffic, check, seed)
    assert failed == 0
    assert all(got[k] <= limits[k] for k in entry.NUMBERS), got
    _, low = _readings(entry, settings, traffic, check, seed, control=True)
    assert any(low[k] > limits[k] for k in entry.NUMBERS), low
    assert low["out_q_max"] > 10 * limits["out_q_max"]


def _write_las(monkeypatch, change):
    from iterativeclosestpoint_tpu_torch.runtime import session

    real = session.write_las

    def planted(path, points, scale=None, offset=None, rebase=False):
        points, offset = change(np.array(points), offset)
        return real(path, points, scale=scale, offset=offset, rebase=rebase)

    monkeypatch.setattr(session, "write_las", planted)


def _row_moved(monkeypatch):
    def move(points, offset):
        points[0, 0] += 0.05
        return points, offset

    _write_las(monkeypatch, move)


def _half_dropped(monkeypatch):
    _write_las(monkeypatch, lambda points, offset:
               (points[: len(points) // 2], offset))


def _offset_moved(monkeypatch):
    _write_las(monkeypatch, lambda points, offset:
               (points, (offset[0] + 1.0, offset[1], offset[2])))


def _transform_moved(monkeypatch):
    from iterativeclosestpoint_tpu_torch.runtime import session

    real = session.write_history_json

    def planted(path, result):
        T = result.transform.copy()
        T[0, 3] += 0.05
        real(path, dataclasses.replace(result, transform=T))

    monkeypatch.setattr(session, "write_history_json", planted)


@pytest.mark.parametrize("plant, caught", [
    (_row_moved, "out_q_max"), (_half_dropped, "out_rows_off"),
    (_transform_moved, "pose_m"), (_offset_moved, "header_gap")],
    ids=["row-moved", "half-the-rows-dropped", "transform-moved",
         "header-offset"])
def test_a_planted_fault_reads_false(monkeypatch, plant, caught):
    entry, settings, traffic, check, seed = _setup(pairs=1)
    plant(monkeypatch)
    _, got = _readings(entry, settings, traffic, check, seed)
    limits = settings["limits"]
    assert got[caught] > limits[caught], got
