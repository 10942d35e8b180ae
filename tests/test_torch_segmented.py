"""Segmented runs, resume and the two-stage boosted fine level, on the CPU.

A run split into segments, or stopped and resumed from its carry, must
follow the one-dispatch trajectory bit for bit (the loop recomputes the
source from the pristine source and the carried T_cum); records carry the
JAX package's keys. The two-stage fine level is held against the JAX
package's: the same levels, iterations, stop codes and boosted resolution,
and a registration within 1e-4 m (the f32 parity gate of PARITY.md).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.models.icp import icp_register as jax_icp
from iterativeclosestpoint_tpu.models.multiscale import (
    icp_register_multiscale as jax_multiscale,
)
from iterativeclosestpoint_tpu.utils.synth import make_registration_pair
from iterativeclosestpoint_tpu_torch import (
    icp_register,
    icp_register_multiscale,
)
from iterativeclosestpoint_tpu_torch.models.icp import STOPPED

HIST = ("history_rmse", "history_valid", "history_outliers",
        "history_transform", "history_mean_dist", "history_std_dist",
        "history_threshold")


def _pair():
    return make_registration_pair(n=3000, seed=21, noise_sigma=0.01)


def _same_run(a, b):
    assert (a.iterations, a.stop_reason) == (b.iterations, b.stop_reason)
    for f in HIST:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    np.testing.assert_array_equal(a.transform, b.transform)


BRUTE = dict(nn_backend="bruteforce", tolerance=1e-5, device="cpu")


@pytest.fixture(scope="module")
def one_dispatch():
    """The 3k pair's one-dispatch brute-force run (40 iterations at most),
    which the segmented and resumed runs must follow."""
    src, tgt, _ = _pair()
    return src, tgt, icp_register(src, tgt, max_iterations=40, **BRUTE)


@pytest.mark.parametrize("seg_n", [1, 2, 5, 7])
def test_segmented_equals_one_dispatch(one_dispatch, seg_n):
    """Convergence needs 3 small steps in a row: segments of 1, 2 and 7
    split that streak across boundaries."""
    src, tgt, one = one_dispatch
    assert one.message == "converged" and one.iterations > 7
    seg = icp_register(src, tgt, max_iterations=40, segment_iterations=seg_n,
                       **BRUTE)
    _same_run(seg, one)
    np.testing.assert_array_equal(seg.source_registered,
                                  one.source_registered)


def test_segmented_plane_pallas_equals_one_dispatch():
    src, tgt, _ = make_registration_pair(n=4000, seed=12, noise_sigma=0.02)
    kw = dict(nn_backend="pallas", estimator="plane", max_iterations=8,
              tolerance=0.0, return_registered=False, device="cpu")
    _same_run(icp_register(src, tgt, segment_iterations=3, **kw),
              icp_register(src, tgt, **kw))


def test_progress_records_match_jax_keys():
    src, tgt, _ = _pair()
    kw = dict(nn_backend="bruteforce", max_iterations=9, tolerance=1e-9,
              segment_iterations=3)
    seen, seen_j, states, states_j = [], [], [], []
    res = icp_register(src, tgt, progress_callback=seen.append,
                       segment_callback=states.append, device="cpu", **kw)
    jax_icp(src, tgt, dtype=jnp.float32, progress_callback=seen_j.append,
            segment_callback=states_j.append, **kw)
    assert [r["iteration"] for r in seen] == list(range(1, 10))
    assert [r.keys() for r in seen] == [r.keys() for r in seen_j]
    assert [s["iteration"] for s in states] == [3, 6, 9]
    assert [s.keys() for s in states] == [s.keys() for s in states_j]
    np.testing.assert_array_equal([r["rmse"] for r in seen],
                                  res.history_rmse)
    np.testing.assert_array_equal(seen[-1]["transform"],
                                  res.history_transform[-1])
    assert seen[-1]["rotation_angle_deg"] == res.history_rotation_deg[-1]


def test_stop_event_stops_at_a_segment_boundary():
    src, tgt, _ = _pair()
    ev = threading.Event()

    def stop_after_2(rec):
        if rec["iteration"] >= 2:
            ev.set()

    res = icp_register(src, tgt, nn_backend="bruteforce", max_iterations=30,
                       tolerance=1e-12, segment_iterations=2,
                       progress_callback=stop_after_2, stop_event=ev,
                       device="cpu")
    assert res.stop_reason == STOPPED and res.message == "stopped by user"
    assert not res.success and res.iterations == 2


def test_resume_from_a_segment_record_is_bit_identical(one_dispatch):
    src, tgt, full = one_dispatch
    states = []
    first = icp_register(src, tgt, max_iterations=6, segment_iterations=3,
                         segment_callback=states.append, **BRUTE)
    assert states[-1]["iteration"] == first.iterations == 6
    rest = icp_register(src, tgt, max_iterations=34, resume_carry=states[-1],
                        **BRUTE)
    assert first.iterations + rest.iterations == full.iterations
    assert rest.stop_reason == full.stop_reason
    for f in HIST:
        np.testing.assert_array_equal(
            np.concatenate([getattr(first, f), getattr(rest, f)]),
            getattr(full, f), f)
    np.testing.assert_array_equal(rest.transform, full.transform)
    np.testing.assert_array_equal(rest.source_registered,
                                  full.source_registered)


def test_initial_transform_and_resume_carry_exclude_each_other():
    src, tgt, _ = _pair()
    with pytest.raises(ValueError, match="mutually exclusive"):
        icp_register(src, tgt, initial_transform=np.eye(4),
                     resume_carry=(np.eye(4), 1.0, 0), device="cpu")


TWO_STAGE = dict(nn_backend="pallas", estimator="plane",
                 coarse_max_points=3000, coarse_iterations=10)


@pytest.fixture(scope="module")
def terrain25k():
    return make_registration_pair(n=25_000, seed=21, noise_sigma=0.02,
                                  kind="terrain", extent=100.0)


def test_two_stage_fine_level_matches_jax(terrain25k):
    from iterativeclosestpoint_tpu_torch.ops.cellblock import (
        auto_resolution_data,
        surface_boost_ok,
    )

    src, tgt, T_true = terrain25k
    r, base = auto_resolution_data(tgt, surface_boost_occupancy=32,
                                   return_base=True)
    assert r == base and surface_boost_ok(tgt, 2 * base, occupancy=16)
    kw = dict(max_iterations=12, tolerance=0.0, **TWO_STAGE)
    ref = jax_multiscale(src, tgt, dtype=jnp.float32, **kw)
    res = icp_register_multiscale(src, tgt, device="cpu", **kw)
    assert res.final.nn_resolution == ref.final.nn_resolution == 2 * base
    assert [(s, r.iterations, r.stop_reason) for s, r in res.levels] == [
        (s, r.iterations, r.stop_reason) for s, r in ref.levels]
    assert res.final.iterations == len(res.final.history_rmse) == 12
    pa = src @ res.transform[:3, :3].T + res.transform[:3, 3]
    pb = src @ ref.transform[:3, :3].T + ref.transform[:3, 3]
    assert np.linalg.norm(pa - pb, axis=1).max() <= 1e-4
    pt = src @ T_true[:3, :3].T + T_true[:3, 3]
    assert np.linalg.norm(pa - pt, axis=1).max() < 1e-2


def test_two_stage_segment_callback_numbering(terrain25k):
    """Stage 1 (5 iterations in segments of 2): 2, 4, 5; stage 2 (4
    iterations, offset by 5): 7, 9."""
    src, tgt, _ = terrain25k
    seen = []
    res = icp_register_multiscale(
        src, tgt, max_iterations=9, tolerance=0.0, segment_iterations=2,
        segment_callback=lambda st: seen.append(st["iteration"]),
        return_registered=False, device="cpu", **TWO_STAGE)
    assert res.final.iterations == 9
    assert seen == [2, 4, 5, 7, 9]


@pytest.mark.parametrize("case", ["max_iterations_4", "tolerance_1"])
def test_two_stage_stays_single_stage(terrain25k, case):
    """A budget within stage 1, or an early stop in it: the result is
    stage 1's, on the base grid, with the registered cloud delivered."""
    src, tgt, _ = terrain25k
    kw = (dict(max_iterations=4, tolerance=0.0) if case == "max_iterations_4"
          else dict(max_iterations=12, tolerance=1.0))
    res = icp_register_multiscale(src, tgt, device="cpu", **kw, **TWO_STAGE)
    assert res.final.iterations < 5
    assert res.final.nn_resolution == 16  # the base grid
    reg = res.final.source_registered
    T = res.transform
    np.testing.assert_allclose(reg, src @ T[:3, :3].T + T[:3, 3], atol=1e-4)
