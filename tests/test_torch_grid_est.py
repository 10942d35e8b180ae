"""The multiscale fine level's grid estimate on the device
(``ops/sweep_params.py::estimate_fine_grid_device``) against the numpy
estimators it replaces (``estimate_fine_grid``): whole registrations bit
for bit, its counters in ``icp-torch run --metrics``, and on the card the
benchmark's 1M and 10M targets with one read per pass.

``tests/test_torch_grid.py`` holds the estimate itself on CPU tensors,
case by case, against the numpy calls and the JAX package. The card tests
(``-m cuda``) import no JAX, so on a machine with a card::

    python -m pytest --noconftest -m cuda tests/test_torch_grid_est.py
"""

import functools
import json
import warnings

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu_torch import icp_register_multiscale
from iterativeclosestpoint_tpu_torch.cli import main as cli_main
from iterativeclosestpoint_tpu_torch.models import prep
from iterativeclosestpoint_tpu_torch.ops import sweep_params
from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
    estimate_fine_grid,
    estimate_fine_grid_device,
)
from iterativeclosestpoint_tpu_torch.runtime import session
from iterativeclosestpoint_tpu_torch.runtime.timing import collect, stage
from iterativeclosestpoint_tpu_torch.utils.hostmath import bbox, center_offset
from iterativeclosestpoint_tpu_torch.utils.synth import make_registration_pair


def _lattice():
    """Rows on the f32 lattice m · E / 512 (E = 253.31756591796875, m = 0
    to 512 on each axis): 19 of its values divided by the cell E / 512 are
    whole numbers, and 18 of them fall one cell lower as products by the
    cell's reciprocal."""
    lat = (np.arange(513) * (253.31756591796875 / 512)).astype(np.float32)
    pts = lat[np.random.default_rng(3).integers(0, 513, (20_000, 3))]
    pts[0], pts[1] = lat[0], lat[-1]
    return pts


def _assert_cells_round_as_numpy(dev):
    """The estimate grid's cells of the lattice, on ``dev``, are numpy's."""
    pts = _lattice()
    tmin, tmax = bbox(pts)
    want = np.clip(((pts - tmin) / (float((tmax - tmin).max()) / 512))
                   .astype(np.int64), 0, 511)
    t = torch.as_tensor(pts, device=dev)
    lo, _, cell = sweep_params._est_box(t)
    got = sweep_params._sample_cells(t, 1, lo, cell, 512).cpu().numpy()
    assert np.array_equal(got, want)


def test_estimate_cells_round_as_numpy():
    _assert_cells_round_as_numpy("cpu")


def _host_estimate(tgt_dev, resolution, **kw):
    """The numpy calls the fine level made before the device estimate."""
    return estimate_fine_grid(tgt_dev.cpu().numpy(), resolution, **kw)


@pytest.mark.parametrize("estimator", ["point", "plane"])
def test_registration_bit_equal_to_the_numpy_estimate(estimator,
                                                      monkeypatch):
    """A multiscale registration (plane: the two-stage fine level) gives
    the same transform and histories with the device estimate as with the
    numpy one."""
    src, tgt, _ = make_registration_pair(n=8000, seed=21, noise_sigma=0.02,
                                         extent=100.0)
    kw = dict(coarse_max_points=1500, coarse_iterations=3, max_iterations=6,
              tolerance=0.0, nn_backend="pallas", estimator=estimator,
              device="cpu")
    seen = []

    def spy(tgt_dev, resolution, **k):
        seen.append(estimate_fine_grid_device(tgt_dev, resolution, **k))
        return seen[-1]

    monkeypatch.setattr(prep, "estimate_fine_grid_device", spy)
    dev = icp_register_multiscale(src, tgt, **kw)
    monkeypatch.setattr(prep, "estimate_fine_grid_device", _host_estimate)
    host = icp_register_multiscale(src, tgt, **kw)
    (grid_est, boost2_est), = seen
    assert (boost2_est is not None) == (estimator == "plane")
    assert dev.final.nn_resolution == (boost2_est or grid_est)[0]
    assert len(dev.levels) == len(host.levels) == 2
    for (_, a), (_, b) in zip(dev.levels, host.levels):
        for f in ("transform", "history_transform", "history_rmse",
                  "history_valid", "history_mean_dist"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_cli_metrics_count_the_estimate_passes_and_reads(tmp_path,
                                                        monkeypatch):
    """``icp-torch run --multiscale --metrics``, its coarse level cut to
    1,500 points and 3 iterations so a 3,000-point pair has one."""
    monkeypatch.setattr(session, "icp_register_multiscale", functools.partial(
        icp_register_multiscale, coarse_max_points=1500,
        coarse_iterations=3))
    sp, tp = tmp_path / "s.las", tmp_path / "t.las"
    assert cli_main(["synth", str(sp), str(tp), "--n", "3000", "--seed",
                     "11", "--noise", "0.02"]) == 0
    assert cli_main(["--device", "cpu", "run", str(sp), str(tp), "-o",
                     str(tmp_path / "r.las"), "--multiscale",
                     "--nn-backend", "pallas", "--max-iterations", "2",
                     "--metrics", str(tmp_path / "m.jsonl")]) == 0
    last = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    est = last["stages"]["grid_est"]
    assert (est["calls"], est["cloud_passes"], est["est_reads"]) == (1, 1, 1)


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


# The benchmark's targets (portbench/traffic/*-near.json, tile 0): kind,
# points, estimator, and the passes over the cloud the estimate makes.
_CARD_TARGETS = {
    "terrain1m-point.tiles-near": ("terrain", 1_000_000, "point", 1),
    "terrain1m-point.volume-near": ("uniform", 1_000_000, "point", 2),
    "terrain10m-plane.tiles-near": ("terrain", 10_000_000, "plane", 1),
}


@pytest.mark.cuda
def test_card_cells_divide_as_numpy(card):
    """On the card too the quotient is a division, not a product by the
    reciprocal (which a divisor held on the host would give)."""
    _assert_cells_round_as_numpy(card)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(_CARD_TARGETS))
def test_card_estimate_equals_numpy_on_the_benchmark_targets(card, cell):
    """The card's estimate is the numpy one on the cells' targets, centred
    and rounded to f32 as the fine level does; it makes ``cloud_passes``
    passes and synchronises exactly ``est_reads`` times."""
    from portbench.synth import make_registration_pair as bench_pair

    kind, n, estimator, passes = _CARD_TARGETS[cell]
    _, tgt, _ = bench_pair(n, seed=1234567, noise_sigma=0.02, kind=kind,
                           extent=100.0)
    tgt = tgt + np.array([500000.0, 5400000.0, 250.0])
    tgt_local = (tgt - center_offset(tgt)).astype(np.float32)
    tgt_dev = torch.as_tensor(tgt_local, device=card)
    plane = estimator == "plane"
    want = estimate_fine_grid(tgt_local, None, plane=plane)
    estimate_fine_grid_device(tgt_dev, None, plane=plane)  # warm
    torch.cuda.synchronize()
    syncs = []
    with collect(sync=False) as col, warnings.catch_warnings():
        warnings.simplefilter("always")
        old, warnings.showwarning = warnings.showwarning, (
            lambda msg, *a, **k: syncs.append(msg)
            if "called a synchronizing" in str(msg) else None)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with stage("grid_est"):
                got = estimate_fine_grid_device(tgt_dev, None, plane=plane)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = old
    assert got == want, (got, want)
    meta = col.meta["grid_est"]
    assert meta["cloud_passes"] == passes
    assert meta["est_reads"] == len(syncs) == passes
