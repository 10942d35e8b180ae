"""The plain reference on tiny pairs: its pieces against known answers,
and its steps against the program's own float64 run on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import check, synth
from portbench.reference import icp_ref
from portbench.run import library_entry

SETTINGS = {"n_points": 3000, "coarse_max_points": 1000,
            "coarse_iterations": 6, "coarse_tolerance": 1e-4,
            "max_iterations": 5, "tolerance": 0.0, "sigma_multiplier": 3.0,
            "mode": "gui", "nn_backend": "bruteforce", "dtype": "float64",
            "return_registered": False}
MIX = {"kind": "terrain", "extent": 50.0, "noise_sigma": 0.02,
       "utm_offset": [500000.0, 5400000.0, 250.0],
       "tile_step": [200.0, 0.0, 0.0], "pool_points": 6000, "pool_min": 2}


def test_kabsch_recovers_a_rigid_motion():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(500, 3)) * 10
    T = synth.random_rigid_transform(3)
    dst = src @ T[:3, :3].T + T[:3, 3]
    w = np.ones(500)
    w[:50] = 0.0
    dst[:50] += 5.0  # outliers off the mask change nothing
    np.testing.assert_allclose(icp_ref.kabsch(src, dst, w), T, atol=1e-12)


def test_plane_step_on_a_plane_moves_along_its_normal_only():
    rng = np.random.default_rng(1)
    tgt = np.c_[rng.uniform(-5, 5, (400, 2)), np.zeros(400)]
    cur = tgt + [0.3, -0.2, 0.05]
    nrm = np.tile([0.0, 0.0, 1.0], (400, 1))
    T = icp_ref.plane_increment(cur, tgt, nrm, np.ones(400))
    # The damping 1e-6 tr(H) / 6 leaves rounding-sized rotations.
    np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=1e-7)
    np.testing.assert_allclose(T[:3, 3], [0, 0, -0.05], atol=1e-6)


def test_se3_exp_is_a_rigid_motion():
    T = icp_ref.se3_exp(np.array([0.1, -0.2, 0.3, 0.02, -0.01, 0.03]))
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3),
                               atol=1e-14)
    np.testing.assert_allclose(
        icp_ref.se3_exp(np.array([1.0, 2.0, 3.0, 0, 0, 0]))[:3, 3],
        [1, 2, 3])


def test_normals_match_the_ports_host_estimate():
    from iterativeclosestpoint_tpu_torch.ops.cellblock import (
        auto_resolution_data,
    )
    from iterativeclosestpoint_tpu_torch.ops.normals import (
        estimate_normals_cellpca,
    )

    tgt = synth.make_cloud(20000, seed=4, kind="terrain", extent=50.0)
    tgt -= icp_ref.center_offset(tgt)
    r = icp_ref.base_resolution(tgt)
    assert r == auto_resolution_data(tgt.astype(np.float32))
    mine = icp_ref.cellpca_normals(tgt, r)
    theirs = estimate_normals_cellpca(tgt, r)
    assert np.abs((mine * theirs).sum(axis=1)).min() > 1 - 1e-9


def test_level_strides_match_the_ports_ladder():
    assert icp_ref.level_strides(1_000_000, 30000) == (34, 1)
    assert icp_ref.level_strides(10_000_000, 30000) == (334, 18, 1)
    assert icp_ref.level_strides(20000, 30000) == (1,)


@pytest.mark.parametrize("estimator", ["point", "plane"])
def test_reference_follows_the_ports_float64_run(estimator):
    """At float64 with the plain exact search the program and the
    reference do the same arithmetic: every reading is rounding (the
    program moves a coarse level's source on the host in world
    coordinates, hundreds of kilometres out, so rounding is ~1e-9 m)."""
    settings = dict(SETTINGS, estimator=estimator)
    register = library_entry(settings, "cpu")
    pool = synth.make_pool(settings["n_points"], 21, MIX)
    regs = [{"index": i, "pair": i, "levels": register(p)}
            for i, p in enumerate(pool)]
    got = check.compare(pool, regs, settings, {"points": 6000, "steps": 1},
                        21)
    assert got["pose_m"] < 1e-8
    assert got["mean_rel"] < 1e-7 and got["rmse_rel"] < 1e-7
    assert got["valid_share"] == 0 and got["stop_gap"] == 0
