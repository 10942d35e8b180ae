"""Port parity: ``register_scans`` against the JAX package on the CPU
(the single-device tests of ``tests/test_posegraph.py``, mirrored).

Same edges, device-residency counters, per-edge iterations and stop codes
as the JAX package; edge transforms and poses within 1e-4 m registration
error (the f32 parity gate of PARITY.md: the two packages sum the f32
statistics in different orders). f64 brute-force runs are held to the
JAX test's 1e-4 m against the scene.
"""

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.models import posegraph as jpg
from iterativeclosestpoint_tpu.utils.synth import (
    apply_transform_np,
    make_cloud,
    random_rigid_transform,
)
from iterativeclosestpoint_tpu_torch.models import posegraph as tpg

F64 = torch.float64


def _reg_err(Ta, Tb, pts):
    return float(np.abs(apply_transform_np(Ta, pts)
                        - apply_transform_np(Tb, pts)).max())


def _overlapping_strip_scans(k=4, seed=5, n=1200):
    """k x-windows of one world cloud: width 45% of the extent, step 25%
    (adjacent scans share ~20% of the extent, scans two apart nothing)."""
    rng = np.random.default_rng(seed)
    world = make_cloud(k * n, seed=seed)
    x = world[:, 0]
    lo, hi = x.min(), x.max()
    ext = hi - lo
    scans = []
    for s in range(k):
        w_lo = lo + s * 0.25 * ext
        sel = world[(x >= w_lo) & (x <= w_lo + 0.45 * ext)]
        scans.append(sel + rng.normal(0, 0.005, sel.shape))
    return scans


@pytest.mark.parametrize("case", ["chain", "auto", "reuse"])
def test_register_scans_matches_jax(case):
    """Same edges, device-residency counters, per-edge iterations and
    stop codes as the JAX package; edge transforms and poses within
    1e-4 m. ``auto`` detects the chain of the same strips (so the JAX
    package reuses its compiled loops); ``reuse`` revisits target 1 (edge
    (1, 0)): one upload and one grid per unique target, one cropped
    source per edge."""
    scans = _overlapping_strip_scans(k=3, n=900)
    kw = dict(max_iterations=10, tolerance=0.0)
    if case == "auto":
        kw["edges"] = "auto"
    elif case == "reuse":
        kw.update(edges=[(0, 1), (1, 2), (1, 0)], reuse_device=True)
    s_ref, s_out = {}, {}
    ref = jpg.register_scans(scans, stats=s_ref, **kw)
    out = tpg.register_scans(scans, stats=s_out, device="cpu", **kw)
    assert s_out == s_ref
    if case == "reuse":
        assert s_out == {"scan_uploads": 2, "grids_built": 2,
                         "cropped_source_uploads": 3}
    assert out.disconnected == ref.disconnected == []
    assert (out.iterations, out.converged) == (ref.iterations,
                                               ref.converged)
    assert len(out.edge_results) == len(ref.edge_results)
    for a, b in zip(out.edge_results, ref.edge_results):
        assert (a.iterations, a.stop_reason, a.nn_resolution) == (
            b.iterations, b.stop_reason, b.nn_resolution)
        assert _reg_err(a.transform, b.transform, scans[0]) <= 1e-4
    for s, scan in enumerate(scans):
        assert _reg_err(out.poses[s], ref.poses[s], scan) <= 1e-4


def test_register_scans_end_to_end():
    """3 scans of one scene in known frames, f64 brute force: the joint
    registration maps every scan back onto the scene."""
    base = make_cloud(1500, seed=21)
    poses = [np.eye(4)] + [random_rigid_transform(seed=30 + s)
                           for s in range(1, 3)]
    scans = [apply_transform_np(np.linalg.inv(T), base) for T in poses]
    out = tpg.register_scans(
        scans, edges=[(0, 1), (1, 2), (0, 2)], dtype=F64,
        nn_backend="bruteforce", max_iterations=120, device="cpu")
    for s in range(3):
        np.testing.assert_allclose(apply_transform_np(out.poses[s],
                                                      scans[s]),
                                   base, atol=1e-4)


def test_register_scans_failed_edges_surface_as_disconnected():
    base = make_cloud(2000, seed=5)
    out = tpg.register_scans([base, base[:2]], dtype=F64,
                             nn_backend="bruteforce", max_iterations=5,
                             device="cpu")
    assert not out.edge_results[0].success
    assert out.disconnected == [1]


@pytest.mark.parametrize("kw", [dict(mesh=2), dict(partition=True)])
def test_register_scans_multi_device_raises(kw):
    """``mesh`` runs the edges and the pose graph over a 2-rank CPU mesh
    (within 1e-9 m of one device, f64); ``partition`` without a mesh
    raises, as in the JAX package."""
    from iterativeclosestpoint_tpu_torch.parallel import make_mesh

    if "partition" in kw:
        with pytest.raises(ValueError, match="requires a mesh"):
            tpg.register_scans([np.zeros((4, 3))] * 2, device="cpu", **kw)
        return
    base = make_cloud(1500, seed=5)
    T = random_rigid_transform(seed=6, max_yaw_deg=2.0, max_txy=0.3)
    scans = [base, apply_transform_np(np.linalg.inv(T), base)]
    run = dict(dtype=F64, nn_backend="bruteforce", max_iterations=15,
               device="cpu")
    one = tpg.register_scans(scans, **run)
    two = tpg.register_scans(
        scans, mesh=make_mesh(devices=["cpu"] * kw["mesh"]), **run)
    assert [r.iterations for r in two.edge_results] == [
        r.iterations for r in one.edge_results]
    assert two.iterations == one.iterations
    assert _reg_err(two.poses[1], one.poses[1], base) < 1e-9
