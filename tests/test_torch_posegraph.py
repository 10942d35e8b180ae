"""Port parity: the SE(3) maps, the pose-graph Gauss-Newton,
``register_scans`` and ``icp-torch graph`` against the JAX package on the
CPU (the single-device tests of ``tests/test_posegraph.py``, mirrored).

Tolerances and why:

* f64 SE(3) maps: 1e-12 (the same formulas, op for op);
* ``_edge_system``'s residual and forward-mode Jacobians: 1e-10 (exact
  derivatives in both packages; only rounding order differs);
* f64 ``optimize_pose_graph`` poses: 1e-9 (the repository's oracle gate;
  the block sums run in another order);
* f32 pose graph with an anchor: the JAX test's 5e-3 m point displacement
  against the truth;
* ``icp-torch graph``: its poses are the library call's bit for bit.

``register_scans`` is held against the JAX package in
``test_torch_register_scans.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.models import posegraph as jpg
from iterativeclosestpoint_tpu.ops import se3 as jse3
from iterativeclosestpoint_tpu.utils.synth import (
    apply_transform_np,
    make_cloud,
    random_rigid_transform,
)
from iterativeclosestpoint_tpu_torch.cli import main as cli_main
from iterativeclosestpoint_tpu_torch.io.las import read_las, write_las
from iterativeclosestpoint_tpu_torch.models import posegraph as tpg
from iterativeclosestpoint_tpu_torch.ops import se3 as tse3

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _reg_err(Ta, Tb, pts):
    return float(np.abs(apply_transform_np(Ta, pts)
                        - apply_transform_np(Tb, pts)).max())


def test_se3_maps_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        xi = rng.normal(0, 0.5, 6)
        T = tse3.se3_exp(_t(xi))
        np.testing.assert_allclose(T.numpy(), np.asarray(
            jse3.se3_exp(jnp.asarray(xi))), atol=1e-12)
        np.testing.assert_allclose(tse3.se3_log(T).numpy(), np.asarray(
            jse3.se3_log(jnp.asarray(T.numpy()))), atol=1e-12)
        np.testing.assert_allclose(tse3.se3_log(T).numpy(), xi, atol=1e-9)
        np.testing.assert_allclose(
            tse3.so3_log(T[:3, :3]).numpy(),
            np.asarray(jse3.so3_log(jnp.asarray(T[:3, :3].numpy()))),
            atol=1e-12)
        np.testing.assert_allclose(
            tse3.invert_transform(T).numpy(),
            np.asarray(jse3.invert_transform(jnp.asarray(T.numpy()))),
            atol=1e-12)
        U = tse3.se3_exp(_t(rng.normal(0, 0.5, 6)))
        np.testing.assert_array_equal(tse3.compose(U, T).numpy(),
                                      (U @ T).numpy())
        np.testing.assert_array_equal(
            tse3.make_transform(T[:3, :3], T[:3, 3]).numpy(), T.numpy())
    # The small-angle branch.
    xi = np.array([1e-12, 2e-12, -1e-12, 1e-13, 0.0, -1e-13])
    np.testing.assert_allclose(tse3.se3_log(tse3.se3_exp(_t(xi))).numpy(),
                               xi, atol=1e-15)


def test_se3_jacobian_at_identity_under_vmap():
    """se3_exp is assembled out of place, so torch.func differentiates it
    under vmap; Log∘Exp has the identity Jacobian at ξ = 0 (the safe
    branches of both maps)."""
    J = torch.func.vmap(torch.func.jacfwd(
        lambda xi: tse3.se3_log(tse3.se3_exp(xi))))(torch.zeros(3, 6,
                                                                dtype=F64))
    np.testing.assert_allclose(J.numpy(), np.broadcast_to(np.eye(6),
                                                          (3, 6, 6)),
                               atol=1e-15)


def test_edge_system_matches_jax():
    rng = np.random.default_rng(3)
    Ti, Tj, Zi = (np.stack([random_rigid_transform(seed=b + s)
                            for s in range(5)]) for b in (100, 200, 300))
    w = rng.uniform(0.5, 2.0, 5)
    ref = jax.vmap(jpg._edge_system)(*(jnp.asarray(x)
                                       for x in (Ti, Tj, Zi, w)))
    got = tpg._edge_system(*(_t(x) for x in (Ti, Tj, Zi, w)))
    for name, a, b in zip(("r", "J_i", "J_j"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-10,
                                   err_msg=name)


def _random_poses(k, seed):
    poses = [np.eye(4)]
    for s in range(1, k):
        poses.append(random_rigid_transform(seed=seed + s))
    return poses


def _outlier_graph():
    """5 poses, a chain, a loop closure and one redundant edge corrupted
    by a 2 m translation: 6 edges, an even count (the median averages the
    two middle residuals)."""
    k = 5
    poses = _random_poses(k, 11)
    edges = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1])
             for i in range(k - 1)]
    edges.append((0, k - 1, np.linalg.inv(poses[0]) @ poses[k - 1]))
    bad = np.linalg.inv(poses[1]) @ poses[3]
    bad[:3, 3] += np.array([2.0, -1.5, 1.0])
    edges.append((1, 3, bad))
    return poses, edges


def _pose_err(out, poses):
    return max(np.abs(out.poses[s] - poses[s]).max()
               for s in range(len(poses)))


@pytest.mark.parametrize("robust,iters", [("none", 20), ("huber", 20),
                                          ("tukey", 40)])
def test_optimize_pose_graph_matches_jax(robust, iters):
    poses, edges = _outlier_graph()
    assert len(edges) % 2 == 0
    ref = jpg.optimize_pose_graph(edges, n_poses=5, dtype=jnp.float64,
                                  robust=robust, max_iterations=iters)
    out = tpg.optimize_pose_graph(edges, n_poses=5, robust=robust,
                                  max_iterations=iters, device="cpu")
    assert (out.iterations, out.converged) == (ref.iterations,
                                               ref.converged)
    np.testing.assert_allclose(out.poses, ref.poses, atol=1e-9)
    np.testing.assert_allclose(out.residual_rmse, ref.residual_rmse,
                               rtol=1e-9)
    if robust == "tukey":  # the redescender rejects the corrupted edge
        assert _pose_err(out, poses) < 1e-6
    if robust == "huber":  # bounds its influence (the JAX test's 60)
        plain = tpg.optimize_pose_graph(edges, n_poses=5, device="cpu")
        out = tpg.optimize_pose_graph(edges, n_poses=5, robust=robust,
                                      max_iterations=60, device="cpu")
        assert _pose_err(out, poses) < 0.6 * _pose_err(plain, poses)


def test_posegraph_exact_measurements():
    k = 5
    poses = _random_poses(k, 7)
    edges = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1])
             for i in range(k - 1)]
    edges.append((0, k - 1, np.linalg.inv(poses[0]) @ poses[k - 1]))
    out = tpg.optimize_pose_graph(edges, n_poses=k, device="cpu")
    assert out.converged
    for s in range(k):
        np.testing.assert_allclose(out.poses[s], poses[s], atol=1e-8)


def test_posegraph_noisy_loop_closure_improves_consistency():
    k = 6
    rng = np.random.default_rng(11)
    poses = _random_poses(k, 13)
    edges = []
    for i in range(k - 1):
        Z = np.linalg.inv(poses[i]) @ poses[i + 1]
        noise = tse3.se3_exp(_t(rng.normal(0, 0.01, 6))).numpy()
        edges.append((i, i + 1, Z @ noise))
    edges.append((0, k - 1, np.linalg.inv(poses[0]) @ poses[k - 1]))
    out = tpg.optimize_pose_graph(edges, n_poses=k, device="cpu")
    T_chain = np.eye(4)
    for i in range(k - 1):
        T_chain = T_chain @ edges[i][2]
    err_chain = np.abs(T_chain - poses[k - 1]).max()
    err_opt = np.abs(out.poses[k - 1] - poses[k - 1]).max()
    assert err_opt < err_chain * 0.5, (err_opt, err_chain)


def test_posegraph_zero_edges_and_disconnected():
    out = tpg.optimize_pose_graph([], n_poses=3, device="cpu")
    assert out.iterations == 0 and not out.converged
    assert out.disconnected == [1, 2] and out.residual_rmse == float("inf")
    np.testing.assert_array_equal(out.poses,
                                  np.broadcast_to(np.eye(4), (3, 4, 4)))
    poses = _random_poses(2, 3)
    out = tpg.optimize_pose_graph(
        [(0, 1, np.linalg.inv(poses[0]) @ poses[1])], n_poses=3,
        device="cpu")
    assert out.disconnected == [2]
    np.testing.assert_allclose(out.poses[2], np.eye(4))  # not estimated
    with pytest.raises(ValueError, match="robust"):
        tpg.optimize_pose_graph([], n_poses=2, robust="hubert",
                                device="cpu")


def test_posegraph_f32_utm_scale_with_anchor():
    c = np.array([500_000.0, 4_000_000.0, 300.0])  # UTM-ish anchor
    k = 4
    C, Ci = np.eye(4), np.eye(4)
    C[:3, 3], Ci[:3, 3] = c, -c
    poses = [np.eye(4)] + [C @ random_rigid_transform(seed=40 + s) @ Ci
                           for s in range(1, k)]
    edges = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1])
             for i in range(k - 1)]
    edges.append((0, k - 1, np.linalg.inv(poses[0]) @ poses[k - 1]))
    out = tpg.optimize_pose_graph(edges, n_poses=k, dtype=torch.float32,
                                  anchor=c, device="cpu")
    pts = make_cloud(500, seed=2) + c  # scene points near the anchor
    for s in range(k):
        assert _reg_err(out.poses[s], poses[s], pts) < 5e-3


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


def test_detect_overlap_edges_matches_jax():
    scans = _overlapping_strip_scans(k=4)
    for mo in (0.1, 0.3, 0.6):
        edges = tpg.detect_overlap_edges(scans, min_overlap=mo)
        assert edges == jpg.detect_overlap_edges(scans, min_overlap=mo)
    edges = tpg.detect_overlap_edges(scans, min_overlap=0.3)
    assert {(0, 1), (1, 2), (2, 3)} <= set(edges)
    assert (0, 3) not in edges


def test_cli_graph_matches_library(tmp_path, capsys):
    """``icp-torch --device cpu graph`` on LAS strips: its pose JSON is
    ``register_scans`` on the decoded clouds bit for bit; the merged LAS
    holds every scan in scan 0's frame."""
    scans = _overlapping_strip_scans(k=3, n=700)
    paths = []
    for s, scan in enumerate(scans):
        p = tmp_path / f"s{s}.las"
        write_las(p, scan + np.array([500_000.0, 4_000_000.0, 100.0]))
        paths.append(p)
    argv = ["--device", "cpu", "graph", *map(str, paths), "--edges", "auto",
            "--loop", "--max-iterations", "10",
            "--poses", str(tmp_path / "p.json"),
            "-o", str(tmp_path / "merged.las"),
            "--html", str(tmp_path / "s.html")]
    assert cli_main(argv) == 0
    out = capsys.readouterr().out
    assert "overlap-detected edges: [(0, 1), (1, 2)]" in out
    doc = json.loads((tmp_path / "p.json").read_text())
    decoded = [read_las(p)[0] for p in paths]
    edges = tpg.detect_overlap_edges(decoded) + [(0, 2)]
    lib = tpg.register_scans(decoded, edges=edges, max_iterations=10,
                             tolerance=1e-6, device="cpu")
    np.testing.assert_array_equal(np.asarray(doc["poses"]), lib.poses)
    assert [e["iterations"] for e in doc["edges"]] == [
        r.iterations for r in lib.edge_results]
    merged, _ = read_las(tmp_path / "merged.las")
    assert len(merged) == sum(len(d) for d in decoded)
    assert "<canvas" in (tmp_path / "s.html").read_text()
