"""Port parity: the edge-sharded pose-graph Gauss-Newton
(``parallel/posegraph.py``) on CPU mesh ranks, against the port's
single-device solver and the JAX package's ``optimize_pose_graph_sharded``
(mirrors ``tests/test_posegraph_sharded.py``).

Tolerances: exact graphs recover the truth to the JAX test's 1e-8;
noisy graphs agree with the single-device solve to 1e-9 (f64; the rank
sums only change the summation order), also with tukey IRLS, whose
median is the exact global one; against the JAX package's sharded solve
1e-9. About 25 s alone on one worker.
"""

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.parallel.mesh import make_mesh as jax_mesh
from iterativeclosestpoint_tpu.parallel.posegraph import (
    optimize_pose_graph_sharded as jax_sharded,
)
from iterativeclosestpoint_tpu.utils.synth import random_rigid_transform
from iterativeclosestpoint_tpu_torch.models.posegraph import (
    optimize_pose_graph,
)
from iterativeclosestpoint_tpu_torch.ops.se3 import se3_exp
from iterativeclosestpoint_tpu_torch.parallel import (
    make_mesh,
    optimize_pose_graph_sharded,
)


def _mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _chain_with_loop(k, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    poses = [np.eye(4)] + [random_rigid_transform(seed=seed + s)
                           for s in range(1, k)]
    edges = []
    for i in range(k - 1):
        Z = np.linalg.inv(poses[i]) @ poses[i + 1]
        if noise:
            Z = Z @ se3_exp(torch.as_tensor(rng.normal(0, noise, 6))).numpy()
        edges.append((i, i + 1, Z))
    edges.append((0, k - 1, np.linalg.inv(poses[0]) @ poses[k - 1]))
    return poses, edges


def test_sharded_matches_host_exact():
    poses, edges = _chain_with_loop(6, 40)
    out = optimize_pose_graph_sharded(edges, n_poses=6, mesh=_mesh(8))
    for s in range(6):
        np.testing.assert_allclose(out.poses[s], poses[s], atol=1e-8)


def test_sharded_matches_host_noisy():
    _, edges = _chain_with_loop(7, 41, noise=0.01)
    out_h = optimize_pose_graph(edges, n_poses=7, max_iterations=15,
                                device="cpu")
    out_s = optimize_pose_graph_sharded(edges, n_poses=7, mesh=_mesh(4),
                                        max_iterations=15)
    assert out_s.iterations == out_h.iterations
    np.testing.assert_allclose(out_s.poses, out_h.poses, rtol=0, atol=1e-9)
    np.testing.assert_allclose(out_s.residual_rmse, out_h.residual_rmse,
                               rtol=1e-9)


def test_edge_count_not_multiple_of_devices():
    """4 edges over 8 ranks: the padding edges contribute nothing."""
    poses, edges = _chain_with_loop(4, 42)
    out = optimize_pose_graph_sharded(edges, n_poses=4, mesh=_mesh(8))
    for s in range(4):
        np.testing.assert_allclose(out.poses[s], poses[s], atol=1e-8)


@pytest.mark.parametrize("robust", ["none", "tukey"])
def test_sharded_matches_jax_and_single_device(robust):
    """A 5-pose graph with one corrupted edge, weighted and anchored near
    the scene: the port's 4-rank solve equals its single-device solve and
    the JAX package's 4-device one."""
    poses = [np.eye(4)] + [random_rigid_transform(seed=11 + s)
                           for s in range(1, 5)]
    edges = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1])
             for i in range(4)]
    edges.append((0, 4, np.linalg.inv(poses[0]) @ poses[4]))
    bad = np.linalg.inv(poses[1]) @ poses[3]
    bad[:3, 3] += np.array([2.0, -1.5, 1.0])
    edges.append((1, 3, bad))
    kw = dict(n_poses=5, robust=robust, max_iterations=40,
              weights=[1.0, 2.0, 1.5, 1.0, 3.0, 1.0],
              anchor=np.array([3.0, -2.0, 1.0]))
    one = optimize_pose_graph(edges, device="cpu", **kw)
    four = optimize_pose_graph_sharded(edges, mesh=_mesh(4), **kw)
    ref = jax_sharded(edges, mesh=jax_mesh(n_devices=4), **kw)
    for other in (one, ref):
        assert four.iterations == other.iterations
        assert four.converged == other.converged
        np.testing.assert_allclose(four.poses, other.poses, rtol=0,
                                   atol=1e-9)
    if robust == "tukey":
        for s in range(5):
            np.testing.assert_allclose(four.poses[s], poses[s], atol=1e-6)


def test_empty_graph_and_bad_robust():
    out = optimize_pose_graph_sharded([], n_poses=3, mesh=_mesh(2))
    assert not out.converged and out.disconnected == [1, 2]
    with pytest.raises(ValueError, match="robust"):
        optimize_pose_graph_sharded([], n_poses=3, mesh=_mesh(2),
                                    robust="hubert")
