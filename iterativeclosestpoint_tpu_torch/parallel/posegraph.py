"""Pose-graph Gauss-Newton with the edges split over a mesh's ranks.

Counterpart of the JAX package's ``parallel/posegraph.py``
(``_accumulate`` :52, ``_solve_sharded`` :86,
``optimize_pose_graph_sharded`` :165). Each rank holds a contiguous shard
of the edges, zero-weight padded to a rank multiple, and computes their
residuals, exact Jacobians and 6×6 normal-equation blocks, summed by the
single-device solver's dense incidence product
(``models.posegraph.normal_equations``); one ``psum`` (a left fold in
rank order) gives every rank the same (H, b). The small gauge-fixed solve
then runs on every rank, so the poses and the stop decision are the same
bits everywhere.

Parity with the local solver (``models.posegraph.optimize_pose_graph``):
the anchor conjugation, the lagged IRLS weights (huber/tukey, from the
fourth iteration), whose scale is the exact global interpolated median of
the real edges' residual norms (two bit-pattern bisections through
``psum``, ``models.icp._global_masked_kth``), f64 by default, and the
non-finite guard. The RMS residual counts real edges only.

On a mesh over several processes every process builds the edge shards
from the same ``edges`` and runs only its own ranks'.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.models.icp import _global_masked_kth
from iterativeclosestpoint_tpu_torch.models.posegraph import (
    PoseGraphResult,
    _disconnected_from,
    _edge_system,
    gn_step,
    normal_equations,
)
from iterativeclosestpoint_tpu_torch.parallel.mesh import Mesh, make_mesh
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device

# torch.func's forward-mode AD levels are process-wide, not per thread:
# two ranks inside ``jacfwd`` at once corrupt each other's level. The
# ranks take turns for their (small) Jacobian computations.
_JACOBIAN_LOCK = threading.Lock()


def _accumulate(r, J_i, J_j, P_i, P_j, w, ps):
    """A rank's edge systems → the psum-reduced global (H, b, Σr², count
    of residual entries on real edges)."""
    H, b = normal_equations(r, J_i, J_j, P_i, P_j)
    sq = (r * r).sum()
    cnt = (w > 0).to(r.dtype).sum() * r.shape[-1]
    return ps(H), ps(b), ps(sq), ps(cnt)


def _solve_rank(comm, ii, jj, Z_inv, w, *, n_poses: int,
                max_iterations: int, damping: float, tolerance: float,
                robust: str):
    """The GN loop on one rank's edge shard. Returns (poses, iterations,
    converged, rmse), the same on every rank."""
    ps = comm.psum
    dtype, dev = Z_inv.dtype, Z_inv.device
    k = n_poses
    P_i = torch.nn.functional.one_hot(ii, k).to(dtype)
    P_j = torch.nn.functional.one_hot(jj, k).to(dtype)
    poses = torch.eye(4, dtype=dtype, device=dev).expand(k, 4, 4)
    w_eff = w
    it_done = 0
    converged = False
    rmse = float("inf")
    for it in range(max_iterations):
        with _JACOBIAN_LOCK:
            r, J_i, J_j = _edge_system(poses[ii], poses[jj], Z_inv, w_eff)
        H, b, sq, cnt = _accumulate(r, J_i, J_j, P_i, P_j, w_eff, ps)
        rmse = float(torch.sqrt(sq / torch.clamp(cnt, min=1.0)))
        if robust in ("huber", "tukey") and it >= 3:
            # Lagged IRLS, as the local solver: weights from this
            # iteration's residuals apply to the next system, from the
            # fourth iteration on. Scale: the global interpolated median
            # of the real edges' residual norms.
            rn = torch.linalg.vector_norm(r, dim=1) / torch.sqrt(
                torch.clamp(w_eff, min=1e-30))
            valid = w > 0
            cnt_e = ps(valid.sum(dtype=torch.int32))
            k_lo = torch.clamp(cnt_e - 1, min=0) // 2
            k_up = cnt_e // 2
            med = (_global_masked_kth(rn, valid, k_lo, ps)
                   + _global_masked_kth(rn, valid, k_up, ps)) / 2.0
            scale = med + 1e-12
            if robust == "huber":
                w_rob = torch.clamp(scale / torch.clamp(rn, min=1e-30),
                                    max=1.0)
            else:
                u = torch.clip(rn / (3.0 * scale), 0.0, 1.0)
                w_rob = (1.0 - u * u) ** 2
            w_eff = w * torch.clamp(w_rob, min=1e-12)
        poses, delta = gn_step(poses, H, b, damping)
        it_done = it + 1
        if float(delta.abs().max()) < tolerance:  # the same on every rank
            converged = True
            break
    return poses, it_done, converged, rmse


def optimize_pose_graph_sharded(
    edges: Sequence[Tuple[int, int, np.ndarray]],
    n_poses: int,
    weights: Optional[Sequence[float]] = None,
    mesh: Optional[Mesh] = None,
    max_iterations: int = 20,
    tolerance: float = 1e-10,
    damping: float = 1e-8,
    dtype=None,
    anchor: Optional[np.ndarray] = None,
    robust: str = "none",
    device=None,
) -> PoseGraphResult:
    """``models.posegraph.optimize_pose_graph`` with the edges split over
    ``mesh`` (default ``make_mesh(device=device)``): the same arguments
    and result. ``dtype`` None means ``torch.float64``."""
    if robust not in ("none", "huber", "tukey"):
        raise ValueError(f"unknown robust mode {robust!r}")
    if dtype is None:
        dtype = torch.float64
    if mesh is None:
        mesh = make_mesh(device=device)
    for d in mesh.local_devices:
        resolve_device(d)
    k = n_poses
    E = len(edges)
    if E == 0:
        return PoseGraphResult(
            poses=np.broadcast_to(np.eye(4), (k, 4, 4)).copy(),
            iterations=0, residual_rmse=float("inf"), converged=False,
            disconnected=list(range(1, k)))
    D = mesh.size
    E_pad = max(D, -(-E // D) * D)

    W = np.eye(4)
    if anchor is not None:
        W[:3, 3] = np.asarray(anchor, np.float64)
    W_inv = np.eye(4)
    W_inv[:3, 3] = -W[:3, 3]
    # Padding edges (0, 0, I) with weight 0 contribute nothing: their
    # residuals and Jacobians are scaled by √0 in _edge_system.
    ii = np.zeros(E_pad, np.int64)
    jj = np.zeros(E_pad, np.int64)
    Z_inv = np.tile(np.eye(4), (E_pad, 1, 1))
    w = np.zeros(E_pad)
    for e, (i, j, Z) in enumerate(edges):
        ii[e], jj[e] = i, j
        # Conjugated measurement (see the local solver): Z'⁻¹ = W⁻¹Z⁻¹W.
        Z_inv[e] = W_inv @ np.linalg.inv(np.asarray(Z, np.float64)) @ W
        w[e] = 1.0 if weights is None else float(weights[e])

    per = E_pad // D

    def rank_fn(comm):
        sl = slice(comm.rank * per, (comm.rank + 1) * per)
        dev = comm.device
        return _solve_rank(
            comm, torch.as_tensor(ii[sl], device=dev),
            torch.as_tensor(jj[sl], device=dev),
            torch.as_tensor(Z_inv[sl], dtype=dtype, device=dev),
            torch.as_tensor(w[sl], dtype=dtype, device=dev),
            n_poses=k, max_iterations=max_iterations, damping=damping,
            tolerance=tolerance, robust=robust)

    poses, iters, converged, rmse = mesh.run(rank_fn)[mesh.local_ranks[0]]
    poses_np = W @ poses.cpu().numpy().astype(np.float64) @ W_inv
    if not np.isfinite(poses_np).all():
        rmse, converged = float("inf"), False
        poses_np = np.broadcast_to(np.eye(4), (k, 4, 4)).copy()
    return PoseGraphResult(
        poses=poses_np, iterations=iters, residual_rmse=rmse,
        converged=converged, disconnected=_disconnected_from(k, edges))
