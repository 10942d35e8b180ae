"""Multi-scan joint registration: pairwise ICP edges + pose-graph
Gauss-Newton (BASELINE.json config 5).

Counterpart of the JAX package's ``models/posegraph.py`` on one device.
Each overlapping scan pair contributes an SE(3) edge measured by pairwise
ICP (``models/icp.py``); the absolute poses are then estimated by
Gauss-Newton on the pose graph from per-edge 6×6 normal-equation blocks.

Residual (right-perturbation convention):
    r_e(ξ) = Log( Z_e⁻¹ · (T_i Exp(ξ_i))⁻¹ · (T_j Exp(ξ_j)) )
with Z_e the ICP-measured relative transform taking scan j's frame to
scan i's (T_j ≈ T_i · Z_e). The Jacobians are exact, by forward-mode
autodiff at ξ = 0 (``torch.func.jacfwd`` inside ``torch.func.vmap`` over
the edges). Pose 0 is the gauge. The GN arithmetic is f64 by default on
every device: the system has only 6(k−1) unknowns. The blocks are summed
by a dense incidence product, so H and b come out the same bit for bit on
every run (a scatter-add with duplicate indices accumulates in no fixed
order on the card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.models.icp import ICPResult, icp_register
from iterativeclosestpoint_tpu_torch.ops.se3 import (
    invert_transform,
    se3_exp,
    se3_log,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import scope, stage
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device


def _edge_residual(xi_i, xi_j, T_i, T_j, Z_inv):
    Ti = T_i @ se3_exp(xi_i)
    Tj = T_j @ se3_exp(xi_j)
    return se3_log(Z_inv @ (invert_transform(Ti) @ Tj))


def _edge_system_one(T_i, T_j, Z_inv, weight):
    """One edge's residual and exact Jacobians at ξ = 0, scaled by
    √weight."""
    z6 = torch.zeros(6, dtype=T_i.dtype, device=T_i.device)
    r = _edge_residual(z6, z6, T_i, T_j, Z_inv)
    J_i, J_j = torch.func.jacfwd(_edge_residual, argnums=(0, 1))(
        z6, z6, T_i, T_j, Z_inv)
    w = torch.sqrt(weight)
    return r * w, J_i * w, J_j * w


# (E,4,4), (E,4,4), (E,4,4), (E,) -> r (E,6), J_i (E,6,6), J_j (E,6,6).
_edge_system = torch.func.vmap(_edge_system_one)


@dataclasses.dataclass
class PoseGraphResult:
    poses: np.ndarray          # (k, 4, 4) absolute poses (pose 0 = identity)
    iterations: int
    residual_rmse: float       # final edge-residual RMS
    converged: bool
    edge_results: Optional[List[ICPResult]] = None
    # Scans with no successful-edge path to scan 0: their poses stay
    # identity and are NOT jointly estimated (every entry here means the
    # merged output would misplace that scan).
    disconnected: List[int] = dataclasses.field(default_factory=list)


def detect_overlap_edges(
    scans: Sequence[np.ndarray],
    min_overlap: float = 0.25,
    resolution: int = 32,
    max_points: int = 200_000,
) -> List[Tuple[int, int]]:
    """Overlap-detected pose-graph edges (host, numpy).

    Each scan is voxelized on a shared grid over the union bbox
    (``resolution`` cells on the longest axis); pair (i, j) becomes an
    edge when |occ_i ∩ occ_j| / min(|occ_i|, |occ_j|) ≥ ``min_overlap``.
    Occupancy over a shared grid does not over-connect where plain bbox
    intersection would (long thin survey strips share bbox volume with
    strips they never touch).
    """
    scans = [np.asarray(s) for s in scans]
    lo = np.min([s.min(axis=0) for s in scans], axis=0)
    hi = np.max([s.max(axis=0) for s in scans], axis=0)
    cell = max(float((hi - lo).max()) / resolution, 1e-9)
    R = int(np.ceil((hi - lo).max() / cell)) + 1
    occ = []
    for s in scans:
        sub = s[:: max(1, len(s) // max_points)]
        c = np.clip(((sub - lo) / cell).astype(np.int64), 0, R - 1)
        occ.append(np.unique((c[:, 0] * R + c[:, 1]) * R + c[:, 2]))
    edges = []
    for i in range(len(scans)):
        for j in range(i + 1, len(scans)):
            inter = np.intersect1d(occ[i], occ[j], assume_unique=True)
            ov = len(inter) / max(min(len(occ[i]), len(occ[j])), 1)
            if ov >= min_overlap:
                edges.append((i, j))
    return edges


def optimize_pose_graph(
    edges: Sequence[Tuple[int, int, np.ndarray]],
    n_poses: int,
    weights: Optional[Sequence[float]] = None,
    max_iterations: int = 20,
    tolerance: float = 1e-10,
    damping: float = 1e-8,
    dtype=None,
    anchor: Optional[np.ndarray] = None,
    robust: str = "none",
    device=None,
) -> PoseGraphResult:
    """Gauss-Newton over absolute poses given relative SE(3) measurements.

    Args:
      edges: (i, j, Z_ij) with T_j ≈ T_i · Z_ij.
      n_poses: number of scans k; pose 0 is fixed (gauge).
      dtype: GN arithmetic precision; None means ``torch.float64`` on
        every device (the card has f64, and the system is small).
        ``torch.float32`` with an ``anchor`` is accurate to ~1e-6 m at
        scene scale; f32 without one on UTM-frame inputs is not.
      anchor: a world point near the scans (e.g. scan 0's centroid). The
        graph is conjugated by ``W = trans(anchor)`` so every translation
        entry becomes scene-scale (UTM-frame measurements otherwise carry
        a ~|origin| lever arm); solved poses map back by ``W · T' · W⁻¹``
        in f64 on the host.
      robust: "none", "huber" or "tukey" IRLS weights on the edges, from
        the fourth iteration on.
      device: None means the card (raises without CUDA); "cpu" for tests.
    """
    if robust not in ("none", "huber", "tukey"):
        # A typo like "hubert" must not silently disable rejection.
        raise ValueError(f"unknown robust mode {robust!r}")
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float64
    k = n_poses
    E = len(edges)
    if E == 0:
        # Nothing to estimate (e.g. every pairwise ICP edge failed):
        # identity poses, explicitly unconverged.
        return PoseGraphResult(
            poses=np.broadcast_to(np.eye(4), (k, 4, 4)).copy(),
            iterations=0,
            residual_rmse=float("inf"),
            converged=False,
            disconnected=list(range(1, k)),
        )
    if weights is None:
        weights = [1.0] * E
    ii = np.array([e[0] for e in edges])
    jj = np.array([e[1] for e in edges])
    W = np.eye(4)
    if anchor is not None:
        W[:3, 3] = np.asarray(anchor, np.float64)
    W_inv = np.eye(4)
    W_inv[:3, 3] = -W[:3, 3]
    # Conjugated measurement: Z' = W⁻¹ Z W, so Z'⁻¹ = W⁻¹ Z⁻¹ W; its
    # translation is the anchor's displacement under Z⁻¹ (scene-scale
    # when the scans overlap near the anchor).
    Z_inv = np.stack(
        [W_inv @ np.linalg.inv(np.asarray(e[2], np.float64)) @ W
         for e in edges]
    )

    poses = torch.eye(4, dtype=dtype, device=dev).expand(k, 4, 4)
    res_rmse, it_done, converged, poses = _gn_loop(
        max_iterations, poses,
        torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev),
        torch.as_tensor(Z_inv, dtype=dtype, device=dev),
        torch.as_tensor(np.asarray(weights, np.float64), dtype=dtype,
                        device=dev),
        k, damping, tolerance, robust,
    )

    # Back to the world frame: T = W · T' · W⁻¹ (f64, host).
    poses_np = W @ poses.cpu().numpy().astype(np.float64) @ W_inv
    if not np.isfinite(poses_np).all():
        # GN blew up (wildly inconsistent edges / singular system despite
        # damping): an explicit failure, never NaN poses.
        res_rmse, converged = float("inf"), False
        poses_np = np.broadcast_to(np.eye(4), (k, 4, 4)).copy()
    return PoseGraphResult(
        poses=poses_np,
        iterations=it_done,
        residual_rmse=res_rmse,
        converged=converged,
        disconnected=_disconnected_from(k, edges),
    )


def _gn_loop(max_iterations, poses, ii, jj, Zi, wj, k, damping, tolerance,
             robust="none"):
    dtype = Zi.dtype
    it_done = 0
    converged = False
    res_rmse = float("inf")
    wj_eff = wj
    # Edge-to-pose incidence (E, k): the block sums below are products
    # with it, the same on every run.
    P_i = torch.nn.functional.one_hot(ii, k).to(dtype)
    P_j = torch.nn.functional.one_hot(jj, k).to(dtype)
    for it in range(max_iterations):
        r, J_i, J_j = _edge_system(poses[ii], poses[jj], Zi, wj_eff)
        res_rmse = float(torch.sqrt(torch.mean(r**2)))  # host read
        if robust in ("huber", "tukey") and it >= 3:
            # IRLS: downweight edges whose residual norm is an outlier
            # relative to the median, after 3 plain GN steps (at the
            # identity start every residual is large). The scale is the
            # raw median: on few-edge graphs the Gaussian consistency
            # constant inflates it past the outlier gap. "huber" bounds
            # an outlier's influence; "tukey" (c = 3·median) is a
            # redescender, whose outlier weight reaches zero.
            rn = torch.linalg.vector_norm(r, dim=1) / torch.sqrt(
                torch.clamp(wj_eff, min=1e-30))
            # The median of an even count averages the two middle values,
            # as the JAX package's does (``torch.median`` takes the lower).
            scale = torch.quantile(rn, 0.5) + 1e-12
            if robust == "huber":
                w_rob = torch.clamp(scale / torch.clamp(rn, min=1e-30),
                                    max=1.0)
            else:
                u = torch.clip(rn / (3.0 * scale), 0.0, 1.0)
                w_rob = (1.0 - u * u) ** 2
            wj_eff = wj * torch.clamp(w_rob, min=1e-12)

        H, b = normal_equations(r, J_i, J_j, P_i, P_j)
        poses, delta = gn_step(poses, H, b, damping)
        it_done = it + 1
        if float(delta.abs().max()) < tolerance:  # host read
            converged = True
            break
    return res_rmse, it_done, converged, poses


def normal_equations(r, J_i, J_j, P_i, P_j):
    """The edges' 6×6 normal-equation blocks summed into H (6k × 6k) and
    b (6k) through the (E, k) incidence matrices ``P_i``, ``P_j``: a
    dense product, the same bits on every run."""
    k = P_i.shape[1]
    Hii = torch.einsum("eri,erj->eij", J_i, J_i)
    Hij = torch.einsum("eri,erj->eij", J_i, J_j)
    Hjj = torch.einsum("eri,erj->eij", J_j, J_j)
    gi = torch.einsum("eri,er->ei", J_i, r)
    gj = torch.einsum("eri,er->ei", J_j, r)
    H = (torch.einsum("ea,eb,eij->aibj", P_i, P_i, Hii)
         + torch.einsum("ea,eb,eij->aibj", P_i, P_j, Hij)
         + torch.einsum("ea,eb,eji->aibj", P_j, P_i, Hij)
         + torch.einsum("ea,eb,eij->aibj", P_j, P_j, Hjj)
         ).reshape(6 * k, 6 * k)
    b = (P_i.T @ gi + P_j.T @ gj).reshape(6 * k)
    return H, b


def gn_step(poses, H, b, damping):
    """One gauge-fixed, damped GN update of the (k, 4, 4) ``poses``: pose
    0's variables are dropped, the rest solved and applied on the right.
    Returns (poses, delta)."""
    dtype, dev = H.dtype, H.device
    k = poses.shape[0]
    # Gauge: drop pose 0's variables; LM-style damping for rank safety.
    n_var = 6 * k
    Hf = H[6:, 6:] + damping * torch.eye(n_var - 6, dtype=dtype, device=dev)
    delta, _ = torch.linalg.solve_ex(Hf, -b[6:])
    step = torch.cat([torch.zeros(6, dtype=dtype, device=dev),
                      delta]).reshape(k, 6)
    return poses @ torch.func.vmap(se3_exp)(step), delta


def _overlap_crop(scan: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                  margin: float) -> np.ndarray:
    """The points of ``scan`` inside the box [lo, hi] dilated by
    ``margin``·(its largest extent); the whole scan when fewer than 512
    fall inside (too little overlap to measure an edge on)."""
    m = margin * float((hi - lo).max())
    sel = np.all((scan >= lo - m) & (scan <= hi + m), axis=1)
    sub = scan[sel]
    return sub if len(sub) >= 512 else scan


def register_scans(
    scans: Sequence[np.ndarray],
    edges: "Sequence[Tuple[int, int]] | str | None" = None,
    pose_graph_iterations: int = 20,
    multiscale: bool = False,
    mesh=None,
    partition: bool = False,
    graph_robust: str = "none",
    reuse_device: "bool | str" = "auto",
    min_overlap: float = 0.25,
    crop_to_overlap: bool = True,
    crop_margin: float = 0.05,
    stats: Optional[dict] = None,
    device=None,
    **icp_kwargs,
) -> PoseGraphResult:
    """Joint multi-scan registration.

    Runs pairwise ICP on each edge to measure relative transforms,
    weights each edge by its inlier count, then optimizes the pose graph.
    Returned poses map scan s into scan 0's frame:
    ``world_points = scan_s @ R.T + t`` with (R, t) from ``poses[s]``.

    Args:
      edges: explicit (i, j) pairs, ``None`` (sequential chain), or
        ``"auto"``: occupancy-overlap detection (``detect_overlap_edges``),
        the chain when nothing overlaps enough.
      multiscale: run each edge through the coarse-to-fine pipeline
        (``models/multiscale.py``).
      mesh: a ``parallel.make_mesh`` mesh (one process: a mesh over
        several processes raises ValueError); edges then run data-parallel
        over it (``parallel.icp_register_sharded``; multiscale edges
        shard their fine level) and the pose graph is solved with its
        edges split over the ranks (``parallel.optimize_pose_graph_sharded``).
      partition: with ``mesh``, each edge runs with its TARGET split into
        x-slabs over the mesh (``parallel.icp_register_partitioned``); the
        pose-invariant per-target prep (``parallel.prepare_partition``)
        is cached across the edges sharing a target, and ``stats`` gains
        ``partitions_built``.
      graph_robust: "huber"/"tukey" IRLS-downweight gross-outlier edges in
        the pose-graph solve.
      reuse_device: upload each scan to the device once and reuse it (and
        its slab-sweep grids) across every edge it is the target of. With
        "auto" it is on for the single-device (no ``mesh``) f32 path whose
        backend is
        "auto" or "pallas", without multiscale, when the device is the
        card, the backend is "pallas", or some edge's all-pairs work
        exceeds 2³¹ (the point at which "auto" picks the sweep).
      crop_to_overlap: register each edge on the SOURCE points inside the
        target's bbox dilated by ``crop_margin``·extent (the measured
        rigid edge is unchanged; the NN certificates and 3σ statistics
        see only points that can match).
      stats: optional dict; gains {"scan_uploads", "grids_built",
        "cropped_source_uploads"} on the reuse path.
      device: None means the card (raises without CUDA); "cpu" runs the
        plain versions. The pose graph is solved there too.

    Edge runs default to ``return_registered=False`` (the merged cloud is
    recomputed from the solved poses).
    """
    if partition and multiscale:
        raise ValueError(
            "partition=True cannot combine with multiscale=True (edges run "
            "the partitioned path, which has no ladder; pass a coarse "
            "initial alignment through the edge kwargs instead)")
    if partition and mesh is None:
        raise ValueError("partition=True requires a mesh")
    if mesh is not None and mesh.process_count > 1:
        raise ValueError(
            "register_scans runs on a mesh of one process (its device "
            "reuse and crops are one process's state); on a multi-process "
            "mesh register the edges with icp_register_sharded or "
            "icp_register_partitioned and solve with "
            "optimize_pose_graph_sharded")
    dev = resolve_device(device)
    scans = [np.asarray(s, np.float64) for s in scans]
    if isinstance(edges, str):
        if edges != "auto":
            raise ValueError(f"unknown edges mode {edges!r}")
        edges = detect_overlap_edges(scans, min_overlap=min_overlap)
        if not edges:  # nothing overlaps enough: fall back to the chain
            edges = [(s, s + 1) for s in range(len(scans) - 1)]
    elif edges is None:
        edges = [(s, s + 1) for s in range(len(scans) - 1)]

    backend = icp_kwargs.get("nn_backend", "auto")
    use_reuse = (
        reuse_device is True
        or (
            reuse_device == "auto"
            and mesh is None
            and not multiscale
            and icp_kwargs.get("dtype", torch.float32) == torch.float32
            and backend in ("auto", "pallas")
            and (dev.type == "cuda" or backend == "pallas"
                 or any(len(scans[i]) * len(scans[j]) > 2**31
                        for (i, j) in edges))
        )
    )

    device_scans: dict = {}
    prepared: dict = {}
    offset = local = None
    if use_reuse:
        from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
            make_pallas_nn_device,
        )

        # One shared centering frame for every scan (the union-bbox center
        # keeps all coordinates scene-scale in f32).
        lo = np.min([s.min(axis=0) for s in scans], axis=0)
        hi = np.max([s.max(axis=0) for s in scans], axis=0)
        offset = (lo + hi) / 2.0
        local = [(s - offset).astype(np.float32) for s in scans]
        with_normals = icp_kwargs.get("estimator", "point") == "plane"

        def target_dev(i):
            # Full scans ride the device once, in their TARGET role (with
            # cropping, sources upload per-edge subsets).
            if i not in device_scans:
                device_scans[i] = torch.as_tensor(local[i], device=dev)
                if stats is not None:
                    stats["scan_uploads"] = stats.get("scan_uploads", 0) + 1
            return device_scans[i]

        def prepared_for(i):
            if i not in prepared:
                with stage("grid_build") as done:
                    prepared[i] = make_pallas_nn_device(
                        local[i], target_dev=target_dev(i),
                        with_normals=with_normals)
                    done(prepared[i][1])
                if stats is not None:
                    stats["grids_built"] = stats.get("grids_built", 0) + 1
            return prepared[i]

    # The pose graph needs only transforms and inlier counts per edge.
    icp_kwargs.setdefault("return_registered", False)

    bboxes = [(s.min(axis=0), s.max(axis=0)) for s in scans]

    def edge_source(i, j):
        """Source-j points for edge (i, j), cropped to target i's dilated
        bbox when ``crop_to_overlap``."""
        if not crop_to_overlap:
            return scans[j]
        return _overlap_crop(scans[j], *bboxes[i], crop_margin)

    def _stage(i, j):
        """Crop edge (i, j) on the host and upload its source crop (and
        its target, once); no grid build, which waits for the edge's own
        turn."""
        src_j = edge_source(i, j)
        if not use_reuse:
            return src_j, None
        nbytes = src_j.shape[0] * 12 + (
            0 if i in device_scans else local[i].nbytes)
        with stage("edge_stage", bytes=nbytes) as done:
            src_dev = torch.as_tensor((src_j - offset).astype(np.float32),
                                      device=dev)
            if stats is not None:
                stats["cropped_source_uploads"] = (
                    stats.get("cropped_source_uploads", 0) + 1)
            tgt = target_dev(i)
            done((src_dev, tgt))
        return src_j, src_dev

    measured = []
    weights = []
    edge_results = []
    prepared_partitions: dict = {}
    staged = _stage(*edges[0]) if edges else None
    for idx, (i, j) in enumerate(edges):
        # ICP maps scan j (source) onto scan i (target): P_i = T · P_j.
        src_j, src_dev = staged
        if use_reuse:
            kw = {k: v for k, v in icp_kwargs.items() if k != "nn_backend"}
            # This edge's grid build runs now (its target was uploaded
            # when it was staged); then the next edge's uploads are
            # staged before this edge's loop.
            prep = prepared_for(i)
            if idx + 1 < len(edges):
                staged = _stage(*edges[idx + 1])
            with scope(f"edge{idx}"):
                res = icp_register(
                    src_j, scans[i],
                    device_data=(src_dev, target_dev(i), offset),
                    prepared_nn=prep, device=dev, **kw)
        elif multiscale:
            from iterativeclosestpoint_tpu_torch.models.multiscale import (
                icp_register_multiscale,
            )

            with scope(f"edge{idx}"):
                res = icp_register_multiscale(
                    src_j, scans[i], mesh=mesh, device=dev,
                    **icp_kwargs).final
        elif partition:
            from iterativeclosestpoint_tpu_torch.parallel.partition import (
                icp_register_partitioned,
                partitioned_kwargs,
                prepare_partition,
            )

            kw = partitioned_kwargs(icp_kwargs)
            # Partition options resolve at prep time (a prepared partition
            # makes the registration ignore them).
            pkw = {k: kw.pop(k) for k in ("halo", "local_search",
                                          "partition_build", "fine_kernel")
                   if k in kw}
            if i not in prepared_partitions:
                with stage("partition_prep"):
                    prepared_partitions[i] = prepare_partition(
                        scans[i], mesh=mesh,
                        estimator=icp_kwargs.get("estimator", "point"),
                        dtype=icp_kwargs.get("dtype", torch.float32),
                        grid_resolution=icp_kwargs.get("grid_resolution"),
                        n_queries_hint=len(src_j), **pkw)
                if stats is not None:
                    stats["partitions_built"] = (
                        stats.get("partitions_built", 0) + 1)
            with scope(f"edge{idx}"):
                res = icp_register_partitioned(
                    src_j, scans[i], mesh=mesh,
                    prepared_partition=prepared_partitions[i], **kw)
        elif mesh is not None:
            from iterativeclosestpoint_tpu_torch.parallel.sharded import (
                icp_register_sharded,
            )

            with scope(f"edge{idx}"):
                res = icp_register_sharded(src_j, scans[i], mesh=mesh,
                                           **icp_kwargs)
        else:
            with scope(f"edge{idx}"):
                res = icp_register(src_j, scans[i], device=dev,
                                   **icp_kwargs)
        if not use_reuse and idx + 1 < len(edges):
            staged = _stage(*edges[idx + 1])
        edge_results.append(res)
        if not res.success:
            continue
        # T_i · Z = T_j with Z mapping j-frame to i-frame: Z = ICP result.
        measured.append((i, j, res.transform))
        weights.append(float(res.history_valid[-1]) if res.iterations
                       else 1.0)

    anchor = np.asarray(scans[0], np.float64).mean(axis=0)
    with stage("pose_graph"):
        if mesh is not None:
            from iterativeclosestpoint_tpu_torch.parallel.posegraph import (
                optimize_pose_graph_sharded,
            )

            out = optimize_pose_graph_sharded(
                measured, n_poses=len(scans), weights=weights, mesh=mesh,
                max_iterations=pose_graph_iterations, anchor=anchor,
                robust=graph_robust)
        else:
            out = optimize_pose_graph(
                measured, n_poses=len(scans), weights=weights,
                max_iterations=pose_graph_iterations, anchor=anchor,
                robust=graph_robust, device=dev,
            )
    out.edge_results = edge_results
    out.disconnected = _disconnected_from(len(scans), measured)
    return out


def _disconnected_from(k: int, measured) -> List[int]:
    """Scans with no successful-edge path to scan 0 (union-find)."""
    parent = list(range(k))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j, _ in measured:
        parent[find(i)] = find(j)
    root0 = find(0)
    return [s for s in range(1, k) if find(s) != root0]
