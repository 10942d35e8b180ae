"""Data-parallel ICP: the source split over a mesh's ranks.

Counterpart of the JAX package's ``parallel/sharded.py``
(``_icp_core_sharded`` :62, ``icp_register_sharded`` :133). The target and
its NN state are replicated on every rank's device (one copy per distinct
device: ranks that share a card share it read-only); the source, laid out
as the single-device path lays it out, is padded to a rank multiple with
zero-weight rows and split into equal contiguous shards, so each rank's
partial sums are those of the JAX package's devices. Every statistic of
the loop (distance moments, inlier counts, RMSE numerators, centroids and
the 3×3 cross-covariance, or the 6×6 plane system) is reduced by the
rank's ``psum`` (``models.icp.icp_core``'s ``ps``), so every rank steps
through the same convergence decisions, transforms and history; only the
NN search and the element-wise work are split. Per iteration a rank
contributes 84 bytes to collectives in f32 point mode and 188 in plane
mode (the JAX package's HLO count).

The loop is ``models.icp.icp_core`` itself and segmented runs go through
``models.icp._run_segmented``, so live progress, the cooperative stop,
segment-boundary carries and bit-identical resume work as on one device.
A 1-rank mesh computes exactly what ``icp_register`` computes.

Without the multiscale fine level's device inputs the clouds and the NN
state come from ``models.prep.prepare_level`` on the mesh's first local
device. On a mesh over several processes
(``parallel.mesh.init_multihost``) each process holds the full
``source`` and ``target`` (the JAX package's host path, :316-320), makes
that prep itself and places only its ranks' shards; ``return_registered``
gathers the registered rows to every process. ``source_global`` (from
``parallel.ingest.load_las_sharded``) is the sharded ingest, where no
process holds the source: the NN state comes from the target alone and
rows stay in file order (:226-241).

The JAX package's ≥2M-points-per-chip auto-segmentation (:350-356)
applies where a callback can see it, as on one device
(``models.icp.auto_segment_iterations``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.models.icp import (
    ICPResult,
    _compose_callback,
    _pose_magnitudes,
    _rebase_transform,
    _resume_state,
    _run_segmented,
    apply_permutation,
    auto_segment_iterations,
    icp_core,
    package_result,
)
from iterativeclosestpoint_tpu_torch.models.prep import (
    check_prepared,
    nn_backend_for,
    prepare_level,
)
from iterativeclosestpoint_tpu_torch.ops.se3 import apply_transform
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.parallel.mesh import (
    Mesh,
    _replicas,
    make_mesh,
    process_allgather,
    to_global,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import stage
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device


def replicate(tree, device: torch.device):
    """``tree`` (tensors in tuples, lists and NamedTuples) with every
    tensor on ``device``; tensors already there are shared, not copied."""
    if isinstance(tree, torch.Tensor):
        return tree if tree.device == device else tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(x, device) for x in tree)
    return tree


def per_device(mesh: Mesh, tree) -> list:
    """``tree`` replicated once per distinct device of this process's
    ranks, indexed by global rank (ranks on one device share one copy;
    None for other processes' ranks)."""
    return _replicas(mesh, lambda d: replicate(tree, d))


def mesh_carry(carry, device):
    """A loop carry (T_cum, prev_error, no_improve) on ``device``."""
    return None if carry is None else tuple(replicate(list(carry), device))


def merge_outputs(mesh: Mesh, outs: list, return_registered: bool) -> dict:
    """One loop output from every rank's: the scalars and history of this
    process's first rank (every rank holds the same bits) and the
    registered shards joined in rank order on the host, across
    processes."""
    out = {k: v for k, v in outs[mesh.local_ranks[0]].items() if k != "src"}
    if return_registered:
        out["src"] = process_allgather(mesh, torch.cat(
            [outs[r]["src"].cpu() for r in mesh.local_ranks]))
    return out


def compose_initial(res: ICPResult, T_init: np.ndarray) -> ICPResult:
    """Fold a host-side pre-alignment into a result: transforms composed
    with ``T_init``, pose magnitudes recomputed, local carry dropped."""
    res.transform = res.transform @ T_init
    res.history_transform = res.history_transform @ T_init
    res.history_rotation_deg, res.history_translation = _pose_magnitudes(
        res.history_transform)
    res.carry_transform_local = None
    res.center_offset = None
    return res


def run_loop(mesh: Mesh, shards: list, weights: list, targets: list,
             states: list, *, nn_fns, carry, max_iterations: int,
             widen_first: bool, return_registered: bool,
             registered_from: Optional[list] = None, **loop_kw) -> dict:
    """``icp_core`` on every rank's shard with the rank's ``psum`` as its
    reducer; ``nn_fns`` is one nn_fn for every rank or a per-rank
    ``nn_fns(comm)`` factory (the partitioned target's collective
    repair). ``registered_from``: per-rank rows to register instead of
    the shards (a shard laid out for its NN keeps the caller's order)."""

    def rank_fn(comm):
        r = comm.rank
        nn_fn = nn_fns(comm) if getattr(nn_fns, "per_rank", False) else nn_fns
        out = icp_core(
            shards[r], weights[r], targets[r], states[r], nn_fn=nn_fn,
            max_iterations=max_iterations, widen_first=widen_first,
            carry=mesh_carry(carry, comm.device), ps=comm.psum,
            return_registered=return_registered and registered_from is None,
            **loop_kw)
        if return_registered and registered_from is not None:
            out["src"] = apply_transform(out["T_cum"], registered_from[r])
        return out

    return merge_outputs(mesh, mesh.run(rank_fn), return_registered)


def icp_register_sharded(
    source,
    target,
    *,
    mesh: Optional[Mesh] = None,
    max_iterations: int = 50,
    tolerance: float = 1e-6,
    sigma_multiplier: float = 3.0,
    mode: str = "gui",
    nn_backend: str = "auto",
    grid_resolution: Optional[int] = None,
    cell_capacity: Optional[int] = None,
    estimator: str = "point",
    robust: str = "none",
    initial_transform=None,
    dtype=torch.float32,
    center: bool = True,
    return_registered: bool = True,
    segment_iterations: int = 0,
    progress_callback: Optional[Callable] = None,
    stop_event=None,
    resume_carry=None,
    segment_callback: Optional[Callable] = None,
    device_data=None,
    prepared_nn=None,
    source_global=None,
    device=None,
) -> ICPResult:
    """Data-parallel registration over ``mesh`` (``icp_register``'s
    surface: estimators, robust weights, segments, callbacks, stop and
    resume).

    ``mesh`` default: ``make_mesh(device=device)``, one rank per visible
    card (``device="cpu"``: one CPU rank). ``device_data`` =
    (src_dev, tgt_dev, offset) and ``prepared_nn`` = (nn_fn, nn_state,
    resolution) from ``ops.sweep_nn.make_pallas_nn_device`` are the
    multiscale fine level's device inputs: the query layout is built on
    their device and each rank's shard and the grids are replicated from
    there. ``initial_transform`` pre-aligns the source (on the host, or
    on its device with ``device_data``) and is composed into the result;
    the device inputs (``device_data``/``prepared_nn``) are for a
    single-process mesh.

    ``source_global`` = (shards, weights, n_rows) from
    ``parallel.ingest.load_las_sharded``: per global rank, the rank's
    source rows and 0/1 weights on its device (None for other processes'
    ranks), and the real row count. ``source`` is ignored (pass None);
    the NN state is built from ``target`` alone and the query layout is
    skipped (row order is file order; exactness is unaffected).
    """
    if mesh is None:
        mesh = make_mesh(device=device)
    if estimator not in ("point", "plane"):
        raise ValueError(f"unknown estimator {estimator!r}")
    if robust not in ("none", "huber", "tukey"):
        raise ValueError(f"unknown robust mode {robust!r}")
    for d in mesh.local_devices:
        resolve_device(d)
    n_dev = mesh.size
    dev0 = mesh.local_devices[0]

    if source_global is not None:
        if prepared_nn is not None or device_data is not None:
            raise ValueError(
                "source_global cannot combine with prepared_nn/device_data")
        if initial_transform is not None:
            raise ValueError(
                "source_global with initial_transform is not supported "
                "(fold the pose into a resume_carry instead)")
        n_orig = int(source_global[2])
    else:
        source = np.asarray(source, np.float64)
        n_orig = len(source)
    if prepared_nn is not None and mesh.process_count > 1:
        raise ValueError(
            "prepared_nn is single-process only (the grids are one "
            "process's device state); a multi-process mesh runs the host "
            "build path")
    target = np.asarray(target, np.float64)
    T_init = None
    if initial_transform is not None:
        if resume_carry is not None:
            raise ValueError(
                "initial_transform and resume_carry are mutually exclusive")
        T_init = np.asarray(initial_transform, np.float64)
        if device_data is None:
            source = source @ T_init[:3, :3].T + T_init[:3, 3]

    # The single-device prep on the first device; a sharded ingest builds
    # the NN from the target alone.
    (src_loc, tgt_loc, offset), level_nn, _, rows_d = prepare_level(
        source if source_global is None else None, target, dev0,
        dtype=dtype, center=center,
        nn_backend=(None if prepared_nn is not None
                    else nn_backend_for(nn_backend, n_orig, len(target))),
        estimator=estimator, grid_resolution=grid_resolution,
        cell_capacity=cell_capacity, device_data=device_data)
    if T_init is not None and device_data is not None:
        # A caller's device clouds take the initial pose on the device.
        src_loc = apply_transform(torch.as_tensor(
            _rebase_transform(T_init, -offset), dtype=dtype,
            device=src_loc.device), src_loc)
    nn_fn, nn_state, nn_res = prepared_nn or level_nn
    if prepared_nn is not None:
        check_prepared(nn_fn, estimator)
    rows = row_weight = None
    if source_global is not None:
        # Rows stay in file order: no process holds the source.
        shards = [None if s is None else s.to(mesh.devices[r], dtype)
                  for r, s in enumerate(source_global[0])]
        weights = [None if w is None else w.to(mesh.devices[r], dtype)
                   for r, w in enumerate(source_global[1])]
    else:
        lw = None
        if hasattr(nn_fn, "layout_group"):
            # The sweep's layout; each rank's shard inherits its spatial
            # compactness.
            grid0 = nn_state[0]
            tq = nn_fn.tile_q
            rows_d, lw = grouped_tile_order_device(
                src_loc, grid0.origin, grid0.cell_size, resolution=nn_res,
                tile_q=tq, group=nn_fn.layout_group)
            if prepared_nn is not None:
                # Every rank's shard a whole number of query tiles.
                pad = (-rows_d.shape[0]) % (tq * n_dev)
                if pad:
                    rows_d = torch.cat([rows_d, rows_d[-1:].expand(pad)])
                    lw = torch.cat([lw, lw.new_zeros(pad)])
            row_weight = lw.cpu().numpy()
        if rows_d is not None:
            rows = rows_d.cpu().numpy()
            src_loc = src_loc[rows_d]
        w = (lw.to(dtype) if lw is not None
             else src_loc.new_ones(src_loc.shape[:1]))
        # The host path's rank multiple: zero rows of weight 0.
        pad = (-src_loc.shape[0]) % n_dev
        if pad:
            src_loc = torch.cat([src_loc, src_loc.new_zeros((pad, 3))])
            w = torch.cat([w, w.new_zeros(pad)])
        shards = to_global(src_loc, mesh)
        weights = to_global(w, mesh)
    targets = per_device(mesh, tgt_loc)
    states = per_device(mesh, nn_state)

    if T_init is not None:
        progress_callback = _compose_callback(progress_callback, T_init)
        segment_callback = _compose_callback(segment_callback, T_init)
    carry = None
    widen = mode == "gui"
    if resume_carry is not None:
        carry = _resume_state(resume_carry, offset, dtype, dev0)
        widen = False  # the run's first iteration is long past

    def dispatch(carry_, n_iter, widen_):
        return run_loop(
            mesh, shards, weights, targets, states, nn_fns=nn_fn,
            carry=carry_, max_iterations=n_iter, widen_first=widen_,
            return_registered=return_registered, tolerance=tolerance,
            sigma_multiplier=sigma_multiplier, estimator=estimator,
            robust=robust)

    segment_iterations = auto_segment_iterations(
        segment_iterations, n_orig // n_dev,
        (progress_callback, stop_event, segment_callback))
    with stage("loop") as done:
        if segment_iterations and segment_iterations > 0:
            out = _run_segmented(
                dispatch, offset, max_iterations=max_iterations,
                segment_iterations=segment_iterations, widen_first=widen,
                progress_callback=progress_callback, stop_event=stop_event,
                carry_init=carry, segment_callback=segment_callback)
        else:
            out = dispatch(carry, max_iterations, widen)
        done(out["T_cum"])
    if return_registered:
        # Trim the rank padding before packaging.
        out["src"] = out["src"][: (len(rows) if rows is not None
                                   else n_orig)]
    res = package_result(out, offset, return_registered)
    res.nn_resolution = nn_res
    if rows is not None and res.source_registered is not None:
        res = apply_permutation(res, rows, row_weight, n_orig)
    if T_init is not None:
        res = compose_initial(res, T_init)
    return res

