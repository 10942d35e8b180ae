"""Pairwise ICP: the iteration loop and its host wrapper.

Counterpart of the JAX package's ``models/icp.py`` for the single-device,
point-to-point path. One iteration (the reference engine's,
``icpengine.cpp:117-394``):

  1-NN correspondence → population mean/σ of the distances over all
  pairs → 3σ threshold (gui mode widens iteration 1: mean + max(3σ,
  0.5·mean)) → inlier mask → RMSE over inliers only → convergence
  (|ΔRMSE| < tol three consecutive times) and divergence (RMSE >
  1.1·prev) checks, both before the pose update → masked Kabsch.

The JAX package runs the loop as one ``lax.while_loop``; here it is a
Python loop over the same carry (T_cum, prev_error, no_improve) that reads
its stop code to the host once per iteration. As in the JAX package the
current source is recomputed each iteration from the pristine source and
T_cum, and Kabsch fits T_cum directly from the pristine source.
Coordinates are centered on the host by an f64 offset; device math is
f32, and the result is re-based to the world frame on the way out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.ops.bruteforce import nn_bruteforce
from iterativeclosestpoint_tpu_torch.ops.kabsch import kabsch_masked
from iterativeclosestpoint_tpu_torch.ops.se3 import apply_transform
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import nn_brute
from iterativeclosestpoint_tpu_torch.ops.sweep_nn import make_pallas_nn_device
from iterativeclosestpoint_tpu_torch.runtime.timing import stage
from iterativeclosestpoint_tpu_torch.utils import hostmath
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device

# Stop reasons (host-readable), the JAX package's codes.
RUNNING = 0
CONVERGED = 1
DIVERGED = 2
TOO_FEW_VALID = 3
MAX_ITERATIONS = 4
STOPPED = 5
NUMERICAL_ERROR = 6

_STOP_MESSAGES = {
    CONVERGED: "converged",
    DIVERGED: "diverged",
    TOO_FEW_VALID: "insufficient valid pairs",
    MAX_ITERATIONS: "max iterations reached",
    STOPPED: "stopped by user",
    NUMERICAL_ERROR: "numerical error (non-finite statistics or pose)",
}


@dataclasses.dataclass
class ICPResult:
    """Host-side result mirroring the reference's ICPResult + history."""

    success: bool
    message: str
    transform: np.ndarray  # (4,4) world-frame cumulative transform
    rmse: float
    iterations: int
    stop_reason: int
    # Per-iteration history, length == iterations.
    history_rmse: np.ndarray
    history_valid: np.ndarray
    history_outliers: np.ndarray
    history_transform: np.ndarray  # (iterations, 4, 4) world frame
    history_rotation_deg: np.ndarray
    history_translation: np.ndarray
    history_mean_dist: np.ndarray
    history_std_dist: np.ndarray
    history_threshold: np.ndarray
    source_registered: Optional[np.ndarray] = None  # (N,3) world frame
    carry_prev_error: float = 1e10
    carry_no_improve: int = 0
    carry_transform_local: Optional[np.ndarray] = None
    center_offset: Optional[np.ndarray] = None
    nn_resolution: Optional[int] = None


def iteration_statistics(dist, weight, sigma_multiplier, widen_first: bool,
                         is_first: bool):
    """Distance statistics + 3σ inlier mask for one iteration.

    Population mean/σ over all pairs, threshold = mean + 3σ (first gui
    iteration: mean + max(3σ, 0.5·mean)), RMSE over inliers only.
    ``weight`` is 0 on layout padding rows.
    """
    f = dist.dtype
    n = weight.sum()
    mean = (dist * weight).sum() / n
    dev = dist - mean
    std = torch.sqrt((weight * (dev * dev)).sum() / n)
    if widen_first and is_first:
        threshold = mean + torch.maximum(sigma_multiplier * std, mean * 0.5)
    else:
        threshold = mean + sigma_multiplier * std
    valid = (dist <= threshold) & (weight > 0)
    valid_count = valid.sum()
    sum_sq = torch.where(valid, dist * dist, torch.zeros_like(dist)).sum()
    rmse = torch.where(
        valid_count > 0,
        torch.sqrt(sum_sq / torch.clamp(valid_count, min=1).to(f)),
        torch.zeros((), dtype=f, device=dist.device),
    )
    return mean, std, threshold, valid, valid_count, rmse, n


def icp_core(source, weight, target, nn_state, *, nn_fn: Callable,
             max_iterations: int, tolerance: float, sigma_multiplier: float,
             widen_first: bool, carry: Optional[tuple] = None,
             return_registered: bool = True) -> dict:
    """The ICP loop in the centered local frame.

    ``carry`` = (T_cum, prev_error, no_improve) starts the convergence
    state machine from that state instead of identity / 1e10 / 0. Returns
    the final carry, the stop code, the recorded count and the history
    (device tensors), and the registered source when asked.
    """
    f = source.dtype
    dev = source.device
    H = max_iterations
    if carry is None:
        T_cum = torch.eye(4, dtype=f, device=dev)
        prev = torch.tensor(1e10, dtype=f, device=dev)
        noimp = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        T_cum, prev, noimp = (carry[0].to(f), carry[1].to(f),
                              carry[2].to(torch.int32))
    hist = {
        "h_rmse": torch.zeros((H,), dtype=f, device=dev),
        "h_valid": torch.zeros((H,), dtype=torch.int32, device=dev),
        "h_out": torch.zeros((H,), dtype=torch.int32, device=dev),
        "h_T": torch.zeros((H, 4, 4), dtype=f, device=dev),
        "h_mean": torch.zeros((H,), dtype=f, device=dev),
        "h_std": torch.zeros((H,), dtype=f, device=dev),
        "h_thr": torch.zeros((H,), dtype=f, device=dev),
    }
    tol = torch.tensor(tolerance, dtype=f, device=dev)
    sig = torch.tensor(sigma_multiplier, dtype=f, device=dev)
    recorded = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    stop = RUNNING
    while it < H and stop == RUNNING:
        src = apply_transform(T_cum, source)
        dst, dist = nn_fn(src, target, nn_state)
        mean, std, thr, valid, valid_count, rmse, n_real = (
            iteration_statistics(dist, weight, sig, widen_first, it == 0))
        numerr = ~torch.isfinite(rmse + mean + std)
        small = torch.abs(prev - rmse) < tol
        no_improve = torch.where(small, noimp + 1, torch.zeros_like(noimp))
        converged = small & (no_improve >= 3) & ~numerr
        diverged = ~converged & (rmse > prev * 1.1)
        too_few = ~converged & ~diverged & (valid_count < 3)
        will_update = ~(converged | diverged | too_few | numerr)
        # Kabsch from the PRISTINE source to the matched targets fits T_cum
        # directly (no chain of rounded 4×4 products).
        T_cand = kabsch_masked(source, dst, valid)
        numerr = numerr | ~torch.isfinite(T_cand).all()
        will_update = will_update & ~numerr
        T_new = torch.where(will_update, T_cand, T_cum)
        # Converged records the PREVIOUS transform; diverged/too_few
        # record nothing.
        record = will_update | converged
        rec_T = torch.where(converged, T_cum, T_new)
        row = {
            "h_rmse": rmse, "h_valid": valid_count.to(torch.int32),
            "h_out": (n_real.to(torch.int32) - valid_count).to(torch.int32),
            "h_T": rec_T, "h_mean": mean, "h_std": std, "h_thr": thr,
        }
        for k, v in row.items():
            hist[k][it] = torch.where(record, v, hist[k][it])
        stop_t = torch.where(numerr, NUMERICAL_ERROR, torch.where(
            converged, CONVERGED, torch.where(
                diverged, DIVERGED, torch.where(
                    too_few, TOO_FEW_VALID, RUNNING))))
        prev = torch.where(will_update, rmse, prev)
        noimp = no_improve
        T_cum = T_new
        recorded = recorded + record.to(torch.int32)
        it += 1
        stop = int(stop_t)  # the loop's one host read per iteration
    if stop == RUNNING:
        stop = MAX_ITERATIONS
    out = {"T_cum": T_cum, "prev_error": prev, "no_improve": noimp,
           "stop": stop, "recorded": recorded, **hist}
    if return_registered:
        out["src"] = apply_transform(T_cum, source)
    return out


def _brute_adapter(query, target, nn_state):
    """Brute-force nn_fn: f32 goes through K3 (its plain version for CPU
    tensors), f64 through the plain ``nn_bruteforce`` (the oracle-parity
    path)."""
    del nn_state
    brute = nn_brute if query.dtype == torch.float32 else nn_bruteforce
    idx, dist = brute(query, target)
    return target[idx], dist


def _default_nn(nn_backend: str, source_local: np.ndarray,
                target_local: np.ndarray, grid_resolution, *,
                source_dev, target_dev):
    """Pick the NN kernel; returns (nn_fn, nn_state, rows | None,
    weight | None, resolution | None).

    'auto': brute force while the all-pairs work is small (n·m ≤ 2³¹), the
    slab sweep beyond. The pallas backend lays the source out in
    x-group-aligned tiles (``rows``, with weight 0 on padding rows).
    """
    m = len(target_local)
    n = len(source_local)
    if nn_backend == "auto":
        nn_backend = "bruteforce" if n * m <= 2**31 else "pallas"
    if nn_backend in ("cellblock", "hashgrid"):
        raise NotImplementedError(
            f"nn_backend={nn_backend!r} is not ported yet (ROADMAP P16)")
    if nn_backend == "bruteforce":
        return _brute_adapter, (), None, None, None
    if nn_backend == "pallas":
        nn_fn, state, resolution = make_pallas_nn_device(
            target_local, resolution=grid_resolution, target_dev=target_dev,
        )
        rows, weight = grouped_tile_order_device(
            source_dev, state[0].origin, state[0].cell_size,
            resolution=resolution, tile_q=nn_fn.tile_q,
            group=nn_fn.layout_group,
        )
        return nn_fn, state, rows, weight, resolution
    raise ValueError(f"unknown nn_backend {nn_backend!r}")


def _rebase_transform(T_local: np.ndarray, offset: np.ndarray) -> np.ndarray:
    """T_world = Shift(offset) @ T_local @ Shift(-offset)."""
    T = np.asarray(T_local, np.float64).copy()
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    T[..., :3, 3] = t + offset - (R @ offset)
    return T


def apply_permutation(res: ICPResult, rows: np.ndarray,
                      weight: "np.ndarray | None" = None,
                      n_orig: "int | None" = None) -> ICPResult:
    """Undo a query row layout on the registered cloud; every other field
    is layout-invariant. ``rows`` may hold replicated padding rows, marked
    by weight 0."""
    if res.source_registered is not None:
        reg = res.source_registered
        if weight is None:
            unperm = np.empty_like(reg)
            unperm[rows] = reg
        else:
            real = weight > 0
            unperm = np.empty((n_orig or len(rows), reg.shape[1]), reg.dtype)
            unperm[rows[real]] = reg[real]
        res.source_registered = unperm
    return res


def _prep_fine_source(src_raw, T_loc, origin, cell_size, *, resolution,
                      tile_q=128, group="x"):
    """Fine-level source prep: apply the local-frame initial transform,
    build the x-group-aligned layout at that pose, gather."""
    src = apply_transform(T_loc, src_raw)
    rows, weight = grouped_tile_order_device(
        src, origin, cell_size, resolution=resolution, tile_q=tile_q,
        group=group,
    )
    return src[rows], rows, weight


def _unported(**options):
    """Raise for an option whose ROADMAP item has not landed yet."""
    items = {
        "segment_iterations": "P12", "progress_callback": "P12",
        "stop_event": "P12", "resume_carry": "P12",
        "segment_callback": "P12", "layout_transform": "P10",
        "cell_capacity": "P16",
    }
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP {items[name]})")


def icp_register(
    source,
    target,
    *,
    max_iterations: int = 50,
    tolerance: float = 1e-6,
    sigma_multiplier: float = 3.0,
    mode: str = "gui",
    nn_backend: str = "auto",
    grid_resolution: Optional[int] = None,
    cell_capacity: Optional[int] = None,
    estimator: str = "point",
    robust: str = "none",
    dtype=torch.float32,
    center: bool = True,
    return_registered: bool = True,
    initial_transform: Optional[np.ndarray] = None,
    segment_iterations: int = 0,
    progress_callback: Optional[Callable] = None,
    stop_event=None,
    device_data=None,
    prepared_nn=None,
    resume_carry=None,
    segment_callback: Optional[Callable] = None,
    layout_transform: Optional[np.ndarray] = None,
    device=None,
) -> ICPResult:
    """Register ``source`` onto ``target``; returns world-frame results.

    ``device``: None means the card (raises without CUDA); "cpu" runs the
    plain PyTorch versions of the kernels.

    ``initial_transform`` (4,4) pre-aligns the source (e.g. a coarse-level
    estimate); the returned transforms include it. ``device_data`` =
    (src_dev, tgt_dev, offset): f32 device tensors centered by ``offset``;
    the initial transform is then applied on the device.
    ``prepared_nn`` = (nn_fn, nn_state, resolution) from
    ``ops.sweep_nn.make_pallas_nn_device`` built against ``tgt_dev``.
    """
    dev = resolve_device(device)
    _unported(segment_iterations=segment_iterations,
              progress_callback=progress_callback, stop_event=stop_event,
              resume_carry=resume_carry, segment_callback=segment_callback,
              layout_transform=layout_transform, cell_capacity=cell_capacity)
    if estimator == "plane":
        raise NotImplementedError(
            "estimator='plane' is not ported yet (ROADMAP P10)")
    if estimator != "point":
        raise ValueError(f"unknown estimator {estimator!r}")
    if robust in ("huber", "tukey"):
        raise NotImplementedError(
            f"robust={robust!r} is not ported yet (ROADMAP P12)")
    if robust != "none":
        raise ValueError(f"unknown robust mode {robust!r}")

    source = np.asarray(source, np.float64)
    target = np.asarray(target, np.float64)
    T_init = None
    if initial_transform is not None:
        T_init = np.asarray(initial_transform, np.float64)
        if device_data is None:
            source = source @ T_init[:3, :3].T + T_init[:3, 3]

    if device_data is not None:
        offset = np.asarray(device_data[2], np.float64)
    else:
        offset = hostmath.center_offset(target) if center else np.zeros(3)
    n_orig = len(source)
    rows = row_weight = None
    nn_res = None
    src_np = tgt_np = None
    if device_data is not None:
        src_local = device_data[0].to(dtype)
        tgt_local = device_data[1].to(dtype)
        if T_init is not None and prepared_nn is None:
            T_loc = _rebase_transform(T_init, -offset)
            src_local = apply_transform(
                torch.as_tensor(T_loc, dtype=dtype, device=src_local.device),
                src_local)
    else:
        with stage("host_prep"):
            src_np = source - offset
            tgt_np = target - offset
        isz = torch.empty((), dtype=dtype).element_size()
        with stage("upload",
                   bytes=(len(src_np) + len(tgt_np)) * 3 * isz) as done:
            src_local = torch.as_tensor(src_np, dtype=dtype, device=dev)
            tgt_local = torch.as_tensor(tgt_np, dtype=dtype, device=dev)
            done((src_local, tgt_local))
    if prepared_nn is not None:
        nn_fn, nn_state, resolution = prepared_nn
        nn_res = resolution
        grid0 = nn_state[0]
        T_loc = (_rebase_transform(T_init, -offset)
                 if T_init is not None and device_data is not None
                 else np.eye(4))
        with stage("prep") as done:
            src_local, rows, row_weight = _prep_fine_source(
                src_local,
                torch.as_tensor(T_loc, dtype=dtype, device=src_local.device),
                grid0.origin, grid0.cell_size, resolution=resolution,
                tile_q=nn_fn.tile_q, group=nn_fn.layout_group,
            )
            done(src_local)
    else:
        if src_np is None:
            with stage("host_prep"):
                src_np = source - offset
                tgt_np = target - offset
        with stage("nn_build") as done:
            nn_fn, nn_state, rows, row_weight, nn_res = _default_nn(
                nn_backend, src_np, tgt_np, grid_resolution,
                source_dev=src_local, target_dev=tgt_local,
            )
            done(nn_state)
        if rows is not None:
            src_local = src_local[rows]
    weight = (row_weight.to(dtype) if row_weight is not None
              else torch.ones(src_local.shape[:1], dtype=dtype,
                              device=src_local.device))

    # The JAX package auto-segments runs of ≥2M points (icp.py:1160-1168)
    # so that no single device program outlives the TPU worker's watchdog.
    # This loop launches each iteration's kernels from the host, so no
    # launch is long-lived and that segmentation is left out on purpose.
    with stage("loop") as done:
        out = icp_core(
            src_local, weight, tgt_local, nn_state, nn_fn=nn_fn,
            max_iterations=max_iterations, tolerance=tolerance,
            sigma_multiplier=sigma_multiplier, widen_first=(mode == "gui"),
            return_registered=return_registered,
        )
        done(out["T_cum"])
    with stage("package"):
        res = package_result(out, offset, return_registered)
    res.nn_resolution = nn_res
    if rows is not None and res.source_registered is not None:
        res = apply_permutation(
            res, rows.cpu().numpy(),
            row_weight.cpu().numpy() if row_weight is not None else None,
            n_orig,
        )
    if T_init is not None:
        res.transform = res.transform @ T_init
        res.history_transform = res.history_transform @ T_init
        # Rotation/translation histories follow the composed transforms.
        trc = np.trace(res.history_transform[:, :3, :3], axis1=1, axis2=2)
        res.history_rotation_deg = np.degrees(
            np.arccos(np.clip((trc - 1) / 2, -1, 1)))
        res.history_translation = np.linalg.norm(
            res.history_transform[:, :3, 3], axis=1)
        # The local carry does not include T_init.
        res.carry_transform_local = None
        res.center_offset = None
    return res


def package_result(out, offset, return_registered: bool = True) -> ICPResult:
    """Convert the loop's output into a world-frame ICPResult."""
    host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items() if k != "src" or return_registered}
    k = int(host["recorded"])
    stop = int(host["stop"])
    success = stop not in (TOO_FEW_VALID, STOPPED, NUMERICAL_ERROR)

    h_T_world = _rebase_transform(host["h_T"][:k], offset)
    rot_deg = np.degrees(np.arccos(np.clip(
        (np.trace(h_T_world[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1,
    ))) if k else np.zeros((0,))
    t_norm = (np.linalg.norm(h_T_world[:, :3, 3], axis=1) if k
              else np.zeros((0,)))
    return ICPResult(
        success=success,
        message=_STOP_MESSAGES.get(stop, "unknown"),
        transform=_rebase_transform(host["T_cum"], offset),
        rmse=float(host["h_rmse"][k - 1]) if k else 0.0,
        iterations=k,
        stop_reason=stop,
        history_rmse=host["h_rmse"][:k],
        history_valid=host["h_valid"][:k],
        history_outliers=host["h_out"][:k],
        history_transform=h_T_world,
        history_rotation_deg=rot_deg,
        history_translation=t_norm,
        history_mean_dist=host["h_mean"][:k],
        history_std_dist=host["h_std"][:k],
        history_threshold=host["h_thr"][:k],
        source_registered=(
            np.asarray(host["src"], np.float64) + offset
            if return_registered else None
        ),
        carry_prev_error=float(host["prev_error"]),
        carry_no_improve=int(host["no_improve"]),
        carry_transform_local=np.asarray(host["T_cum"]),
        center_offset=np.asarray(offset, np.float64),
    )
