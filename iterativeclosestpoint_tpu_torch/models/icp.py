"""Pairwise ICP: the iteration loop and its host wrapper.

Counterpart of the JAX package's ``models/icp.py`` for one device. One
iteration (the reference engine's, ``icpengine.cpp:117-394``):

  1-NN correspondence → population mean/σ of the distances over all
  pairs → 3σ threshold (gui mode widens iteration 1: mean + max(3σ,
  0.5·mean)) → inlier mask → RMSE over inliers only → convergence
  (|ΔRMSE| < tol three consecutive times) and divergence (RMSE >
  1.1·prev) checks, both before the pose update → masked pose update.

The pose update is the reference's masked Kabsch (``estimator="point"``)
or, as an extension beyond the reference, a point-to-plane Gauss-Newton
step on the target's normals (``estimator="plane"``), optionally
reweighted by a Huber or Tukey influence of the residual distance
(``robust=``; statistics and convergence stay on the binary mask).

The JAX package runs the loop as one ``lax.while_loop``; here it is a
Python loop over the same carry (T_cum, prev_error, no_improve) that reads
its stop code to the host once per iteration. As in the JAX package the
current source is recomputed each iteration from the pristine source and
T_cum, and Kabsch fits T_cum directly from the pristine source, so the
iteration state is a function of the carry alone: a run split into
segments (``segment_iterations``, for live progress and a cooperative
stop) or resumed from a carry (``resume_carry``) follows the one-dispatch
trajectory bit for bit. Coordinates are centred by an f64 offset
(``models/prep.py`` prepares every level); device math is f32, and the
result is re-based to the world frame on the way out.

Every cross-row statistic goes through a reducer ``ps``: None (the
identity) on one device, a mesh rank's ``Comm.psum`` on the
multi-device paths (``parallel/``), where the source rows are split over
ranks. The JAX package's ``icp_core_impl`` routes the same sums through
``psum`` (``models/icp.py:328-331``); with ``ps=None`` every result here
is what it was before the seam, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.models.prep import (
    check_prepared,
    prepare_level,
)
from iterativeclosestpoint_tpu_torch.ops.kabsch import kabsch_masked
from iterativeclosestpoint_tpu_torch.ops.se3 import apply_transform, se3_exp
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import (
    registration_call,
    stage,
)
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

    def iteration_records(self):
        """History as a list of dicts (the iterationCompleted payload)."""
        return [
            {
                "iteration": i + 1,
                "rmse": float(self.history_rmse[i]),
                "valid_points": int(self.history_valid[i]),
                "outlier_points": int(self.history_outliers[i]),
                "transform": self.history_transform[i],
                "rotation_angle_deg": float(self.history_rotation_deg[i]),
                "translation_norm": float(self.history_translation[i]),
                "mean_dist": float(self.history_mean_dist[i]),
                "std_dist": float(self.history_std_dist[i]),
                "threshold": float(self.history_threshold[i]),
            }
            for i in range(self.iterations)
        ]


def _identity(x):
    return x


def iteration_statistics(dist, weight, sigma_multiplier, widen_first: bool,
                         is_first: bool, ps=None):
    """Distance statistics + 3σ inlier mask for one iteration.

    Population mean/σ over all pairs, threshold = mean + 3σ (first gui
    iteration: mean + max(3σ, 0.5·mean)), RMSE over inliers only.
    ``weight`` is 0 on layout padding rows. ``ps`` reduces each sum over
    the mesh's ranks (None: one device).
    """
    ps = ps or _identity
    f = dist.dtype
    n = ps(weight.sum())
    mean = ps((dist * weight).sum()) / n
    dev = dist - mean
    std = torch.sqrt(ps((weight * (dev * dev)).sum()) / n)
    if widen_first and is_first:
        threshold = mean + torch.maximum(sigma_multiplier * std, mean * 0.5)
    else:
        threshold = mean + sigma_multiplier * std
    valid = (dist <= threshold) & (weight > 0)
    valid_count = ps(valid.sum(dtype=torch.int32))
    sum_sq = ps(torch.where(valid, dist * dist, torch.zeros_like(dist)).sum())
    rmse = torch.where(
        valid_count > 0,
        torch.sqrt(sum_sq / torch.clamp(valid_count, min=1).to(f)),
        torch.zeros((), dtype=f, device=dist.device),
    )
    return mean, std, threshold, valid, valid_count, rmse, n


def _global_masked_median(dist, weight, ps=None):
    """Exact lower median of ``dist`` over weight > 0 rows:
    ``sorted(valid)[(cnt-1)//2]``, the M-estimators' scale; over every
    rank's rows when ``ps`` reduces over a mesh."""
    ps = ps or _identity
    valid = weight > 0
    k = torch.clamp(ps(valid.sum(dtype=torch.int32)) - 1, min=0) // 2
    return _global_masked_kth(dist, valid, k, ps)


def _global_masked_kth(values, valid, k, ps=None):
    """Exact k-th smallest (0-based) of non-negative ``values`` over
    ``valid`` rows, by bisection on the float bit pattern (monotone for
    non-negative floats): 31 masked counts for f32, 63 for f64, all on the
    device, each reduced by ``ps`` (one int32 per round over a mesh). The
    JAX package's arithmetic, wrap-around included, so the result is its
    value bit for bit (with no valid row that is −0.0)."""
    ps = ps or _identity
    if values.dtype == torch.float64:
        ibits = values.view(torch.int64)
        nbits, itype, ftype = 63, torch.int64, torch.float64
    else:
        ibits = values.to(torch.float32).view(torch.int32)
        nbits, itype, ftype = 31, torch.int32, torch.float32
    lo = torch.zeros((), dtype=itype, device=values.device)
    hi = torch.full((), 2**nbits - 1, dtype=itype, device=values.device)
    for _ in range(nbits):
        mid = lo + (hi - lo) // 2
        take = ps((valid & (ibits <= mid)).sum(dtype=torch.int32)) >= k + 1
        lo, hi = torch.where(take, lo, mid + 1), torch.where(take, mid, hi)
    return lo.view(ftype).to(values.dtype)


def _robust_weights(dist, weight, robust: str, ps=None):
    """M-estimator weights of the pose update. The scale is median-based
    (σ̂ = med(d) / 0.6745): the plain σ is inflated by the very
    contamination being downweighted. Huber c = 1.345σ̂, Tukey c =
    4.685σ̂; σ̂ = 0 (already aligned) falls back to the plain mask."""
    scale = _global_masked_median(dist, weight, ps) / 0.6745
    if robust == "huber":
        c = 1.345 * scale
        w = torch.clamp(c / torch.clamp(dist, min=1e-30), max=1.0)
    else:
        c = 4.685 * scale
        u = torch.clamp(dist / torch.clamp(c, min=1e-30), 0.0, 1.0)
        w = (1.0 - u * u) * (1.0 - u * u)
    return torch.where(scale > 0, w, torch.ones_like(w))


def _plane_global(src, dst, nrm, valid, ps=None):
    """Point-to-plane update: minimise Σ v·((R·s + t − d)·n)² linearised
    about the identity (R·s ≈ s + ω×s), solved as 6×6 normal equations
    with λ = 1e-6·tr/6 + 1e-12 on the diagonal, lifted to SE(3) by the
    exponential map. ``solve_ex`` reads nothing to the host; a failed
    solve leaves non-finite values, which the loop stops on. ``ps`` sums
    the 6×6 system over a mesh's ranks."""
    ps = ps or _identity
    f = src.dtype
    v = valid.to(f)
    nrm = nrm.to(f)
    r0 = ((src - dst) * nrm).sum(dim=1)
    J = torch.cat([nrm, torch.linalg.cross(src, nrm, dim=1)], dim=1)
    Jv = J * v[:, None]
    H6 = ps(Jv.T @ J)
    g = ps(Jv.T @ r0)
    lam = 1e-6 * torch.trace(H6) / 6.0 + 1e-12
    delta, _ = torch.linalg.solve_ex(
        H6 + lam * torch.eye(6, dtype=f, device=src.device), -g)
    return se3_exp(delta).to(f)


def _const(x, dtype, device):
    """A 0-d tensor of ``x`` on ``device``: on the card its host-to-device
    copy waits for the card, so it is a ``read/const`` span."""
    with stage("read/const"):
        return torch.tensor(x, dtype=dtype, device=device)


def icp_core(source, weight, target, nn_state, *, nn_fn: Callable,
             max_iterations: int, tolerance: float, sigma_multiplier: float,
             widen_first: bool, estimator: str = "point",
             robust: str = "none", carry: Optional[tuple] = None,
             return_registered: bool = True, ps=None) -> dict:
    """The ICP loop in the centered local frame.

    ``carry`` = (T_cum, prev_error, no_improve) starts the convergence
    state machine from that state instead of identity / 1e10 / 0. Returns
    the final carry, the stop code, the recorded count and the history
    (device tensors), and the registered source when asked. ``nn_fn``
    returns (matched, dist), plus the matched normals for the plane
    estimator. ``ps`` (a mesh rank's ``psum``) reduces every statistic
    over the ranks' rows, so each rank takes the same decisions; None on
    one device.
    """
    f = source.dtype
    dev = source.device
    H = max_iterations
    if carry is None:
        T_cum = torch.eye(4, dtype=f, device=dev)
        prev = _const(1e10, f, dev)
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
    tol = _const(tolerance, f, dev)
    sig = _const(sigma_multiplier, f, dev)
    recorded = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    stop = RUNNING
    while it < H and stop == RUNNING:
        src = apply_transform(T_cum, source)
        with stage("nn"):
            if estimator == "plane":
                dst, dist, nrm = nn_fn(src, target, nn_state)
            else:
                dst, dist = nn_fn(src, target, nn_state)
        with stage("stats"):
            mean, std, thr, valid, valid_count, rmse, n_real = (
                iteration_statistics(dist, weight, sig, widen_first, it == 0,
                                     ps))
            numerr = ~torch.isfinite(rmse + mean + std)
            small = torch.abs(prev - rmse) < tol
            no_improve = torch.where(small, noimp + 1,
                                     torch.zeros_like(noimp))
            converged = small & (no_improve >= 3) & ~numerr
            diverged = ~converged & (rmse > prev * 1.1)
            too_few = ~converged & ~diverged & (valid_count < 3)
            will_update = ~(converged | diverged | too_few | numerr)
            upd_w = (valid if robust == "none"
                     else valid.to(f) * _robust_weights(dist, weight, robust,
                                                        ps))
        with stage("solve"):
            if estimator == "plane":
                # A linearisation about the CURRENT pose: the increment
                # composes onto the cumulative transform.
                T_cand = _plane_global(src, dst, nrm, upd_w, ps) @ T_cum
            else:
                # Kabsch from the PRISTINE source to the matched targets
                # fits T_cum directly (no chain of rounded 4×4 products).
                T_cand = kabsch_masked(source, dst, upd_w, ps=ps)
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
        with stage("read/stop"):
            stop = int(stop_t)  # the loop's own host read per iteration
    if stop == RUNNING:
        stop = MAX_ITERATIONS
    out = {"T_cum": T_cum, "prev_error": prev, "no_improve": noimp,
           "stop": stop, "recorded": recorded, **hist}
    if return_registered:
        out["src"] = apply_transform(T_cum, source)
    return out


def _rebase_transform(T_local: np.ndarray, offset: np.ndarray) -> np.ndarray:
    """T_world = Shift(offset) @ T_local @ Shift(-offset)."""
    T = np.asarray(T_local, np.float64).copy()
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    T[..., :3, 3] = t + offset - (R @ offset)
    return T


def _pose_magnitudes(T_world: np.ndarray):
    """(rotation degrees, translation norms) of a (k, 4, 4) stack: one
    formula for the result's history and the streamed records, so the two
    agree bit for bit (the norm of a single vector rounds differently
    from the row norms of a stack)."""
    rot = np.degrees(np.arccos(np.clip(
        (np.trace(T_world[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)))
    return rot, np.linalg.norm(T_world[:, :3, 3], axis=1)


_HIST_KEYS = ("h_rmse", "h_valid", "h_out", "h_T", "h_mean", "h_std", "h_thr")

# The JAX package's auto-segmentation of large runs (models/icp.py:1160-
# 1168): at AUTO_SEGMENT_POINTS points or more and no segment_iterations
# of the caller's, slices of max(2, AUTO_SEGMENT_BUDGET // points)
# iterations.
AUTO_SEGMENT_POINTS = 2_000_000
AUTO_SEGMENT_BUDGET = 8_000_000


def auto_segment_iterations(segment_iterations: int, points: int,
                            callbacks, share: "int | None" = None) -> int:
    """``segment_iterations``, or the auto-segmentation's slice length
    where ``points`` ≥ ``AUTO_SEGMENT_POINTS``, the caller gave no slice
    length and at least one of ``callbacks`` (progress, stop, segment) is
    not None. The slice budget divides over ``share`` points (default
    ``points``; a mesh's points per rank).

    The JAX package segments every such run, callbacks or not, because a
    TPU worker kills a device program that runs for minutes; the
    trajectory is the same either way (its comment, :1165-1166). Here the
    host launches each iteration's kernels, so no launch is long-lived:
    without a callback nothing a caller can see changes, and the run
    keeps one dispatch. With one, the caller gets what the JAX package
    gives at that size: records and carries at every slice's end, and a
    stop honoured there."""
    if (segment_iterations or points < AUTO_SEGMENT_POINTS
            or all(c is None for c in callbacks)):
        return segment_iterations
    return max(2, AUTO_SEGMENT_BUDGET // max(points if share is None
                                             else share, 1))


def _run_segmented(dispatch, offset, *, max_iterations: int,
                   segment_iterations: int, widen_first: bool,
                   progress_callback, stop_event, carry_init,
                   segment_callback):
    """Run the loop in slices of ``segment_iterations``, carrying
    (T_cum, prev_error, no_improve) across them.

    ``dispatch(carry, seg_n, widen_first)`` runs ``icp_core`` for ``seg_n``
    iterations from ``carry`` (None: the initial state). The pristine
    source goes to every segment unchanged and the loop recomputes the
    current source from the carried T_cum, so the concatenated trajectory
    is the one-dispatch trajectory bit for bit. Between segments the host
    emits per-iteration records (the reference's ``iterationCompleted``),
    the resumable carry (``segment_callback``) and honours ``stop_event``
    (a segment is the stop granularity).
    """
    carry = carry_init
    parts = {k: [] for k in _HIST_KEYS}
    total_recorded = 0
    done = 0
    stop = MAX_ITERATIONS
    out = None
    while done < max_iterations:
        seg_n = min(segment_iterations, max_iterations - done)
        out = dispatch(carry, seg_n, widen_first and done == 0)
        host = {key: out[key].cpu().numpy()
                for key in _HIST_KEYS + ("T_cum", "prev_error", "no_improve")}
        k = int(out["recorded"])
        for key in _HIST_KEYS:
            parts[key].append(host[key][:k])
        carry = (out["T_cum"], out["prev_error"], out["no_improve"])

        if progress_callback is not None:
            seg_T_world = _rebase_transform(host["h_T"][:k], offset)
            seg_rot, seg_t = _pose_magnitudes(seg_T_world)
            for i in range(k):
                Tw = seg_T_world[i]
                progress_callback({
                    "iteration": total_recorded + i + 1,
                    "rmse": float(host["h_rmse"][i]),
                    "valid_points": int(host["h_valid"][i]),
                    "outlier_points": int(host["h_out"][i]),
                    "transform": Tw,
                    "rotation_angle_deg": float(seg_rot[i]),
                    "translation_norm": float(seg_t[i]),
                    "mean_dist": float(host["h_mean"][i]),
                    "std_dist": float(host["h_std"][i]),
                    "threshold": float(host["h_thr"][i]),
                })
        total_recorded += k
        done += seg_n
        if segment_callback is not None:
            # The exact loop carry: feeding it back through
            # ``resume_carry`` continues bit for bit. The local-frame
            # matrix is the exact one (the world rebase round-trips
            # through cancellation at UTM scale).
            segment_callback({
                "iteration": total_recorded,
                "transform": _rebase_transform(host["T_cum"], offset),
                "transform_local": host["T_cum"],
                "offset": np.asarray(offset, np.float64),
                "prev_error": float(host["prev_error"]),
                "no_improve": int(host["no_improve"]),
            })
        if out["stop"] != MAX_ITERATIONS:
            stop = out["stop"]
            break
        if stop_event is not None and stop_event.is_set():
            stop = STOPPED
            break
    return {
        "src": out.get("src"), "T_cum": carry[0], "prev_error": carry[1],
        "no_improve": carry[2], "stop": stop, "recorded": total_recorded,
        **{k: np.concatenate(parts[k]) for k in _HIST_KEYS},
    }


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
                      tile_q=128, group="x", fold=True):
    """The sweep's source prep: apply the local-frame initial transform
    (None: the source is at its pose), build the x-group-aligned layout at
    that pose, gather.

    ``fold=False`` keys the layout by the transformed positions (tile
    coherence needs the current pose) but returns the RAW source rows: for
    callers whose loop carry already holds the pose (the two-stage fine
    level resumes through ``resume_carry``), where folding would apply it
    twice."""
    src = src_raw if T_loc is None else apply_transform(T_loc, src_raw)
    rows, weight = grouped_tile_order_device(
        src, origin, cell_size, resolution=resolution, tile_q=tile_q,
        group=group,
    )
    return (src if fold else src_raw)[rows], rows, weight


def _compose_callback(cb, T_init):
    """Report a callback's transforms composed with the pre-alignment
    ``T_init`` (the loop's T_cum is relative to the pre-aligned source)."""
    if cb is None:
        return None

    def wrapped(rec):
        # The local-frame carry keys do not include T_init, so a resume
        # through them would lose it: drop them, the composed world
        # transform is the resume path.
        rec = {k: v for k, v in rec.items()
               if k not in ("transform_local", "offset")}
        # A stack of one: the result's history is composed as a stack.
        Tw = np.matmul(rec["transform"][None], T_init)
        rec["transform"] = Tw[0]
        # Magnitudes follow the composed transform (run-relative values
        # would jump at a stage or resume boundary).
        if "rotation_angle_deg" in rec:
            rot, t = _pose_magnitudes(Tw)
            rec["rotation_angle_deg"] = float(rot[0])
            rec["translation_norm"] = float(t[0])
        cb(rec)

    return wrapped


def _resume_state(resume_carry, offset, dtype, device):
    """The loop carry from ``resume_carry``: a tuple (T_world, prev_error,
    no_improve) or a dict with those keys (``transform``, ``prev_error``,
    ``no_improve``) and optionally the exact local matrix
    (``transform_local``) with its centering ``offset``, used when the
    offset matches this run's."""
    if isinstance(resume_carry, dict):
        T_w = resume_carry["transform"]
        pe = resume_carry["prev_error"]
        ni = resume_carry["no_improve"]
        T_l = resume_carry.get("transform_local")
        ck_off = resume_carry.get("offset")
    else:
        T_w, pe, ni = resume_carry
        T_l = ck_off = None
    if (T_l is not None and ck_off is not None
            and np.array_equal(np.asarray(ck_off, np.float64), offset)):
        T_loc = np.asarray(T_l, np.float64)
    else:
        T_loc = _rebase_transform(np.asarray(T_w, np.float64), -offset)
    return (torch.as_tensor(T_loc, dtype=dtype, device=device),
            torch.as_tensor(pe, dtype=dtype, device=device),
            torch.as_tensor(int(ni), dtype=torch.int32, device=device))


@registration_call
def icp_register(
    source,
    target,
    *,
    max_iterations: int = 50,
    tolerance: float = 1e-6,
    sigma_multiplier: float = 3.0,
    mode: str = "gui",
    nn_backend: str = "auto",
    nn_fn: Optional[Callable] = None,
    nn_state=(),
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

    ``nn_backend``: "auto", "bruteforce", "pallas" (the slab sweep), or
    the test and reference backends "cellblock" and "hashgrid" (point
    mode only). ``cell_capacity`` sizes the hashgrid backend's cells
    (None: from the occupancy histogram); every other backend ignores
    it, as in the JAX package.

    ``nn_fn(query, target, nn_state)`` → (matched, dist), or (matched,
    dist, normal) for the plane estimator, with its ``nn_state``: the
    caller's NN (e.g. ``ops.sweep_nn.make_pallas_nn`` or
    ``make_pallas_brute``) in place of ``nn_backend`` and ``prepared_nn``.
    The source keeps the caller's row order (no query layout) and the
    target is passed as centered ``dtype`` rows, as in the JAX package.

    ``estimator``: "point" (the reference's Kabsch) or "plane"
    (point-to-plane on cell-PCA target normals; nn_backend "bruteforce"
    or "pallas"). ``robust``: "none", "huber" or "tukey" reweights the
    pose update (statistics and convergence stay on the 3σ mask).

    ``initial_transform`` (4,4) pre-aligns the source (e.g. a coarse-level
    estimate); the returned transforms include it. ``device_data`` =
    (src_dev, tgt_dev, offset): f32 device tensors centered by ``offset``;
    the initial transform is then applied on the device.
    ``prepared_nn`` = (nn_fn, nn_state, resolution) from
    ``ops.sweep_nn.make_pallas_nn_device`` built against ``tgt_dev``, with
    normals iff ``estimator="plane"``; ``layout_transform`` then keys its
    query layout at that pose while the source stays raw (the carry of a
    ``resume_carry`` holds the pose).

    ``segment_iterations`` > 0 runs the loop in slices of that many
    iterations (the same trajectory), enabling ``progress_callback``
    (one record per iteration), ``segment_callback`` (the resumable carry
    at each boundary) and ``stop_event`` (a ``threading.Event``; stops
    with STOPPED at the next boundary). At ≥ 2M source points with one of
    those given and no ``segment_iterations``, the slices are
    ``max(2, 8_000_000 // points)`` long (``auto_segment_iterations``).

    ``resume_carry``: (T_world, prev_error, no_improve) or a
    ``segment_callback`` record; the loop starts from that exact state
    (bit-identical to the uninterrupted run when the record's local
    matrix and offset are used) with first-iteration widening off.
    Mutually exclusive with ``initial_transform``.
    """
    dev = resolve_device(device)
    if estimator not in ("point", "plane"):
        raise ValueError(f"unknown estimator {estimator!r}")
    if robust not in ("none", "huber", "tukey"):
        raise ValueError(f"unknown robust mode {robust!r}")

    source = np.asarray(source, np.float64)
    target = np.asarray(target, np.float64)
    T_init = None
    if initial_transform is not None:
        if resume_carry is not None:
            raise ValueError(
                "initial_transform and resume_carry are mutually exclusive")
        T_init = np.asarray(initial_transform, np.float64)
        if device_data is None:
            source = source @ T_init[:3, :3].T + T_init[:3, 3]
    n_orig = len(source)
    (src_local, tgt_local, offset), level_nn, _, rows = prepare_level(
        source, target, dev, dtype=dtype, center=center,
        nn_backend=(nn_backend if nn_fn is None and prepared_nn is None
                    else None),
        estimator=estimator, grid_resolution=grid_resolution,
        cell_capacity=cell_capacity, device_data=device_data)
    # The pose applied on the device: a caller's device clouds take the
    # initial transform there (host clouds were moved before the upload).
    T_loc, fold = None, True
    if T_init is not None and device_data is not None:
        T_loc = _rebase_transform(T_init, -offset)
    elif (layout_transform is not None and device_data is not None
          and prepared_nn is not None):
        # Layout-only pose (the two-stage fine level): the carry holds
        # the full pose. Not applied on the generic resume path: a
        # resumed run's layout must match the uninterrupted run's
        # (row order feeds reduction order).
        T_loc = _rebase_transform(
            np.asarray(layout_transform, np.float64), -offset)
        fold = False
    if T_loc is not None:
        T_loc = torch.as_tensor(T_loc, dtype=dtype, device=src_local.device)
    row_weight = nn_res = None
    sweep = False  # the caller's nn_fn: the source keeps its order
    if nn_fn is None:
        nn_fn, nn_state, nn_res = prepared_nn or level_nn
        if prepared_nn is not None:
            check_prepared(nn_fn, estimator)
        sweep = hasattr(nn_fn, "layout_group")
    if sweep:
        # The query layout is keyed on the sweep's grid at the pose.
        grid0 = nn_state[0]
        with stage("prep") as done:
            src_local, rows, row_weight = _prep_fine_source(
                src_local, T_loc, grid0.origin, grid0.cell_size,
                resolution=nn_res, tile_q=nn_fn.tile_q,
                group=nn_fn.layout_group, fold=fold,
            )
            done(src_local)
    else:
        if T_loc is not None and fold:
            src_local = apply_transform(T_loc, src_local)
        if rows is not None:
            src_local = src_local[rows]
    weight = (row_weight.to(dtype) if row_weight is not None
              else torch.ones(src_local.shape[:1], dtype=dtype,
                              device=src_local.device))

    if T_init is not None:
        progress_callback = _compose_callback(progress_callback, T_init)
        segment_callback = _compose_callback(segment_callback, T_init)
    carry = None
    widen = mode == "gui"
    if resume_carry is not None:
        carry = _resume_state(resume_carry, offset, dtype, src_local.device)
        widen = False  # the run's first iteration is long past

    # The JAX package's ≥2M auto-segmentation, where a callback sees it.
    segment_iterations = auto_segment_iterations(
        segment_iterations, n_orig,
        (progress_callback, stop_event, segment_callback))

    def dispatch(carry_, n_iter, widen_):
        return icp_core(
            src_local, weight, tgt_local, nn_state, nn_fn=nn_fn,
            max_iterations=n_iter, tolerance=tolerance,
            sigma_multiplier=sigma_multiplier, widen_first=widen_,
            estimator=estimator, robust=robust, carry=carry_,
            return_registered=return_registered,
        )

    with stage("loop") as done:
        if segment_iterations and segment_iterations > 0:
            out = _run_segmented(
                dispatch, offset, max_iterations=max_iterations,
                segment_iterations=segment_iterations, widen_first=widen,
                progress_callback=progress_callback, stop_event=stop_event,
                carry_init=carry, segment_callback=segment_callback,
            )
        else:
            out = dispatch(carry, max_iterations, widen)
        done(out["T_cum"])
    with stage("package"):
        res = package_result(out, offset, return_registered=False)
    res.nn_resolution = nn_res
    if return_registered:
        # The registered cloud: the device rows' host copy in the world
        # frame, in the caller's row order.
        with stage("registered"):
            res.source_registered = (
                np.asarray(out["src"].cpu().numpy(), np.float64) + offset)
            if rows is not None:
                res = apply_permutation(
                    res, rows.cpu().numpy(),
                    row_weight.cpu().numpy() if row_weight is not None
                    else None, n_orig,
                )
    if T_init is not None:
        res.transform = res.transform @ T_init
        res.history_transform = res.history_transform @ T_init
        # Rotation/translation histories follow the composed transforms.
        (res.history_rotation_deg,
         res.history_translation) = _pose_magnitudes(res.history_transform)
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
    rot_deg, t_norm = _pose_magnitudes(h_T_world)
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
