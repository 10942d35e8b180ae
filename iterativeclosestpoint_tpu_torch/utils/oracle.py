"""NumPy (f64) oracle replicating the reference ICP iteration exactly.

The port's own copy of the JAX package's ``utils/oracle.py``, numpy and
scipy only, so it runs where neither JAX nor the JAX package is installed
(the card's machine): the executable specification of the reference
engine (``PointCloudRegistration/core/icpengine.cpp:117-394`` for "gui"
mode, ``icp_registration.cpp:443-622`` for "cli" mode) that the port's
f64 trajectories are held against iteration by iteration, including every
behavioral quirk catalogued in SURVEY.md §6.1:

  1. NN structure built once from the fixed target; the source moves.
  2. Convergence = |ΔRMSE| < tol for 3 consecutive iterations
     (icpengine.cpp:286-306); divergence stop if RMSE > 1.1·prev (:311-314),
     both checked *before* the SVD step of that iteration.
  3. RMSE over valid (inlier) points only (:273-278).
  4. gui mode widens the first-iteration threshold:
     mean + max(3σ, 0.5·mean) (:249-255); cli uses mean+3σ throughout.
  5. On the converge path the recorded entry reuses the previous
     cumulative transform (:294-301).
  9. Double precision end-to-end.

NN here is exact 1-NN via scipy cKDTree — numerically identical to the
reference octree's best-first search result. The arithmetic is the JAX
package's line for line, so both copies give the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree


@dataclasses.dataclass
class OracleIteration:
    iteration: int
    rmse: float
    valid_points: int
    outlier_points: int
    transform: np.ndarray  # (4,4) cumulative
    rotation_angle_deg: float
    translation_norm: float
    mean_dist: float
    std_dist: float
    threshold: float


@dataclasses.dataclass
class OracleResult:
    success: bool
    message: str
    transform: np.ndarray  # final cumulative (4,4)
    rmse: float
    iterations: int
    history: list
    source_registered: np.ndarray  # (N,3) transformed source


def best_fit_transform(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Kabsch on (N,3) pairs; GUI-form reflection fix (icpengine.cpp:76-115)."""
    cA = A.mean(axis=0)
    cB = B.mean(axis=0)
    H = (A - cA).T @ (B - cB)  # 3x3
    U, _, Vt = np.linalg.svd(H)
    V = Vt.T
    R = V @ U.T
    if np.linalg.det(R) < 0:
        V = V.copy()
        V[:, 2] *= -1
        R = V @ U.T
    t = cB - R @ cA
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def oracle_icp(
    source: np.ndarray,
    target: np.ndarray,
    max_iterations: int = 50,
    tolerance: float = 1e-6,
    sigma_multiplier: float = 3.0,
    mode: str = "gui",
) -> OracleResult:
    """Run the reference ICP pipeline in float64 NumPy."""
    src = np.asarray(source, dtype=np.float64).copy()
    tgt = np.asarray(target, dtype=np.float64)
    row = len(src)

    tree = cKDTree(tgt)  # built once (quirk 1)
    T_cum = np.eye(4)
    prev_error = 1e10
    no_improve = 0
    history: list[OracleIteration] = []
    message = "max iterations reached"

    for it in range(max_iterations):
        dists, idx = tree.query(src, k=1)
        dst_matched = tgt[idx]

        mean_dist = dists.mean()
        std_dev = np.sqrt(((dists - mean_dist) ** 2).mean())  # population σ

        if it == 0 and mode == "gui":
            threshold = mean_dist + max(sigma_multiplier * std_dev, mean_dist * 0.5)
        else:
            threshold = mean_dist + sigma_multiplier * std_dev

        valid = dists <= threshold
        valid_count = int(valid.sum())
        outlier_count = row - valid_count
        rmse = (
            float(np.sqrt((dists[valid] ** 2).mean())) if valid_count > 0 else 0.0
        )

        improvement = prev_error - rmse
        if abs(improvement) < tolerance:
            no_improve += 1
            if no_improve >= 3:
                # Converged: record entry reusing previous T_cum (quirk 5).
                history.append(
                    OracleIteration(
                        iteration=it + 1,
                        rmse=rmse,
                        valid_points=valid_count,
                        outlier_points=outlier_count,
                        transform=T_cum.copy(),
                        rotation_angle_deg=_rot_angle(T_cum),
                        translation_norm=float(np.linalg.norm(T_cum[:3, 3])),
                        mean_dist=float(mean_dist),
                        std_dist=float(std_dev),
                        threshold=float(threshold),
                    )
                )
                message = "converged"
                break
        else:
            no_improve = 0

        if rmse > prev_error * 1.1:
            message = "diverged"
            break

        prev_error = rmse

        if valid_count < 3:
            return OracleResult(
                False, "insufficient valid pairs", T_cum, rmse, len(history),
                history, src,
            )

        T = best_fit_transform(src[valid], dst_matched[valid])
        T_cum = T @ T_cum
        src = src @ T[:3, :3].T + T[:3, 3]

        history.append(
            OracleIteration(
                iteration=it + 1,
                rmse=rmse,
                valid_points=valid_count,
                outlier_points=outlier_count,
                transform=T_cum.copy(),
                rotation_angle_deg=_rot_angle(T_cum),
                translation_norm=float(np.linalg.norm(T_cum[:3, 3])),
                mean_dist=float(mean_dist),
                std_dist=float(std_dev),
                threshold=float(threshold),
            )
        )

    final_rmse = history[-1].rmse if history else 0.0
    return OracleResult(True, message, T_cum, final_rmse, len(history), history, src)


def _rot_angle(T: np.ndarray) -> float:
    c = (np.trace(T[:3, :3]) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
