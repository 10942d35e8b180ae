"""Synthetic point-cloud fixtures with known ground-truth SE(3) (numpy).

The envelope follows the reference's test-data generator
(``test_icp.cpp:211-215``): yaw ≤ 10°, pitch/roll ≤ ±5°, translation
±2.5 m in xy and ±1 m in z. The same seed gives the same clouds as the JAX
package's ``utils/synth.py``.
"""

from __future__ import annotations

import numpy as np


def make_cloud(
    n: int,
    seed: int = 0,
    kind: str = "terrain",
    extent: float = 50.0,
) -> np.ndarray:
    """Generate an (n, 3) float64 synthetic cloud.

    kinds:
      - "terrain": smooth heightfield + detail, LiDAR-scan-like (default).
      - "uniform": uniform box fill.
      - "sphere":  noisy spherical shell (curvature in all directions).
    """
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pts = rng.uniform(-extent, extent, size=(n, 3))
        pts[:, 2] *= 0.2
        return pts
    if kind == "sphere":
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        r = extent * (1.0 + 0.02 * rng.normal(size=(n, 1)))
        return v * r
    if kind == "terrain":
        xy = rng.uniform(-extent, extent, size=(n, 2))
        x, y = xy[:, 0], xy[:, 1]
        z = (
            3.0 * np.sin(x * 0.11) * np.cos(y * 0.07)
            + 1.2 * np.sin(x * 0.43 + 1.0) * np.sin(y * 0.31)
            + 0.3 * np.sin(x * 1.7) * np.cos(y * 2.3)
            + 0.05 * rng.normal(size=n)
        )
        return np.stack([x, y, z], axis=1)
    raise ValueError(f"unknown cloud kind {kind!r}")


def random_rigid_transform(
    seed: int = 0,
    max_yaw_deg: float = 10.0,
    max_pitch_roll_deg: float = 5.0,
    max_txy: float = 2.5,
    max_tz: float = 1.0,
) -> np.ndarray:
    """Random SE(3) within the reference's test envelope."""
    rng = np.random.default_rng(seed)
    yaw = np.radians(rng.uniform(-max_yaw_deg, max_yaw_deg))
    pitch = np.radians(rng.uniform(-max_pitch_roll_deg, max_pitch_roll_deg))
    roll = np.radians(rng.uniform(-max_pitch_roll_deg, max_pitch_roll_deg))

    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
    Ry = np.array([[cy, 0, sy], [0, 1.0, 0], [-sy, 0, cy]])
    Rx = np.array([[1.0, 0, 0], [0, cx, -sx], [0, sx, cx]])
    R = Rz @ Ry @ Rx

    t = np.array(
        [
            rng.uniform(-max_txy, max_txy),
            rng.uniform(-max_txy, max_txy),
            rng.uniform(-max_tz, max_tz),
        ]
    )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def apply_transform_np(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def make_registration_pair(
    n: int = 10_000,
    seed: int = 0,
    noise_sigma: float = 0.0,
    outlier_frac: float = 0.0,
    overlap_frac: float = 1.0,
    kind: str = "terrain",
    extent: float = 50.0,
):
    """Build (source, target, T_true) where T_true maps source onto target.

    The *target* is the pristine cloud; the *source* is the cloud moved by
    the inverse perturbation (so ICP must recover T_true). Optional
    per-point Gaussian noise, a fraction of uniform outliers, and partial
    overlap (source cropped to a fraction of the x-range).
    """
    rng = np.random.default_rng(seed + 1)
    target = make_cloud(n, seed=seed, kind=kind, extent=extent)
    T_true = random_rigid_transform(seed=seed)

    src_base = target.copy()
    if overlap_frac < 1.0:
        lo = np.quantile(src_base[:, 0], 1.0 - overlap_frac)
        src_base = src_base[src_base[:, 0] >= lo]
    # source = T_true⁻¹(target region): ICP(source→target) recovers T_true.
    Tinv = np.eye(4)
    Tinv[:3, :3] = T_true[:3, :3].T
    Tinv[:3, 3] = -T_true[:3, :3].T @ T_true[:3, 3]
    source = apply_transform_np(Tinv, src_base)

    if noise_sigma > 0:
        source = source + rng.normal(0, noise_sigma, size=source.shape)
    if outlier_frac > 0:
        n_out = int(len(source) * outlier_frac)
        idx = rng.choice(len(source), n_out, replace=False)
        lo, hi = target.min(axis=0), target.max(axis=0)
        source[idx] = rng.uniform(lo - 5, hi + 5, size=(n_out, 3))
    return source, target, T_true
