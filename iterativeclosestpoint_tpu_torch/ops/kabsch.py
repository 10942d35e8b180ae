"""Kabsch/SVD rigid-transform estimation with a 0/1 inlier mask.

Counterpart of the JAX package's ``ops/kabsch.py`` and of the reference's
``computeBestFitTransform`` (``icpengine.cpp:76-115``): centroids →
centered clouds → cross-covariance H = Σ a_c b_cᵀ → SVD → R = V Uᵀ with the
det<0 reflection fix applied to V's third column (the GUI form,
icpengine.cpp:101-104) → t = c_b − R c_a. The inlier mask is folded into
the reductions as weights, so shapes stay fixed.
"""

from __future__ import annotations

import torch


def _weighted_moments(s, d, w, ps=None):
    """Weighted centroids + cross-covariance (two-pass: centroids first).

    ``ps`` sums each moment over a mesh's ranks (the JAX package's
    ``_kabsch_global``, ``models/icp.py:251``); None on one device.
    Returns (centroid_src (3,), centroid_dst (3,), H (3,3), count ()).
    """
    if ps is None:
        def ps(x):
            return x
    w = w.to(s.dtype)
    count = ps(w.sum())
    inv = torch.where(count > 0, 1.0 / count, torch.zeros_like(count))
    c_s = ps(w @ s) * inv
    c_d = ps(w @ d) * inv
    H = ps(((s - c_s) * w[:, None]).T @ (d - c_d))
    return c_s, c_d, H, count


def rigid_from_covariance(H: torch.Tensor, c_src: torch.Tensor,
                          c_dst: torch.Tensor) -> torch.Tensor:
    """Solve the orthogonal Procrustes problem given cross-covariance H.

    Reflection handling follows the reference GUI form: flip V's third
    column when det(V Uᵀ) < 0. ``torch.linalg.svd`` sorts the singular
    values, so the third column is the smallest one's, as with JacobiSVD.

    A non-finite H (a NaN or inf coordinate) gives R and t of NaN, as the
    JAX package's SVD does; ``torch.linalg.svd`` would raise instead, so
    it is fed a zero matrix then (no host read decides it).
    """
    fin = torch.isfinite(H).all()
    U, _, Vh = torch.linalg.svd(torch.where(fin, H, torch.zeros_like(H)))
    V = Vh.T
    R = V @ U.T
    sign = torch.where(torch.linalg.det(R) < 0, -1.0, 1.0).to(H.dtype)
    V = torch.cat([V[:, :2], V[:, 2:] * sign], dim=1)
    R = torch.where(fin, V @ U.T, torch.full_like(R, float("nan")))
    t = c_dst - R @ c_src

    T = torch.eye(4, dtype=H.dtype, device=H.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def kabsch_masked(src, dst, mask, ps=None) -> torch.Tensor:
    """Best rigid transform mapping masked ``src`` points onto ``dst``.

    ``mask`` is the (N,) 0/1 (or bool) inlier set; the reductions and the
    (4,4) result are in ``src.dtype``. ``ps`` reduces the moments over a
    mesh's ranks (each holding some of the rows).
    """
    c_s, c_d, H, _ = _weighted_moments(src, dst, mask, ps)
    return rigid_from_covariance(H, c_s, c_d).to(src.dtype)


def kabsch(src, dst) -> torch.Tensor:
    """Unmasked Kabsch over full correspondence sets: ``kabsch_masked``
    with every row an inlier, in ``src.dtype``."""
    ones = torch.ones(src.shape[:1], dtype=src.dtype, device=src.device)
    return kabsch_masked(src, dst, ones)
