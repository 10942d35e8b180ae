"""Target surface normals by cell PCA, for the point-to-plane estimator.

Counterpart of the JAX package's ``ops/normals.py``: the host f64 build
``estimate_normals_cellpca`` (:28, a numpy copy, used by the brute-force
plane path), the analytic smallest eigenvector ``_smallest_eigvec_sym3``
(:76) and the device build ``estimate_normals_cellpca_device`` (:123, used
by the grid factory). Points are grouped by their grid cell, each cell's
3×3 covariance gives its normal (the smallest eigenvector), shared by the
cell's members and oriented into the +z hemisphere; cells under
``min_points`` fall back to +z.

The device build sums each cell's moments in 64-bit fixed point, so the
sums do not depend on the order in which a scatter-add meets the points:
two builds of the same cloud on the card give the same normals bit for
bit (the JAX package's f32 scatter-add would not on CUDA, where it is
atomic). Its ``mask_far`` option served the partitioned target's
fixed-length, far-padded slab buffers; the port's slabs are ragged (one
tensor per rank, real rows only), so it is left out
(``parallel/partition.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def estimate_normals_cellpca(target: np.ndarray, resolution: int,
                             min_points: int = 3) -> np.ndarray:
    """(M, 3) unit normals via per-cell PCA on the ``resolution`` grid
    (f64, numpy ``eigh``). Cells with fewer than ``min_points`` members
    fall back to +z."""
    target = np.asarray(target, np.float64)
    m = len(target)
    tmin = target.min(axis=0)
    extent = float((target.max(axis=0) - tmin).max()) or 1.0
    cell = extent / resolution

    coords = np.clip((target - tmin) / cell, 0, resolution - 1).astype(
        np.int64)
    cid = (coords[:, 0] * resolution + coords[:, 1]) * resolution \
        + coords[:, 2]
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    starts = np.flatnonzero(np.diff(sorted_cid, prepend=-1))
    counts = np.diff(np.append(starts, m))

    pts = target[order]
    seg = np.repeat(np.arange(len(starts)), counts)
    sums = np.zeros((len(starts), 3))
    np.add.at(sums, seg, pts)
    means = sums / counts[:, None]
    centered = pts - means[seg]
    outer = centered[:, :, None] * centered[:, None, :]
    covs = np.zeros((len(starts), 3, 3))
    np.add.at(covs, seg, outer)
    covs /= np.maximum(counts, 1)[:, None, None]

    _, v = np.linalg.eigh(covs)  # ascending eigenvalues
    cell_normals = v[:, :, 0]
    flip = cell_normals[:, 2] < 0
    cell_normals[flip] *= -1
    cell_normals[counts < min_points] = np.array([0.0, 0.0, 1.0])

    normals = np.empty((m, 3))
    normals[order] = cell_normals[seg]
    return normals


def _smallest_eigvec_sym3(a11, a12, a13, a22, a23, a33, p_floor):
    """Batched analytic smallest-eigenvalue eigenvector of symmetric 3×3
    matrices (Eberly's trigonometric form).

    Returns (normals (n, 3), degenerate (n,) bool): ``degenerate`` marks
    near-isotropic matrices (p ≤ ``p_floor``) and vanishing cross
    products, where the eigenvector means nothing.
    """
    q = (a11 + a22 + a33) / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    p2 = (b11 * b11 + b22 * b22 + b33 * b33
          + 2.0 * (a12 * a12 + a13 * a13 + a23 * a23))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    degenerate = p <= p_floor
    ps = torch.where(degenerate, torch.ones_like(p), p)
    c11, c22, c33 = b11 / ps, b22 / ps, b33 / ps
    c12, c13, c23 = a12 / ps, a13 / ps, a23 / ps
    half_det = (
        c11 * (c22 * c33 - c23 * c23)
        - c12 * (c12 * c33 - c23 * c13)
        + c13 * (c12 * c23 - c22 * c13)
    ) / 2.0
    phi = torch.acos(torch.clamp(half_det, -1.0, 1.0)) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest

    # Rows of (A − λI); the eigenvector is the largest cross product of
    # two rows.
    r1 = torch.stack([a11 - lam, a12, a13], dim=-1)
    r2 = torch.stack([a12, a22 - lam, a23], dim=-1)
    r3 = torch.stack([a13, a23, a33 - lam], dim=-1)
    c_a = torch.linalg.cross(r1, r2, dim=-1)
    c_b = torch.linalg.cross(r1, r3, dim=-1)
    c_c = torch.linalg.cross(r2, r3, dim=-1)
    n_a = (c_a * c_a).sum(dim=-1)
    n_b = (c_b * c_b).sum(dim=-1)
    n_c = (c_c * c_c).sum(dim=-1)
    best = torch.where(
        ((n_a >= n_b) & (n_a >= n_c))[:, None], c_a,
        torch.where((n_b >= n_c)[:, None], c_b, c_c),
    )
    norm = torch.sqrt(torch.clamp((best * best).sum(dim=-1), min=1e-30))
    return best / norm[:, None], degenerate | (norm <= 1e-12)


def _fixed_point_cell_sums(cid: torch.Tensor, mom: torch.Tensor):
    """Per-cell sums of the (m, 10) moments (column 0 the count), as f32,
    gathered back to each point: (m, 10).

    Columns 1-9 are scaled by one power of two, rounded to int64 and
    scatter-added; integer addition does not depend on order, so the sums
    are the same for any order of the adds. The scale keeps m·max|x| below
    2⁶² (no overflow); each term is rounded to 2⁻ᵏ of the scale, a relative
    error far below f32's.
    """
    m = mom.shape[0]
    cells, inv = torch.unique(cid, return_inverse=True)
    x = mom[:, 1:].double()
    amax = torch.clamp(x.abs().amax(), min=1e-30)
    scale = torch.exp2(torch.floor(62.0 - math.log2(max(m, 1))
                                   - torch.log2(amax)))
    fixed = torch.cat([torch.ones((m, 1), dtype=torch.int64,
                                  device=cid.device),
                       torch.round(x * scale).to(torch.int64)], dim=1)
    sums = torch.zeros((cells.shape[0], 10), dtype=torch.int64,
                       device=cid.device)
    sums.index_add_(0, inv, fixed)
    per_pt = sums[inv]
    return torch.cat([per_pt[:, :1].to(torch.float32),
                      (per_pt[:, 1:].double() / scale).to(torch.float32)],
                     dim=1)


def estimate_normals_cellpca_device(target: torch.Tensor,
                                    origin: torch.Tensor,
                                    cell_size: torch.Tensor, *,
                                    resolution: int,
                                    min_points: int = 3) -> torch.Tensor:
    """(M, 3) f32 unit normals on the target's device: per-cell moments of
    CELL-LOCAL coordinates (bounded by the cell size), the analytic
    eigenvector, upward orientation, +z for cells under ``min_points`` or
    degenerate. Matches the host build to ~1e-3 (another eigen solver and
    precision)."""
    R = resolution
    tgt = target.to(torch.float32)
    org = origin.to(torch.float32)
    cs = cell_size.to(torch.float32)
    coords = torch.clamp(((tgt - org[None, :]) / cs).to(torch.int32),
                         0, R - 1)
    cid = ((coords[:, 0].long() * R + coords[:, 1]) * R + coords[:, 2])
    local = tgt - (coords.to(torch.float32) * cs + org[None, :])

    lx, ly, lz = local[:, 0], local[:, 1], local[:, 2]
    mom = torch.stack(
        [torch.ones_like(lx), lx, ly, lz,
         lx * lx, lx * ly, lx * lz, ly * ly, ly * lz, lz * lz], dim=1)
    pm = _fixed_point_cell_sums(cid, mom)  # (m, 10) own cell's moments
    cnt = pm[:, 0]
    inv = 1.0 / torch.clamp(cnt, min=1.0)
    mx, my, mz = pm[:, 1] * inv, pm[:, 2] * inv, pm[:, 3] * inv
    a11 = pm[:, 4] * inv - mx * mx
    a12 = pm[:, 5] * inv - mx * my
    a13 = pm[:, 6] * inv - mx * mz
    a22 = pm[:, 7] * inv - my * my
    a23 = pm[:, 8] * inv - my * mz
    a33 = pm[:, 9] * inv - mz * mz
    nrm, degen = _smallest_eigvec_sym3(a11, a12, a13, a22, a23, a33,
                                       p_floor=1e-12)
    nrm = torch.where(nrm[:, 2:3] < 0, -nrm, nrm)  # upward orientation
    bad = (cnt < min_points) | degen
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                      device=tgt.device)
    return torch.where(bad[:, None], up[None, :], nrm)
