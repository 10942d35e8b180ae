"""Cloud downsampling ops (C1 `PointCloud::downsample`, pointcloud.cpp:107-128).

The reference offers stride decimation to a target size (used by the GUI)
and the CLI hard-codes stride-50 at read time (icp_registration.cpp:857).
Here both, plus voxel-grid downsampling — the principled variant that
keeps spatial coverage uniform instead of relying on file point order
(LAS files are scanline-ordered, so stride decimation biases along scan
lines).

The port's own copy of the JAX package's ``ops/downsample.py`` (numpy on
the host; the same results).
"""

from __future__ import annotations

import numpy as np


def downsample_stride(points: np.ndarray, target_size: int) -> np.ndarray:
    """Every k-th point so the result has ≈ target_size points —
    the reference's downsample(targetSize) semantics."""
    points = np.asarray(points)
    if target_size <= 0 or len(points) <= target_size:
        return points.copy()
    step = -(-len(points) // target_size)
    return points[::step].copy()


def downsample_voxel(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """One representative point (the centroid) per occupied voxel."""
    points = np.asarray(points, np.float64)
    if len(points) == 0:
        return points.copy()
    pmin = points.min(axis=0)
    coords = np.floor((points - pmin) / voxel_size).astype(np.int64)
    dims = coords.max(axis=0) + 1
    cid = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    starts = np.flatnonzero(np.diff(sorted_cid, prepend=-1))
    counts = np.diff(np.append(starts, len(points)))
    seg = np.repeat(np.arange(len(starts)), counts)
    sums = np.zeros((len(starts), 3))
    np.add.at(sums, seg, points[order])
    return sums / counts[:, None]


def downsample_voxel_stride(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """One representative point (first in file order) per occupied voxel —
    keeps original coordinates (no averaging), useful when exact input
    points must survive (e.g. georeferenced checks)."""
    points = np.asarray(points)
    pmin = points.min(axis=0)
    coords = np.floor((points - pmin) / voxel_size).astype(np.int64)
    dims = coords.max(axis=0) + 1
    cid = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    _, first = np.unique(cid, return_index=True)
    return points[np.sort(first)].copy()
