"""Host-side reductions over (N,3) clouds (numpy).

``bbox`` scans each column on its own: numpy's ``arr.min(axis=0)`` on a
C-contiguous (N,3) array takes a scalar pairwise inner loop, while a
strided per-column scan vectorizes. The values are bit-identical to the
axis-0 form; ``bbox`` returns float64 vectors, so the geometry math
downstream (grid origin, cell size, centering offset) is f64 by contract.
"""

from __future__ import annotations

import numpy as np


def bbox(pts: np.ndarray):
    """(min, max) over axis 0 of an (N,3) array via per-column scans.

    Returns float64 3-vectors.
    """
    pts = np.asarray(pts)
    lo = np.empty(pts.shape[1], np.float64)
    hi = np.empty(pts.shape[1], np.float64)
    for i in range(pts.shape[1]):
        col = pts[:, i]
        lo[i] = col.min()
        hi[i] = col.max()
    return lo, hi


def center_offset(target: np.ndarray) -> np.ndarray:
    """The f64 global centering offset: the bbox center of the target (the
    frame every device-side f32 computation is relative to)."""
    lo, hi = bbox(target)
    return (lo + hi) / 2.0
