"""Host-side grid-resolution estimators (numpy).

Copies of the occupancy model and resolution gates of the JAX package's
``ops/cellblock.py`` (``_occupancy_model`` :68, ``surface_boost_ok`` :108,
``auto_resolution_data`` :136). Both packages must pick the same grid from
the same cloud, so the arithmetic is kept exactly. The cell-blocked NN
search of that module (``nn_cellblock``) is not part of the port yet.
"""

from __future__ import annotations

import numpy as np

from iterativeclosestpoint_tpu_torch.utils.hostmath import bbox


def _occupancy_model(target: np.ndarray, probe: int = 32):
    """(c1, d): occupied-cell count at resolution ``probe`` and the
    cloud's estimated box dimension (≈2 scan surface, ≈3 volume).

    Above 2M points a strided subsample is cellized (it still hits
    essentially every occupied probe cell). One cellize pass at 2·probe
    gives both scales: cells at ``probe`` are the 2·probe cells with
    coordinates >> 1.
    """
    tmin, tmax = bbox(target)
    extent = float((tmax - tmin).max()) or 1.0
    probe_target = target[:: max(1, len(target) // 2_000_000)]

    r2 = probe * 2
    c = np.clip((probe_target - tmin) / (extent / r2), 0, r2 - 1).astype(
        np.int32
    )
    cid2 = (c[:, 0] * r2 + c[:, 1]) * r2 + c[:, 2]
    occ2 = np.zeros(r2 * r2 * r2, np.bool_)
    occ2[cid2] = True
    c2 = max(int(occ2.sum()), 1)
    ch = c >> 1
    cid1 = (ch[:, 0] * probe + ch[:, 1]) * probe + ch[:, 2]
    occ1 = np.zeros(probe * probe * probe, np.bool_)
    occ1[cid1] = True
    c1 = max(int(occ1.sum()), 1)
    d = min(max(np.log2(c2 / c1), 1.0), 3.0)
    return c1, d


def surface_boost_ok(
    target: np.ndarray, resolution: int, *,
    population: "int | None" = None, occupancy: int = 32, probe: int = 32,
    model: "tuple[int, float] | None" = None,
) -> bool:
    """True iff the surface-boost gate passes with ``resolution`` as the
    BOOSTED grid resolution: box dimension d ≤ 2.45 AND predicted
    occupancy at ``resolution`` ≥ ``occupancy`` points per occupied cell
    (the safe edge for the coarse→fine ladder handoff). ``model`` reuses a
    precomputed ``_occupancy_model`` result."""
    target = np.asarray(target)
    if resolution > 512:
        return False
    c1, d = model if model is not None else _occupancy_model(target, probe)
    pop = population if population is not None else len(target)
    return bool(
        d <= 2.45 and pop / (c1 * (resolution / probe) ** d) >= occupancy
    )


def auto_resolution_data(
    target: np.ndarray, occupancy: int = 128, probe: int = 32,
    population: "int | None" = None,
    surface_boost_occupancy: "int | None" = None,
    return_base: bool = False,
    model: "tuple[int, float] | None" = None,
) -> "int | tuple[int, int]":
    """Data-aware resolution: estimate the box dimension d from occupied
    cell counts at two scales, then pick the power-of-two R (8..512) whose
    mean occupied-cell occupancy is ≈ ``occupancy``.

    ``surface_boost_occupancy``: on surface-like clouds (d ≤ 2.45) take one
    notch finer when the boosted grid keeps at least that many points per
    occupied cell (the fused sweep's grid). ``return_base=True`` returns
    ``(resolution, base_resolution)``."""
    target = np.asarray(target)
    c1, d = model if model is not None else _occupancy_model(target, probe)
    pop = population if population is not None else len(target)
    # cells(R) ≈ c1 · (R/probe)^d ; want pop/cells(R) ≈ occupancy.
    r = probe * (pop / (occupancy * c1)) ** (1.0 / d)
    r = 1 << int(np.clip(np.round(np.log2(max(r, 1))), 3, 9))
    base = int(r)
    r = base
    if (
        surface_boost_occupancy is not None
        and d <= 2.45
        and base < 512
        and pop / (c1 * ((2 * base) / probe) ** d)
        >= surface_boost_occupancy
    ):
        r = base * 2
    if return_base:
        return int(r), base
    return int(r)
