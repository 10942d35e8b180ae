"""Cell-blocked exact 1-NN (a test and reference backend) and the
host-side grid-resolution estimators.

Counterpart of the JAX package's ``ops/cellblock.py``. The estimators
(``_occupancy_model``, ``surface_boost_ok``, ``auto_resolution_data``)
are numpy copies: both packages must pick the same grid from the same
cloud. The search:

  * the target is sorted once by linear cell id ((cx·R)+cy)·R+cz (host),
    so the 27-neighbourhood of a block of cells is a few contiguous
    z-runs of the sorted rows, one per (x, y) column;
  * queries are Morton-sorted once by their initial cell
    (``morton_order``), so tiles of ``tile_q`` queries stay compact;
  * per tile: the ``runs_xy``² columns of the tile's cell box dilated by
    one cell, each a run of at most ``run_len`` rows, brute-forced
    against the tile; a query is certified when its own ±1 neighbourhood
    lies in the box, its 9 columns fit the run cap, and its best distance
    is ≤ the cell size;
  * uncertified queries are resolved exactly by budgeted brute passes
    (``nn_cellblock_exact``), then by one global pass if the budget
    overflows (``ops/sweep_kernels.py::nn_exact``: f32 brute force on the
    card is the K3 kernel; f64 is ``nn_bruteforce``).

The JAX package scans a tile's runs one at a time (``lax.scan``) keeping
the first strict minimum; here all runs of a group of ``tile_group`` tiles
are one tensor and one first-minimum ``argmin`` over (run, row), which
selects the same winner. Repair gates are host reads.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.ops.bruteforce import sq_dist, sqrt_rn
from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import nn_exact
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device
from iterativeclosestpoint_tpu_torch.utils.hostmath import bbox

_BIG = 1.0e18


def _np_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


class CellGrid(NamedTuple):
    sorted_pts: torch.Tensor   # (M + run_pad, 3) cell-sorted target + far pad
    sorted_idx: torch.Tensor   # (M,) original index per sorted row
    cell_start: torch.Tensor   # (R³+1,) CSR row offsets
    origin: torch.Tensor       # (3,)
    cell_size: torch.Tensor    # ()


def morton_encode(cells: np.ndarray, bits: int = 10) -> np.ndarray:
    """Interleave-bits Morton code of (N, 3) non-negative int cell coords."""
    code = np.zeros(len(cells), np.uint64)
    c = cells.astype(np.uint64)
    for b in range(bits):
        for a in range(3):
            code |= ((c[:, a] >> b) & 1) << np.uint64(3 * b + a)
    return code


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


def auto_resolution(n_target: int, occupancy: int = 256) -> int:
    """Grid resolution heuristic for surface-like clouds from the point
    count alone (occupied cells scale ~k·R² with k ≈ 2 z-layers): R ≈
    sqrt(M / occupancy), ~100-150 points per occupied cell. Powers of two
    in [16, 512]."""
    r = int(np.sqrt(max(n_target, 1) / occupancy))
    r = 1 << max(4, min(9, int(np.ceil(np.log2(max(r, 16))))))
    return r


def build_cellgrid(target: np.ndarray, resolution: int, run_pad: int = 512,
                   dtype=torch.float32, device=None) -> CellGrid:
    """Host-side build: sort the target by linear cell id, CSR offsets,
    ``run_pad`` far rows (so every run's slice stays in bounds); the grid
    is then uploaded to ``device`` (None: the card)."""
    dev = resolve_device(device)
    target = np.asarray(target)
    R = resolution
    tmin, tmax = bbox(target)
    cell = max(float((tmax - tmin).max()) / R, 1e-9)

    coords = np.clip(((target - tmin) / cell).astype(np.int64), 0, R - 1)
    cid = (coords[:, 0] * R + coords[:, 1]) * R + coords[:, 2]
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    cell_start = np.searchsorted(sorted_cid, np.arange(R**3 + 1)).astype(
        np.int32)

    pts = np.full((len(target) + run_pad, 3), 1e15, _np_dtype(dtype))
    pts[: len(target)] = target[order]
    return CellGrid(
        sorted_pts=torch.as_tensor(pts, device=dev),
        sorted_idx=torch.as_tensor(order.astype(np.int32), device=dev),
        cell_start=torch.as_tensor(cell_start, device=dev),
        origin=torch.as_tensor(tmin, dtype=dtype, device=dev),
        cell_size=torch.tensor(cell, dtype=dtype, device=dev),
    )


def morton_order(points: np.ndarray, resolution: int) -> np.ndarray:
    """Query permutation: Morton order of the points' cells (host, once)."""
    pmin, pmax = bbox(points)
    extent = float((pmax - pmin).max())
    cell = max(extent / resolution, 1e-9)
    coords = np.clip(((points - pmin) / cell).astype(np.int64), 0,
                     resolution - 1)
    return np.argsort(morton_encode(coords), kind="stable")


def _first_min(d2, rows, big):
    """First minimum along the last axis; ``rows`` are the candidates' row
    numbers. A minimum ≥ ``big`` (nothing found) reports (big, row 0),
    as a scan that keeps only strict improvements on ``big`` does."""
    j = torch.argmin(d2, dim=-1, keepdim=True)
    dmin = torch.gather(d2, -1, j)[..., 0]
    row = torch.gather(rows.expand(d2.shape), -1, j)[..., 0]
    none = dmin >= big
    return (torch.where(none, torch.full_like(dmin, big), dmin),
            torch.where(none, torch.zeros_like(row), row))


def nn_cellblock(query: torch.Tensor, grid: CellGrid, *, resolution: int,
                 tile_q: int = 128, runs_xy: int = 6, run_len: int = 512,
                 tile_group: int = 8):
    """Tile-blocked grid 1-NN.

    ``query`` should be Morton-sorted (``morton_order``) for tile
    coherence; it is padded to a multiple of ``tile_q · tile_group`` by
    replicating its last row. Returns (idx (N,) original target indices,
    dist (N,), certified (N,) bool).
    """
    R = resolution
    n_in = query.shape[0]
    step = tile_q * tile_group
    n = -(-n_in // step) * step
    if n != n_in:
        query = torch.cat([query, query[-1:].expand(n - n_in, 3)])
    dev = query.device
    m_rows = grid.sorted_pts.shape[0]
    n_runs = runs_xy * runs_xy

    qcell = torch.floor((query - grid.origin) / grid.cell_size).to(
        torch.int32)
    inside = ((qcell >= 0) & (qcell < R)).all(dim=1)
    qcell_cl = torch.clamp(qcell, 0, R - 1)

    t = n // tile_q
    q_t = query.reshape(t, tile_q, 3)
    qc_t = qcell_cl.reshape(t, tile_q, 3)
    minc = qc_t.amin(dim=1)  # (t, 3)
    maxc = qc_t.amax(dim=1)

    # Column box anchored at the tile's min cell minus one. A query is
    # certified on its own when its ±1 neighbourhood lies inside the box
    # and each of its 9 columns fits the run cap: a few stragglers in a
    # wide tile go to repair without failing the rest of the tile.
    bx = minc[:, 0] - 1  # (t,)
    by = minc[:, 1] - 1
    ri = torch.arange(n_runs, dtype=torch.int32, device=dev)
    cx = bx[:, None] + ri[None, :] // runs_xy  # (t, n_runs)
    cy = by[:, None] + ri[None, :] % runs_xy
    col_ok = (cx >= 0) & (cx < R) & (cy >= 0) & (cy < R)
    cx_cl = torch.clamp(cx, 0, R - 1).long()
    cy_cl = torch.clamp(cy, 0, R - 1).long()

    z_lo = torch.clamp(minc[:, 2] - 1, 0, R - 1).long()  # (t,)
    z_hi = torch.clamp(maxc[:, 2] + 1, 0, R - 1).long()
    cid_lo = (cx_cl * R + cy_cl) * R + z_lo[:, None]
    cid_hi = (cx_cl * R + cy_cl) * R + z_hi[:, None]
    zero = torch.zeros((), dtype=grid.cell_start.dtype, device=dev)
    run_start = torch.where(col_ok, grid.cell_start[cid_lo], zero)
    run_end = torch.where(col_ok, grid.cell_start[cid_hi + 1], zero)
    col_fits = run_end - run_start <= run_len  # (t, n_runs)

    # Per-query coverage: x/y neighbourhood inside the box columns ...
    qx = qc_t[..., 0]  # (t, tile_q)
    qy = qc_t[..., 1]
    in_box = ((qx - bx[:, None] + 1 <= runs_xy - 1)
              & (qy - by[:, None] + 1 <= runs_xy - 1))
    # ... and all 9 of the query's columns within the run cap.
    ox = qx - bx[:, None]
    oy = qy - by[:, None]
    q_cols_fit = torch.ones_like(in_box)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            ci = (torch.clamp(ox + dx, 0, runs_xy - 1) * runs_xy
                  + torch.clamp(oy + dy, 0, runs_xy - 1))
            q_cols_fit &= torch.gather(col_fits, 1, ci.long())
    query_complete = (in_box & q_cols_fit).reshape(n)

    base = torch.clamp(run_start.long(), max=m_rows - run_len)
    # Lanes past every run's end are masked in every run; dropping them
    # leaves each first minimum as it is (one host read).
    span = int((run_end.long() - base).amax())
    lane = torch.arange(min(max(span, 1), run_len), device=dev)
    d2_out = torch.empty((t, tile_q), dtype=query.dtype, device=dev)
    row_out = torch.empty((t, tile_q), dtype=torch.int64, device=dev)
    # One group of tiles at a time bounds memory (the JAX package's
    # ``lax.map`` over groups); every run of the group is one tensor.
    for g0 in range(0, t, tile_group):
        sl = slice(g0, g0 + tile_group)
        rows = base[sl, :, None] + lane  # (g, n_runs, run_len)
        ok = ((rows >= run_start[sl, :, None].long())
              & (rows < run_end[sl, :, None].long()))
        rows = rows.reshape(rows.shape[0], 1, -1)
        d2 = sq_dist(q_t[sl], grid.sorted_pts[rows[:, 0]])
        d2.masked_fill_(~ok.reshape(ok.shape[0], 1, -1), _BIG)
        d2_out[sl], row_out[sl] = _first_min(d2, rows, _BIG)
    d2 = d2_out.reshape(n)
    row = row_out.reshape(n)

    found = d2 < _BIG
    idx = torch.where(
        found,
        grid.sorted_idx[torch.clamp(row, max=grid.sorted_idx.shape[0] - 1)]
        .long(), 0)
    dist = sqrt_rn(torch.clamp(d2, min=0.0))
    certified = inside & query_complete & found & (dist <= grid.cell_size)
    return idx[:n_in], dist[:n_in], certified[:n_in]


def nn_cellblock_exact(query: torch.Tensor, target: torch.Tensor,
                       grid: CellGrid, *, resolution: int, tile_q: int = 128,
                       runs_xy: int = 6, run_len: int = 512,
                       tile_group: int = 8, brute_batch: int = 4096,
                       brute_passes: int = 16):
    """Exact 1-NN: cell-blocked grid, budgeted brute repair, global pass.

    Uncertified queries are compacted to the front (a stable sort of the
    certificate) and resolved in at most ``brute_passes`` batches of
    ``brute_batch`` against the whole target; past that budget one global
    brute pass resolves every query. Each gate is a host read.
    """
    idx, dist, certified = nn_cellblock(
        query, grid, resolution=resolution, tile_q=tile_q, runs_xy=runs_xy,
        run_len=run_len, tile_group=tile_group)
    n_bad = int((~certified).sum())  # host read
    B = brute_batch
    if n_bad > 0:
        perm = torch.argsort(certified.to(torch.int32), stable=True)
        for p in range(brute_passes):
            if n_bad <= p * B:
                break
            rows = perm[p * B:(p + 1) * B]
            bi, bd = nn_exact(query[rows], target)
            live = min(B, n_bad - p * B)  # later rows are certified
            idx[rows[:live]] = bi[:live]
            dist[rows[:live]] = bd[:live]
    if n_bad > brute_passes * B:
        # Budget overflow: resolve globally, exactly.
        idx, dist = nn_exact(query, target)
    return idx, dist


def make_cellblock_nn(target_local: np.ndarray, resolution: "int | None" =
                      None, run_len: int = 512, dtype=torch.float32,
                      device=None):
    """Build the grid; returns (nn_fn, nn_state, resolution) for the ICP
    driver."""
    if resolution is None:
        resolution = auto_resolution_data(target_local)
    grid = build_cellgrid(target_local, resolution, run_pad=run_len,
                          dtype=dtype, device=device)
    return _cellblock_fn(resolution, run_len), grid, resolution


@functools.lru_cache(maxsize=None)
def _cellblock_fn(resolution: int, run_len: int):
    def fn(query, target, nn_state):
        idx, dist = nn_cellblock_exact(query, target, nn_state,
                                       resolution=resolution,
                                       run_len=run_len)
        return target[idx], dist

    return fn
