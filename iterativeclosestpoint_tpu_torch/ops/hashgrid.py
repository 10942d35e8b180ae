"""Voxel-hash grid exact 1-NN: a test and reference backend.

Counterpart of the JAX package's ``ops/hashgrid.py``. The target is
bucketed into an R³ grid and sorted by cell id (host); a query reads the
27-neighbourhood of its cell with two fixed-shape mechanisms:

  * a per-cell candidate capacity K: at most the first K points of each
    neighbour cell are read (``cell_capacity``, chosen from the occupancy
    histogram when not given);
  * a shared overflow list: every point past its cell's first K is
    brute-forced against all queries, so the candidate set is exactly
    "the 27-neighbourhood ∪ overflow".

A query inside the grid whose best distance is ≤ the cell size is
certified exact. ``nn_hybrid`` falls back to brute force over the whole
target when any query is uncertified (a host read). Brute force is
``ops/sweep_kernels.py::nn_exact``: the K3 kernel for f32 on the card,
``nn_bruteforce`` for f64. The JAX package scans the K slots one at a time
keeping the first strict minimum; here a block of slots is one tensor and
one first-minimum ``argmin`` over (slot, neighbour), which selects the
same winner.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.ops.bruteforce import sq_dist, sqrt_rn
from iterativeclosestpoint_tpu_torch.ops.cellblock import _first_min, _np_dtype
from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import nn_exact
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device

_BIG = 1.0e18
# Elements of one block of (queries × slots × 27) candidates.
_BLOCK = 1 << 23


class HashGrid(NamedTuple):
    sorted_pts: torch.Tensor    # (M, 3) target points sorted by cell id
    sorted_idx: torch.Tensor    # (M,) original target index per sorted slot
    cell_start: torch.Tensor    # (R³+1,) CSR offsets into sorted arrays
    overflow_pts: torch.Tensor  # (O_pad, 3) points beyond per-cell capacity
    overflow_idx: torch.Tensor  # (O_pad,) original indices (0 for padding)
    origin: torch.Tensor        # (3,) grid origin (target AABB min)
    cell_size: torch.Tensor     # () scalar


def choose_capacity(counts: np.ndarray, overflow_cap: int) -> int:
    """Smallest per-cell capacity K with total overflow ≤ overflow_cap."""
    if counts.size == 0:
        return 1
    hi = int(counts.max())
    lo = 1
    while lo < hi:
        mid = (lo + hi) // 2
        if np.maximum(counts - mid, 0).sum() <= overflow_cap:
            hi = mid
        else:
            lo = mid + 1
    return lo


def build_hashgrid(target: np.ndarray, resolution: int = 64,
                   capacity: "int | None" = None, overflow_cap: int = 2048,
                   dtype=torch.float32, device=None):
    """Build the grid on the host and upload it to ``device`` (None: the
    card). Returns (HashGrid, capacity).

    ``target`` is in the centered local frame (f64 in, stored as
    ``dtype``); ``resolution`` cells per axis cover the bbox's largest
    extent.
    """
    dev = resolve_device(device)
    target = np.asarray(target)
    m = len(target)
    R = resolution
    f = _np_dtype(dtype)

    tmin = target.min(axis=0)
    tmax = target.max(axis=0)
    extent = float((tmax - tmin).max())
    cell = max(extent / R, 1e-9)

    coords = np.clip(((target - tmin) / cell).astype(np.int64), 0, R - 1)
    cid = (coords[:, 0] * R + coords[:, 1]) * R + coords[:, 2]
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    cell_start = np.searchsorted(sorted_cid, np.arange(R**3 + 1)).astype(
        np.int32)

    counts = np.diff(cell_start)
    occupied = counts[counts > 0]
    if capacity is None:
        capacity = choose_capacity(occupied, overflow_cap)

    # Rank of each sorted point within its cell; rank ≥ K → overflow.
    rank = np.arange(m) - cell_start[sorted_cid]
    over = order[rank >= capacity]
    o_pad = max(8, 1 << int(np.ceil(np.log2(max(len(over), 1)))))
    overflow_pts = np.full((o_pad, 3), 1e15, f)
    overflow_idx = np.zeros((o_pad,), np.int32)
    if len(over):
        overflow_pts[: len(over)] = target[over]
        overflow_idx[: len(over)] = over

    grid = HashGrid(
        sorted_pts=torch.as_tensor(target[order].astype(f), device=dev),
        sorted_idx=torch.as_tensor(order.astype(np.int32), device=dev),
        cell_start=torch.as_tensor(cell_start, device=dev),
        overflow_pts=torch.as_tensor(overflow_pts, device=dev),
        overflow_idx=torch.as_tensor(overflow_idx, device=dev),
        origin=torch.as_tensor(tmin, dtype=dtype, device=dev),
        cell_size=torch.tensor(cell, dtype=dtype, device=dev),
    )
    return grid, capacity


def nn_hashgrid(query: torch.Tensor, grid: HashGrid, *, resolution: int,
                capacity: int, query_chunk: int = 65536):
    """Grid 1-NN for every query point.

    Returns (idx (N,) original target indices, dist (N,), certified (N,)
    bool: True where the result is provably exact).
    """
    R = resolution
    K = capacity
    n = query.shape[0]
    m = grid.sorted_pts.shape[0]
    dev = query.device
    r3 = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    # The 27 neighbour offsets, x-major (the JAX package's order).
    offs = torch.stack(torch.meshgrid(r3, r3, r3, indexing="ij"),
                       dim=-1).reshape(27, 3)
    d2 = torch.empty((n,), dtype=query.dtype, device=dev)
    idx = torch.empty((n,), dtype=torch.int64, device=dev)
    inside = torch.empty((n,), dtype=torch.bool, device=dev)
    for c0 in range(0, n, query_chunk):
        q = query[c0:c0 + query_chunk]
        c = q.shape[0]
        qcell = torch.floor((q - grid.origin) / grid.cell_size).to(
            torch.int32)
        inside[c0:c0 + c] = ((qcell >= 0) & (qcell < R)).all(dim=1)
        qcell = torch.clamp(qcell, 0, R - 1)

        nb = qcell[:, None, :] + offs[None, :, :]  # (c, 27, 3)
        nb_ok = ((nb >= 0) & (nb < R)).all(dim=-1)  # (c, 27)
        nb = torch.clamp(nb, 0, R - 1).long()
        cid = (nb[..., 0] * R + nb[..., 1]) * R + nb[..., 2]
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        start = torch.where(nb_ok, grid.cell_start[cid].long(), zero)
        end = torch.where(nb_ok, grid.cell_start[cid + 1].long(), zero)

        best_d2 = torch.full((c,), _BIG, dtype=query.dtype, device=dev)
        best_i = torch.zeros((c,), dtype=torch.int64, device=dev)
        kb = max(1, min(K, _BLOCK // max(c * 27, 1)))
        for k0 in range(0, K, kb):
            ks = torch.arange(k0, min(K, k0 + kb), device=dev)
            pos = start[:, None, :] + ks[None, :, None]  # (c, kb, 27)
            ok = pos < end[:, None, :]
            pos = torch.clamp(pos, max=m - 1).reshape(c, 1, -1)
            dk = sq_dist(q[:, None, :], grid.sorted_pts[pos[:, 0]])
            dk.masked_fill_(~ok.reshape(c, 1, -1), _BIG)
            dmin, slot = _first_min(dk, pos, _BIG)
            take = dmin[:, 0] < best_d2
            best_d2 = torch.where(take, dmin[:, 0], best_d2)
            best_i = torch.where(take, grid.sorted_idx[slot[:, 0]].long(),
                                 best_i)
        d2[c0:c0 + c] = best_d2
        idx[c0:c0 + c] = best_i

    # Overflow pass: exact brute force against the shared overflow list.
    o_idx, o_dist = nn_exact(query, grid.overflow_pts)
    o_d2 = o_dist * o_dist
    take = o_d2 < d2
    d2 = torch.where(take, o_d2, d2)
    idx = torch.where(take, grid.overflow_idx[o_idx].long(), idx)

    dist = sqrt_rn(torch.clamp(d2, min=0.0))
    certified = inside & (dist <= grid.cell_size)
    return idx, dist, certified


def nn_hybrid(query: torch.Tensor, target: torch.Tensor, grid: HashGrid, *,
              resolution: int, capacity: int, query_chunk: int = 65536):
    """Exact 1-NN: the grid's result when every query is certified, else
    brute force over the whole target (one host read decides)."""
    idx, dist, certified = nn_hashgrid(
        query, grid, resolution=resolution, capacity=capacity,
        query_chunk=query_chunk)
    if bool(certified.all()):  # host read
        return idx, dist
    return nn_exact(query, target)


def make_hashgrid_nn(target_local: np.ndarray, resolution: int = 64,
                     capacity: "int | None" = None, dtype=torch.float32,
                     device=None):
    """Build the grid; returns (nn_fn, nn_state) for the ICP driver,
    ``nn_fn(query, target, nn_state) -> (matched, dist)``."""
    grid, K = build_hashgrid(target_local, resolution=resolution,
                             capacity=capacity, dtype=dtype, device=device)
    return _hybrid_fn(resolution, K), grid


@functools.lru_cache(maxsize=None)
def _hybrid_fn(resolution: int, capacity: int):
    def fn(query, target, grid):
        idx, dist = nn_hybrid(query, target, grid, resolution=resolution,
                              capacity=capacity)
        return target[idx], dist

    return fn
