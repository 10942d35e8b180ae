"""The slab sweep's target grid and query layout, built on the device.

Counterpart of ``_build_grid_dev`` (:409), ``_build_grids_dev`` (:476),
``_build_zgrid_dev`` (:1630), ``_build_zgrids_dev`` (:498),
``grouped_tile_order_device`` (:516), ``PallasGrid`` (:61) and
``ZPallasGrid`` (:77) in the JAX package's ``ops/pallas_nn.py``:

* the target is stable-sorted by x-major cell id ((cx·R)+cy)·R+cz and
  stored transposed as ``tgt_t`` (8, M + trange): rows 0-2 are x, y, z,
  rows 3-7 and the ``trange`` tail columns hold the far padding value, so
  a slab read of ``trange`` rows from any base ≤ M stays in bounds; with
  normals (point-to-plane), rows 3-5 hold each point's normal instead and
  0 in the tail columns, and the sweeps return the winner's normal;
* ``col_start`` is the (R²+1,) CSR at (x, y)-column granularity: a slab
  (one x-cell, a y-span, all z) is one contiguous row range;
* the volume regime's ``ZPallasGrid`` has the same sorted layout with
  ``zrange`` tail columns and the full (R³+1,) CSR ``cell_start``, so a
  tile can read just the z-window of each (x, y) column; its cells may be
  anisotropic (``cell_size`` of shape (3,));
* queries are laid out in group-aligned tiles of 128: sorted by cell id,
  each x-cell group ("x", the slab sweep) or (x, y)-cell group ("xy", the
  z-column sweep) padded to a tile multiple by replicating its last query
  (weight 0), so no tile crosses a group boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_FAR = 1.0e6  # padding coordinate: far but square-safe in f32


class PallasGrid(NamedTuple):
    """One grid level (the JAX package's ``PallasGrid``; same fields)."""

    tgt_t: torch.Tensor      # (8, M + trange) f32, cell-sorted, transposed
    col_start: torch.Tensor  # (R²+1,) int32 CSR offsets per (x, y) column
    origin: torch.Tensor     # (3,) f32 grid origin (target bbox min)
    cell_size: torch.Tensor  # () f32
    bbox_hi: torch.Tensor    # (3,) f32 true target bbox max (same frame)


class ZPallasGrid(NamedTuple):
    """The volume regime's grid level (the JAX package's ``ZPallasGrid``;
    same fields)."""

    tgt_t: torch.Tensor       # (8, M + zrange) f32, cell-sorted, transposed
    cell_start: torch.Tensor  # (R³+1,) int32 CSR offsets per cell
    origin: torch.Tensor      # (3,) f32 grid origin (target bbox min)
    cell_size: torch.Tensor   # () or (3,) f32, per-axis cells
    bbox_hi: torch.Tensor     # (3,) f32 true target bbox max (same frame)


def cell_coords(points: torch.Tensor, origin: torch.Tensor,
                cell_size: torch.Tensor, resolution: int) -> torch.Tensor:
    """(N, 3) int32 cell coordinates, truncated toward zero and clipped to
    [0, R-1] (the JAX ``astype(int32)`` + ``clip``). ``cell_size`` is a
    scalar or a per-axis (3,) tensor."""
    c = ((points - origin[None, :]) / cell_size).to(torch.int32)
    return torch.clamp(c, 0, resolution - 1)


def _sorted_grid(target, origin, cell_size, *, resolution: int, tail: int,
                 csr_step: int, normals=None):
    """Stable cell sort, far padding with ``tail`` columns, the CSR over
    every ``csr_step``-th cell id and the true bbox max, on the target's
    device. With ``normals`` (M, 3), rows 3-5 carry them in the sorted
    order and hold 0 in the tail columns. Returns (tgt_t, csr, origin,
    cell_size, bbox_hi)."""
    R = resolution
    tgt = target.to(torch.float32)
    org = origin.to(torch.float32)
    cs = cell_size.to(torch.float32)
    c = cell_coords(tgt, org, cs, R)
    cid = (c[:, 0] * R + c[:, 1]) * R + c[:, 2]
    cid_sorted, order = torch.sort(cid, stable=True)
    # csr[k] = rows with cell id < k·csr_step. The JAX package builds the
    # R³ CSR by a scatter-add bincount and cumsum; searchsorted over the
    # sorted ids yields the same int32 array.
    csr = torch.searchsorted(
        cid_sorted,
        torch.arange(R**3 // csr_step + 1, dtype=torch.int32,
                     device=tgt.device) * csr_step,
    ).to(torch.int32)

    m = tgt.shape[0]
    tt = torch.full((8, m + tail), _FAR, dtype=torch.float32,
                    device=tgt.device)
    tt[0:3, :m] = tgt[order].T
    if normals is not None:
        tt[3:6, :m] = normals.to(torch.float32)[order].T
        tt[3:6, m:] = 0.0
    real = (tgt[:, 0] < _FAR * 0.5)[:, None]
    hi3 = torch.where(real, tgt, torch.full_like(tgt, -_FAR)).amax(dim=0)
    return tt, csr, org, cs, hi3


def build_grid(target: torch.Tensor, origin: torch.Tensor,
               cell_size: torch.Tensor, *, resolution: int,
               trange: int, normals=None) -> PallasGrid:
    """The slab sweep's grid: (R²+1) column CSR, ``trange`` tail columns,
    ``normals`` (M, 3) in rows 3-5 when given."""
    return PallasGrid(*_sorted_grid(target, origin, cell_size,
                                    resolution=resolution, tail=trange,
                                    csr_step=resolution, normals=normals))


def build_zgrid(target: torch.Tensor, origin: torch.Tensor,
                cell_size: torch.Tensor, *, resolution: int,
                zrange: int, normals=None) -> ZPallasGrid:
    """The z-column sweep's grid: full (R³+1) cell CSR, ``zrange`` tail
    columns, ``normals`` in rows 3-5 when given. Meant for the volume
    regime's small R (≤ 128)."""
    return ZPallasGrid(*_sorted_grid(target, origin, cell_size,
                                     resolution=resolution, tail=zrange,
                                     csr_step=1, normals=normals))


def build_grids(target, origin, cell, cell_c, normals=None, *,
                resolution: int, trange: int, coarse_resolution: int,
                coarse_trange: int):
    """The fine grid and the 4×-coarser repair grid over one target."""
    fine = build_grid(target, origin, cell, resolution=resolution,
                      trange=trange, normals=normals)
    coarse = build_grid(target, origin, cell_c, resolution=coarse_resolution,
                        trange=coarse_trange, normals=normals)
    return fine, coarse


def build_zgrids(target, origin, cell3, cell_c, normals=None, *,
                 resolution: int, zrange: int, coarse_resolution: int,
                 coarse_trange: int):
    """The z-column fine grid (per-axis cells ``cell3``) and the x-slab
    coarse repair grid (cubic cells ``cell_c``) over one target."""
    fine = build_zgrid(target, origin, cell3, resolution=resolution,
                       zrange=zrange, normals=normals)
    coarse = build_grid(target, origin, cell_c, resolution=coarse_resolution,
                        trange=coarse_trange, normals=normals)
    return fine, coarse


def grouped_tile_order_device(query, origin, cell_size, *, resolution: int,
                              tile_q: int = 128, group: str = "x"):
    """Group-aligned query layout at a fixed worst-case length.

    ``group``: "x" aligns tiles to x-cell groups (G = R, the slab sweep);
    "xy" to (x, y)-cell groups (G = R², the z-column sweep, whose tiles
    then span one column at layout time). Returns (rows (n_pad,) int64
    into ``query``, weight (n_pad,) f32: 1 for real rows, 0 for
    padding). The length is ``n`` + G·(tile_q−1) rounded
    up to a tile multiple; output row j belongs to group
    g = searchsorted(out_end, j, right) and replicates the group's last
    real row past its count. Rows past the last group's pad replicate one
    real query with weight 0.
    """
    n = query.shape[0]
    R = resolution
    G = R if group == "x" else R * R
    total = -(-(n + G * (tile_q - 1)) // tile_q) * tile_q
    dev = query.device
    c = cell_coords(query.to(torch.float32), origin.to(torch.float32),
                    cell_size.to(torch.float32), R)
    cid = (c[:, 0] * R + c[:, 1]) * R + c[:, 2]
    gq = c[:, 0] if group == "x" else c[:, 0] * R + c[:, 1]
    _, order = torch.sort(cid, stable=True)
    xc = gq[order].to(torch.int64)
    bounds = torch.searchsorted(
        xc, torch.arange(G + 1, dtype=torch.int64, device=dev)
    )
    counts = bounds[1:] - bounds[:-1]
    in_base = bounds[:-1]
    n_pad_g = ((counts + tile_q - 1) // tile_q) * tile_q
    out_end = torch.cumsum(n_pad_g, dim=0)
    out_base = out_end - n_pad_g

    j = torch.arange(total, dtype=torch.int64, device=dev)
    g = torch.searchsorted(out_end, j, right=True)
    g_cl = torch.clamp(g, 0, G - 1)
    r = j - out_base[g_cl]
    cnt = counts[g_cl]
    real = (g < G) & (r < cnt)
    idx = torch.clamp(
        in_base[g_cl] + torch.minimum(r, torch.clamp(cnt - 1, min=0)),
        0, n - 1,
    )
    return order[idx], real.to(torch.float32)
