"""Carry the state that decides a registration across the two packages.

ICP has no weights; what decides the computation is the NN grid
(``PallasGrid``: ``tgt_t``, ``col_start``, ``origin``, ``cell_size``,
``bbox_hi``; the volume regime's ``ZPallasGrid`` has ``cell_start`` in
place of ``col_start`` and may have per-axis cells), the fine query
layout (``rows`` and ``weight``, plain arrays) and the convergence carry (``T_cum``, ``prev_error``,
``no_improve``). These helpers move the grid and the carry between numpy
(what the JAX package's arrays convert to) and the port's tensors, so the
same grid can feed both sweeps. The test and reference backends' grids
(``CellGrid``, ``HashGrid``) convert field by field with their dtypes
kept (f32 or f64 coordinates, int32 offsets and indices). A partitioned
target's slabs (``PartitionState``) convert to the port's ragged per-rank
slabs, so both packages can run on the same ingested target.
"""

from __future__ import annotations

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.ops.cellblock import CellGrid
from iterativeclosestpoint_tpu_torch.ops.hashgrid import HashGrid
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    PallasGrid,
    ZPallasGrid,
)


def _dtype(field):
    return np.int32 if field in ("col_start", "cell_start") else np.float32


def _from_numpy(cls, d, device):
    return cls(**{
        k: torch.as_tensor(np.array(d[k], dtype=_dtype(k)), device=device)
        for k in cls._fields
    })


def grid_from_numpy(d: dict, device) -> PallasGrid:
    """A grid level from its fields as numpy arrays (e.g. a JAX
    ``PallasGrid`` converted field by field)."""
    return _from_numpy(PallasGrid, d, device)


def zgrid_from_numpy(d: dict, device) -> ZPallasGrid:
    """A z-column grid from its fields as numpy arrays (e.g. a JAX
    ``ZPallasGrid`` converted field by field)."""
    return _from_numpy(ZPallasGrid, d, device)


def cellgrid_from_numpy(d: dict, device) -> CellGrid:
    """A cell-blocked grid from its fields as numpy arrays (e.g. a JAX
    ``CellGrid`` converted field by field), dtypes kept."""
    return CellGrid(**{k: torch.as_tensor(np.array(d[k]), device=device)
                       for k in CellGrid._fields})


def hashgrid_from_numpy(d: dict, device) -> HashGrid:
    """A voxel-hash grid from its fields as numpy arrays (e.g. a JAX
    ``HashGrid`` converted field by field), dtypes kept."""
    return HashGrid(**{k: torch.as_tensor(np.array(d[k]), device=device)
                       for k in HashGrid._fields})


def grid_to_numpy(grid: "PallasGrid | ZPallasGrid") -> dict:
    """The inverse of ``grid_from_numpy`` and ``zgrid_from_numpy``."""
    return {k: getattr(grid, k).cpu().numpy() for k in grid._fields}


zgrid_to_numpy = grid_to_numpy


def carry_from_numpy(T_cum, prev_error, no_improve, *, dtype, device):
    """(T_cum (4,4), prev_error, no_improve) as the ICP loop's carry."""
    return (
        torch.as_tensor(np.array(T_cum), dtype=dtype, device=device),
        torch.as_tensor(np.array(prev_error), dtype=dtype, device=device),
        torch.as_tensor(np.array(no_improve), dtype=torch.int32,
                        device=device),
    )


def partition_state_from_numpy(d: dict, mesh, *, dtype=torch.float32,
                               normals: bool = False):
    """A JAX ``PartitionState`` given as numpy per device (``halo_pts``
    (D, M, 3), ``halo_idx`` (D, M), ``halo_nrm`` (D, M, 3), ``x_lo``,
    ``x_hi`` (D,)) as the port's per-rank slabs on ``mesh``'s devices
    (this process's ranks): real rows only (``halo_idx`` below 2³¹−1,
    where JAX pads with far rows), in their order, with their original
    indices; ``normals`` keeps ``halo_nrm`` (else the slabs carry none,
    as an ingested state does)."""
    from iterativeclosestpoint_tpu_torch.parallel.partition import (
        _IMAX,
        PartitionState,
        slab_tensors,
    )

    idx = np.asarray(d["halo_idx"])
    if idx.shape[0] != mesh.size:
        raise ValueError(f"{idx.shape[0]} slabs for a mesh of {mesh.size} "
                         "ranks")
    pts, gidx, nrm = [None] * mesh.size, [None] * mesh.size, [None] * mesh.size
    for r in mesh.local_ranks:
        real = idx[r] != _IMAX
        pts[r], gidx[r], nrm[r] = slab_tensors(
            np.asarray(d["halo_pts"])[r][real], idx[r][real],
            mesh.devices[r], dtype,
            np.asarray(d["halo_nrm"])[r][real] if normals else None)
    return PartitionState(pts, gidx, nrm,
                          np.asarray(d["x_lo"], np.float64),
                          np.asarray(d["x_hi"], np.float64))
