"""Carry the state that decides a registration across the two packages.

ICP has no weights; what decides the computation is the NN grid
(``PallasGrid``: ``tgt_t``, ``col_start``, ``origin``, ``cell_size``,
``bbox_hi``), the fine query layout (``rows`` and ``weight``, plain
arrays) and the convergence carry (``T_cum``, ``prev_error``,
``no_improve``). These helpers move the grid and the carry between numpy
(what the JAX package's arrays convert to) and the port's tensors, so the
same grid can feed both sweeps.
"""

from __future__ import annotations

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.ops.sweep_grid import PallasGrid

_GRID_DTYPES = {
    "tgt_t": np.float32, "col_start": np.int32, "origin": np.float32,
    "cell_size": np.float32, "bbox_hi": np.float32,
}


def grid_from_numpy(d: dict, device) -> PallasGrid:
    """A grid level from its fields as numpy arrays (e.g. a JAX
    ``PallasGrid`` converted field by field)."""
    return PallasGrid(**{
        k: torch.as_tensor(np.array(d[k], dtype=dt), device=device)
        for k, dt in _GRID_DTYPES.items()
    })


def grid_to_numpy(grid: PallasGrid) -> dict:
    """The inverse of ``grid_from_numpy``."""
    return {k: getattr(grid, k).cpu().numpy() for k in _GRID_DTYPES}


def carry_from_numpy(T_cum, prev_error, no_improve, *, dtype, device):
    """(T_cum (4,4), prev_error, no_improve) as the ICP loop's carry."""
    return (
        torch.as_tensor(np.array(T_cum), dtype=dtype, device=device),
        torch.as_tensor(np.array(prev_error), dtype=dtype, device=device),
        torch.as_tensor(np.array(no_improve), dtype=torch.int32,
                        device=device),
    )
