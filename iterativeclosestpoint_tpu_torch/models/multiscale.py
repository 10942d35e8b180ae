"""Coarse-to-fine multiscale ICP (single device, point-to-point).

Counterpart of the JAX package's ``models/multiscale.py``
(``icp_register_multiscale`` :50, ``_run_level`` :293). A coarse pass on a
stride subsample estimates the bulk of the SE(3) with exact brute-force
NN; the full-resolution pass then starts inside the fine grid's cell size,
so its iterations stay on the certified slab sweep.

The JAX package enqueued the coarse inputs before the bulk uploads and
deferred the fine grid build behind the coarse loop, working around a
FIFO host-to-device queue on the TPU host (``multiscale.py:143-235``).
That ordering is left out on purpose: here the fine level's upload,
grid estimate and grid build simply run after the coarse level.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.models.icp import ICPResult, icp_register
from iterativeclosestpoint_tpu_torch.ops.sweep_nn import make_pallas_nn_device
from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
    estimate_grid_params,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import scope, stage
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device
from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset


@dataclasses.dataclass
class MultiscaleResult:
    """Fine-level result plus the per-level trail."""

    final: ICPResult
    levels: list  # [(stride, ICPResult), ...] coarse → fine

    @property
    def transform(self) -> np.ndarray:
        return self.final.transform

    @property
    def rmse(self) -> float:
        return self.final.rmse

    @property
    def success(self) -> bool:
        return self.final.success


def _prepare_fine(source, target, fine_kwargs, dev):
    """Upload the centered f32 clouds and build the fine-level grids.
    Returns (device_data, prepared_nn)."""
    with stage("host_prep"):
        offset = (center_offset(target) if fine_kwargs.get("center", True)
                  else np.zeros(3))
        src_local = (source - offset).astype(np.float32)
        tgt_local = (target - offset).astype(np.float32)
    with stage("upload", bytes=src_local.nbytes + tgt_local.nbytes) as done:
        src_dev = torch.as_tensor(src_local, device=dev)
        tgt_dev = torch.as_tensor(tgt_local, device=dev)
        done((src_dev, tgt_dev))
    with stage("grid_est"):
        grid_est = estimate_grid_params(
            tgt_local, fine_kwargs.get("grid_resolution"))
    with stage("grid_build") as done:
        prepared_nn = make_pallas_nn_device(
            tgt_local, target_dev=tgt_dev, est=grid_est)
        done(prepared_nn[1])
    return (src_dev, tgt_dev, offset), prepared_nn


def icp_register_multiscale(
    source,
    target,
    *,
    strides: Optional[Sequence[int]] = None,
    coarse_max_points: int = 30_000,
    coarse_iterations: int = 20,
    coarse_tolerance: float = 1e-4,
    dtype=torch.float32,
    mesh=None,
    fine_path: str = "auto",
    initial_transform: Optional[np.ndarray] = None,
    device=None,
    **fine_kwargs,
) -> MultiscaleResult:
    """Register via a stride pyramid; the fine level gets every point.

    ``strides``: explicit pyramid, e.g. (16, 4, 1); default = one coarse
    level with stride ceil(N / coarse_max_points) (plus sqrt-spaced levels
    for very large clouds) then full resolution. ``device``: None means the
    card; "cpu" runs the plain versions. ``fine_kwargs`` go to the final
    full-resolution ``icp_register`` (nn_backend, max_iterations,
    tolerance, mode, ...).
    """
    if mesh is not None or fine_path == "partitioned":
        raise NotImplementedError(
            "multi-device paths (mesh, fine_path='partitioned') are not "
            "ported yet (ROADMAP P15)")
    if fine_path != "auto":
        raise ValueError(f"unknown fine_path {fine_path!r}")
    if fine_kwargs.get("estimator", "point") == "plane":
        raise NotImplementedError(
            "estimator='plane' is not ported yet (ROADMAP P10)")
    dev = resolve_device(device)
    source = np.asarray(source, np.float64)
    target = np.asarray(target, np.float64)
    n = len(source)

    if strides is None:
        s = max(1, -(-n // coarse_max_points))
        # Deep pyramids for very large clouds: sqrt-spaced levels keep each
        # level's residual misalignment below the next level's cell size.
        ladder = [s]
        while ladder[-1] > 64:
            ladder.append(max(2, int(round(ladder[-1] ** 0.5))))
        strides = tuple(ladder) + (1,) if s > 1 else (1,)
    if strides[-1] != 1:
        strides = tuple(strides) + (1,)

    fine_backend = fine_kwargs.get("nn_backend", "auto")
    prepare = (
        len(strides) > 1
        and dtype == torch.float32
        and (fine_backend == "pallas"
             or (fine_backend == "auto" and n * len(target) > 2**31))
    )
    T = (np.asarray(initial_transform, np.float64)
         if initial_transform is not None else None)
    levels = []
    for li, stride in enumerate(strides):
        last = li == len(strides) - 1
        if not last:
            with scope(f"coarse{li}" if li else "coarse"):
                res = icp_register(
                    source[::stride], target[::stride], dtype=dtype,
                    initial_transform=T, max_iterations=coarse_iterations,
                    tolerance=coarse_tolerance, nn_backend="auto",
                    mode=fine_kwargs.get("mode", "gui"),
                    return_registered=False, device=dev,
                )
        else:
            device_data = prepared_nn = None
            if prepare:
                device_data, prepared_nn = _prepare_fine(
                    source, target, fine_kwargs, dev)
                fine_kwargs.setdefault("nn_backend", "pallas")
            with scope("fine"):
                res = icp_register(
                    source, target, dtype=dtype, initial_transform=T,
                    device_data=device_data, prepared_nn=prepared_nn,
                    device=dev, **fine_kwargs,
                )
        levels.append((stride, res))
        T = res.transform
        if not res.success:
            break
    return MultiscaleResult(final=levels[-1][1], levels=levels)
