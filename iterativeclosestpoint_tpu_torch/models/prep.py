"""A level's preparation: its host f64 clouds to the ICP loop's inputs.

One function for every single-process level: ``icp_register`` (and so
the multiscale coarse levels), the multiscale fine level
(``models/multiscale.py::_prepare_fine``) and the data-parallel mesh's
host paths (``parallel/sharded.py``, on its first device). The sweep's
query layout depends on the pose, so its caller builds it
(``models/icp.py::_prep_fine_source``).
"""

from __future__ import annotations

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.ops.cellblock import (
    auto_resolution_data,
    make_cellblock_nn,
    morton_order,
)
from iterativeclosestpoint_tpu_torch.ops.hashgrid import make_hashgrid_nn
from iterativeclosestpoint_tpu_torch.ops.normals import (
    estimate_normals_cellpca,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import nn_exact
from iterativeclosestpoint_tpu_torch.ops.sweep_nn import make_pallas_nn_device
from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
    estimate_fine_grid_device,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import count, stage


def _brute_adapter(query, target, nn_state):
    """Brute-force nn_fn: f32 goes through K3 (its plain version for CPU
    tensors), f64 through the plain ``nn_bruteforce`` (``nn_exact``)."""
    del nn_state
    idx, dist = nn_exact(query, target)
    return target[idx], dist


def _brute_plane_adapter(query, target, nn_state):
    """Brute-force nn_fn of the plane estimator (``nn_state`` = the
    target's normals): the normal is gathered at the winner's index."""
    idx, dist = nn_exact(query, target)
    return target[idx], dist, nn_state[idx]


def nn_backend_for(nn_backend: str, n: int, m: int) -> str:
    """``nn_backend`` with "auto" resolved for ``n`` queries against ``m``
    targets: brute force while the all-pairs work is small (n·m ≤ 2³¹),
    the slab sweep beyond."""
    if nn_backend == "auto":
        return "bruteforce" if n * m <= 2**31 else "pallas"
    return nn_backend


def check_prepared(nn_fn, estimator: str) -> None:
    """A caller's ``prepared_nn`` carries normals iff the estimator is
    "plane"."""
    if getattr(nn_fn, "with_normals", False) != (estimator == "plane"):
        raise ValueError(
            "prepared_nn was built with with_normals="
            f"{getattr(nn_fn, 'with_normals', False)} but "
            f"estimator={estimator!r}; rebuild the factory to match")


def prepare_level(source, target, device, *, dtype=torch.float32,
                  center: bool = True, nn_backend=None,
                  estimator: str = "point", grid_resolution=None,
                  cell_capacity=None, two_stage: bool = False,
                  device_data=None):
    """Turn a level's host f64 ``(source, target)`` into the loop's
    inputs on ``device``; returns ``(device_data, nn, nn2, rows)``.

    ``device_data`` = (src_dev, tgt_dev, offset): the clouds in ``dtype``
    centred by the f64 ``offset`` (zeros with ``center=False``); src_dev
    is None where ``source`` is (a mesh's sharded ingest). The upload
    (``upload``, 24 B a point; a non-contiguous input is copied once,
    counted in ``host_passes``) and the centring on the device
    (``host_prep``: the target box's ``aminmax``, its centre read back
    once, ``prep_reads``; numpy's ``center_offset`` and ``(x -
    offset).astype(dtype)`` bit for bit) are skipped for a caller's
    ``device_data``, which is cast to ``dtype``.

    ``nn`` = (nn_fn, nn_state, resolution) of ``nn_backend`` ("auto",
    resolved on ``len(source)``, "bruteforce", "pallas", "cellblock",
    "hashgrid"; None: no NN). The sweep's are ``grid_est``
    (``estimate_fine_grid_device``) and ``grid_build``
    (``make_pallas_nn_device`` with its box from the device), keyed on the
    centred target in ``dtype``; ``nn2`` is the two-stage fine level's
    boosted sweep where ``two_stage`` and its gate allow, else None.
    ``rows``: cellblock's Morton order of the source on the device, else
    None. The brute force's plane normals, cellblock and the hashgrid
    build on ``x - offset`` taken on the host (``nn_build``)."""
    if nn_backend is not None:
        nn_backend = nn_backend_for(
            nn_backend, 0 if source is None else len(source), len(target))
        if estimator == "plane" and nn_backend not in ("bruteforce",
                                                       "pallas"):
            raise ValueError("estimator='plane' supports nn_backend "
                             "'bruteforce' or 'pallas'")
        if nn_backend not in ("bruteforce", "pallas", "cellblock",
                              "hashgrid"):
            raise ValueError(f"unknown nn_backend {nn_backend!r}")
    if device_data is not None:
        src_dev, tgt_dev, offset = device_data
        src_dev = None if src_dev is None else src_dev.to(dtype)
        tgt_dev, offset = tgt_dev.to(dtype), np.asarray(offset, np.float64)
    else:
        clouds = [x for x in (source, target) if x is not None]
        host = [np.ascontiguousarray(x) for x in clouds]
        with stage("upload", bytes=sum(h.nbytes for h in host)) as done:
            up = [torch.as_tensor(h, device=device) for h in host]
            done(up)
        with stage("host_prep") as done:
            count("host_passes",
                  sum(h is not x for h, x in zip(host, clouds)))
            if center:
                lo, hi = torch.aminmax(up[-1], dim=0)
                off = (lo + hi) / 2
                offset = off.cpu().numpy()
                count("prep_reads")
            else:
                off, offset = up[-1].new_zeros(3), np.zeros(3)
                count("prep_reads", 0)
            # Out of place: on the CPU the f64 tensors are the caller's.
            local = [(x - off).to(dtype) for x in up]
            del up
            done(local)
        src_dev = local[0] if source is not None else None
        tgt_dev = local[-1]
    device_data = (src_dev, tgt_dev, offset)
    if nn_backend is None:
        return device_data, None, None, None
    if nn_backend == "pallas":
        plane = estimator == "plane"
        with stage("grid_est"):
            est, est2 = estimate_fine_grid_device(
                tgt_dev, grid_resolution, plane=plane, two_stage=two_stage)
        with stage("grid_build") as done:
            nn = make_pallas_nn_device(None, target_dev=tgt_dev, est=est,
                                       with_normals=plane)
            nn2 = None
            if est2 is not None:
                # Same target, same base-resolution normals.
                nn2 = make_pallas_nn_device(
                    None, target_dev=tgt_dev, est=est2, with_normals=True,
                    normals=nn[1][2])
            done((nn, nn2))
        return device_data, nn, nn2, None
    with stage("nn_build") as done:
        nn, rows = _host_built_nn(
            nn_backend, source, target, offset, tgt_dev, estimator=estimator,
            grid_resolution=grid_resolution, cell_capacity=cell_capacity)
        done(nn[1])
    return device_data, nn, None, rows


def _host_built_nn(nn_backend, source, target, offset, tgt_dev, *,
                   estimator, grid_resolution, cell_capacity):
    """(nn, rows) of the brute force and of the backends built on a host
    cloud, centred there by the device's ``offset``."""
    like = dict(dtype=tgt_dev.dtype, device=tgt_dev.device)
    if nn_backend == "bruteforce" and estimator != "plane":
        return (_brute_adapter, (), None), None
    count("host_passes")
    tgt_local = target - offset
    if nn_backend == "bruteforce":
        nrm = estimate_normals_cellpca(tgt_local,
                                       auto_resolution_data(tgt_local))
        return (_brute_plane_adapter, torch.as_tensor(nrm, **like),
                None), None
    if nn_backend == "cellblock":
        nn_fn, grid, resolution = make_cellblock_nn(
            tgt_local, resolution=grid_resolution or None, **like)
        rows = None
        if source is not None:
            count("host_passes")
            rows = torch.as_tensor(morton_order(source - offset, resolution),
                                   device=tgt_dev.device)
        return (nn_fn, grid, resolution), rows
    resolution = grid_resolution or 64
    nn_fn, grid = make_hashgrid_nn(tgt_local, resolution=resolution,
                                   capacity=cell_capacity, **like)
    return (nn_fn, grid, resolution), None
