"""Streamed, per-process LAS ingest: decode or keep only this process's rows.

Counterpart of the JAX package's ``parallel/ingest.py`` (``header_center``
:39, ``load_las_sharded`` :50, ``sample_x_walls`` :121, ``sample_points``
:153, ``estimate_partition_grid_params`` :178, ``coarse_carry_from_files``
:236, ``load_las_partitioned_target`` :296, ``load_las_partitioned_source``
:419), for clouds larger than one host's memory on a mesh whose ranks span
processes (``parallel.mesh.init_multihost``).

* ``load_las_sharded`` byte-range-seeks into the file and decodes only the
  row blocks of this process's ranks (``parallel.mesh.to_global_rows``),
  for ``icp_register_sharded(source_global=)``.
* The partitioned loaders stream the file once in bounded batches (the
  reference's ``readLASBatch``, lasio.cpp:212-300) and keep only the rows
  inside this process's ranks' x-ranges. Every process counts every rank's
  rows in the same pass, so all agree on the slab sizes without a
  collective. Rows within a slab stay in file order with their original
  target indices (the stable argsort, then ``np.sort`` of each slice): the
  collective repair's first-tie rule depends on that order. The target's
  slabs are ragged (real rows only), not padded with far rows as the JAX
  package pads them to one length. The source's shards are padded to one
  length (JAX's ``m_src``, a multiple of 128) so that every rank's
  collective repair sends as many rows, by repeating the shard's last real
  row with weight 0 (JAX pads with zeros, rows that land outside most
  slabs and go through the repair every iteration).
* The strided samples (``sample_x_walls``, ``sample_points``) read
  bounded chunks, so every process computes the same walls, grid
  parameters (``estimate_partition_grid_params``) and coarse pose
  (``coarse_carry_from_files``) from the same bytes, again without a
  collective.

The centring offset comes from the LAS header's bounds (``header_center``),
so no decode pass is needed to centre.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.io.las import (
    LASHeader,
    read_header,
    read_las_batches,
    read_las_range,
)
from iterativeclosestpoint_tpu_torch.parallel.mesh import Mesh, to_global_rows
from iterativeclosestpoint_tpu_torch.parallel.partition import (
    PartitionState,
    slab_tensors,
)


def _np_dtype(dtype) -> np.dtype:
    """The numpy counterpart of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def header_center(hdr: LASHeader) -> np.ndarray:
    """The f64 centring offset from the header's bounds (no decode pass;
    equal to ``hostmath.center_offset`` of the decoded cloud when the
    writer recorded true bounds, as ours and the reference do)."""
    return (np.asarray(hdr.bounds_min, np.float64)
            + np.asarray(hdr.bounds_max, np.float64)) / 2.0


def load_las_sharded(
    path: str | Path,
    mesh: Mesh,
    *,
    offset: np.ndarray,
    dtype=torch.float32,
    stride: int = 1,
    max_points: int = 0,
    stats: Optional[dict] = None,
):
    """A LAS cloud row-sharded over ``mesh``, decoding only this process's
    ranks' row blocks.

    ``offset``: the f64 centring offset (the target's; ``header_center``
    of the target's header avoids a decode). ``stride`` keeps every
    stride-th point (icp_registration.cpp:857). ``stats``: on return
    ``stats["peak_rows"]`` / ``["total_rows"]`` hold this process's
    largest single decode and its total rows decoded.

    Returns (shards, weights, n_rows, header): per global rank the rank's
    rows and 0/1 weights on its device (None for other processes' ranks),
    padded to a rank multiple with zero-weight rows; ``n_rows`` real rows.
    """
    path = Path(path)
    hdr = read_header(path)
    n_file = hdr.point_count
    if max_points > 0:
        n_file = min(n_file, max_points)
    n = -(-n_file // stride)  # logical rows after stride
    n_pad = -(-n // mesh.size) * mesh.size
    offset = np.asarray(offset, np.float64)
    npd = _np_dtype(dtype)

    def fetch_rows(lo, hi):
        out = np.zeros((hi - lo, 3), npd)
        hi_real = min(hi, n)
        if hi_real > lo:
            pts, _ = read_las_range(path, lo * stride,
                                    min(hi_real * stride, n_file),
                                    step=stride, header=hdr)
            out[:len(pts)] = (pts - offset).astype(npd)
            if stats is not None:
                stats["peak_rows"] = max(stats.get("peak_rows", 0), len(pts))
                stats["total_rows"] = stats.get("total_rows", 0) + len(pts)
        return out

    def fetch_weight(lo, hi):
        w = np.zeros(hi - lo, npd)
        w[:max(min(hi, n) - lo, 0)] = 1.0
        return w

    src = to_global_rows((n_pad, 3), mesh, fetch_rows, dtype)
    wgt = to_global_rows((n_pad,), mesh, fetch_weight, dtype)
    return src, wgt, n, hdr


def sample_points(
    path: str | Path,
    sample_cap: int = 2_000_000,
    header: Optional[LASHeader] = None,
    chunk: int = 1_000_000,
):
    """A strided xyz sample of a LAS file read in bounded chunks (a range
    read holds its whole byte range before striding). Returns (points
    (S, 3) f64, header) with S ≤ ~``sample_cap``."""
    path = Path(path)
    hdr = header or read_header(path)
    step = max(1, hdr.point_count // sample_cap)
    parts = []
    for lo in range(0, hdr.point_count, chunk):
        pts, _ = read_las_range(path, lo, min(lo + chunk, hdr.point_count),
                                step=step, header=hdr)
        parts.append(pts)
    return (np.concatenate(parts) if parts else np.zeros((0, 3))), hdr


def sample_x_walls(
    path: str | Path,
    n_dev: int,
    sample_cap: int = 2_000_000,
    header: Optional[LASHeader] = None,
):
    """Deterministic x-quantile slab walls from a strided sample of the
    file (every process computes the same walls from the same bytes).
    Returns (walls (n_dev + 1,), header)."""
    pts, hdr = sample_points(path, sample_cap, header=header)
    x = pts[:, 0] if len(pts) else np.zeros(1)
    qs = np.quantile(x, np.linspace(0, 1, n_dev + 1))
    qs[0], qs[-1] = -np.inf, np.inf
    return qs, hdr


def estimate_partition_grid_params(
    path: str | Path,
    walls: np.ndarray,
    halo: float,
    *,
    sample_cap: int = 2_000_000,
    grid_resolution: Optional[int] = None,
    fine_kernel: str = "auto",
    n_queries_hint: Optional[int] = None,
    header: Optional[LASHeader] = None,
    sample: Optional[np.ndarray] = None,
) -> dict:
    """The slabs' grid parameters from a strided file sample, with no
    process holding a slab: the sample's rows in each slab's
    [wall − halo, wall + halo) range, their counts scaled to the file's
    (``populations``), through ``ops.sweep_params.resolve_slab_grid_params``.
    Every process computes the same dict. Returns dict(local_search=
    "pallas", resolution, trange, coarse_trange, fine_kernel,
    normals_resolution) for ``icp_register_partitioned(partition_state=,
    grid_params=)``."""
    from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
        resolve_slab_grid_params,
    )

    if sample is None:
        sample, hdr = sample_points(path, sample_cap, header=header)
    else:
        hdr = header or read_header(path)
    scale = max(hdr.point_count / max(len(sample), 1), 1.0)
    walls = np.asarray(walls, np.float64)
    n_dev = len(walls) - 1
    x = sample[:, 0]
    slabs = []
    for d in range(n_dev):
        sel = sample[(x >= walls[d] - halo) & (x < walls[d + 1] + halo)]
        if len(sel) >= 64:
            slabs.append(sel)
    if not slabs:
        slabs = [sample]
    p = resolve_slab_grid_params(
        slabs, n_dev=n_dev, n_queries=(n_queries_hint or hdr.point_count),
        grid_resolution=grid_resolution, fine_kernel=fine_kernel,
        populations=[max(int(len(s) * scale), 1) for s in slabs])
    return dict(local_search="pallas", **p)


def coarse_carry_from_files(
    src_path: str | Path,
    tgt_path: str | Path,
    *,
    sample_cap: int = 150_000,
    max_iterations: int = 40,
    tolerance: float = 1e-7,
    estimator: str = "plane",
    mode: str = "gui",
    dtype=torch.float32,
    samples: Optional[tuple] = None,
    device=None,
) -> dict:
    """A cold-start pose for a streamed partitioned run: ``icp_register``
    on strided samples of both files (they fit in memory by construction:
    the reference's stride-downsample coarse workflow,
    icp_registration.cpp:852-882), returned as the ``resume_carry`` that
    pre-poses the full run (``partition_state=`` takes no
    ``initial_transform``; ``prev_error`` 1e10 and ``no_improve`` 0
    restart the convergence machine at the coarse pose).

    ``samples`` = (source sample, target sample) already read (strided
    down to ``sample_cap`` here). The estimator defaults to plane whatever
    the fine pass's: a point-to-point coarse pass plateaus ~0.1 m off on
    smooth terrain, which would send the fine pass's rows through the
    collective repair every iteration."""
    from iterativeclosestpoint_tpu_torch.models.icp import icp_register

    if samples is not None:
        s_src, s_tgt = (s[::max(1, len(s) // sample_cap)] for s in samples)
    else:
        s_src, _ = sample_points(src_path, sample_cap)
        s_tgt, _ = sample_points(tgt_path, sample_cap)
    res = icp_register(
        s_src, s_tgt, max_iterations=max_iterations, tolerance=tolerance,
        estimator=estimator, mode=mode, dtype=dtype,
        return_registered=False, device=device)
    return {"transform": np.asarray(res.transform, np.float64),
            "prev_error": 1e10, "no_improve": 0}


def _bucket(path, lo_w, hi_w, mine, batch_size, stride, on_rows):
    """One streamed pass: each batch sorted by x once, every rank's
    [lo, hi) range a binary-searched slice of it (``np.sort`` of the slice
    restores file order); ``on_rows(rank, batch, rows, row0)`` for this
    process's ranks. Returns (per-rank counts, rows read, peak batch)."""
    counts = np.zeros(len(lo_w), np.int64)
    row0 = peak = 0
    for batch in read_las_batches(path, batch_size=batch_size,
                                  stride=stride):
        peak = max(peak, len(batch))
        order = np.argsort(batch[:, 0], kind="stable")
        xs = batch[order, 0]
        lo_ix = np.searchsorted(xs, lo_w)
        hi_ix = np.searchsorted(xs, hi_w)
        counts += hi_ix - lo_ix
        for d in mine:
            on_rows(d, batch, np.sort(order[lo_ix[d]:hi_ix[d]]), row0)
        row0 += len(batch)
    return counts, row0, peak


def load_las_partitioned_target(
    path: str | Path,
    mesh: Mesh,
    *,
    halo: float,
    offset: np.ndarray,
    walls: Optional[np.ndarray] = None,
    dtype=torch.float32,
    batch_size: int = 1_000_000,
    stride: int = 1,
    stats: Optional[dict] = None,
):
    """Stream a LAS target into a ``PartitionState`` keeping only this
    process's ranks' slabs (``[wall − halo, wall + halo)`` in x).

    ``walls`` default: ``sample_x_walls`` of the file. ``stats``: on
    return ``peak_batch_rows``, ``retained_rows`` (this process's slab
    rows) and ``total_rows``. Returns (PartitionState, walls): per global
    rank the slab's rows in the centred frame and their int32 original
    indices on the rank's device (None for other processes' ranks; an
    empty slab holds one far row), no normals (``fill_partition_normals``
    estimates them for plane mode), and every rank's x-limits."""
    path = Path(path)
    n_dev = mesh.size
    if walls is None:
        walls, _ = sample_x_walls(path, n_dev)
    walls = np.asarray(walls, np.float64)
    offset = np.asarray(offset, np.float64)
    npd = _np_dtype(dtype)
    lo_w = walls[:-1] - halo
    hi_w = walls[1:] + halo
    mine = list(mesh.local_ranks)
    pts = {d: [] for d in mine}
    idx = {d: [] for d in mine}

    def keep(d, batch, rows, row0):
        pts[d].append((batch[rows] - offset).astype(npd))
        idx[d].append((rows + row0).astype(np.int32))

    counts, total, peak = _bucket(path, lo_w, hi_w, mine, batch_size,
                                  stride, keep)
    if stats is not None:
        stats["peak_batch_rows"] = peak
        stats["retained_rows"] = int(sum(counts[d] for d in mine))
        stats["total_rows"] = total
    halo_pts, halo_idx = [None] * n_dev, [None] * n_dev
    for d in mine:
        rows = (np.concatenate(pts.pop(d)) if counts[d]
                else np.zeros((0, 3), npd))
        gidx = (np.concatenate(idx.pop(d)) if counts[d]
                else np.zeros(0, np.int32))
        halo_pts[d], halo_idx[d], _ = slab_tensors(
            rows, gidx, mesh.devices[d], dtype)
    part = PartitionState(halo_pts, halo_idx, [None] * n_dev,
                          lo_w - offset[0], hi_w - offset[0])
    return part, walls


def load_las_partitioned_source(
    path: str | Path,
    mesh: Mesh,
    *,
    walls: np.ndarray,
    offset: np.ndarray,
    dtype=torch.float32,
    batch_size: int = 1_000_000,
    stride: int = 1,
    stats: Optional[dict] = None,
):
    """Stream a LAS source sharded by the target's slab ``walls`` (each
    query lands on the rank whose slab certifies it), keeping only this
    process's ranks' shards. ``stats``: ``retained_rows`` and
    ``total_rows``. Returns (shards, weights, n_rows) for
    ``icp_register_partitioned(source_global=)``: per global rank the
    rank's rows in file order and their 0/1 weights on its device (None
    for other processes' ranks), every shard padded to one length."""
    path = Path(path)
    n_dev = mesh.size
    walls = np.asarray(walls, np.float64)
    offset = np.asarray(offset, np.float64)
    npd = _np_dtype(dtype)
    mine = list(mesh.local_ranks)
    kept = {d: [] for d in mine}

    def keep(d, batch, rows, row0):
        kept[d].append((batch[rows] - offset).astype(npd))

    counts, total, _ = _bucket(path, walls[:-1], walls[1:], mine,
                               batch_size, stride, keep)
    if stats is not None:
        stats["retained_rows"] = int(sum(counts[d] for d in mine))
        stats["total_rows"] = total
    m_src = max(-(-int(counts.max()) // 128) * 128, 128)
    src, wgt = [None] * n_dev, [None] * n_dev
    for d in mine:
        buf = np.zeros((m_src, 3), npd)
        c = int(counts[d])
        if c:
            buf[:c] = np.concatenate(kept.pop(d))
            buf[c:] = buf[c - 1]
        w = np.zeros(m_src, npd)
        w[:c] = 1.0
        src[d] = torch.as_tensor(buf, device=mesh.devices[d])
        wgt[d] = torch.as_tensor(w, device=mesh.devices[d])
    return src, wgt, int(counts.sum())
