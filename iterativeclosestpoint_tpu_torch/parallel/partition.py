"""Spatially partitioned target: each rank holds an x-slab and its halo.

Counterpart of the JAX package's ``parallel/partition.py``
(``PartitionState`` :79, ``_slab_selection`` :88, ``build_partition``
:106, ``build_partition_device`` :160, ``_prepare_partitioned`` :232,
``_collective_repair`` :344, ``_partitioned_nn_brute`` :427,
``_partitioned_nn_pallas`` :460, ``_icp_core_partitioned`` :514,
``prepare_partition`` :621, ``icp_register_partitioned`` :748).

The target is cut into x-range slabs at point-count quantiles, each rank
holding its slab plus a halo of width h; the source is x-sorted and split
in equal shards, so almost every query's neighbourhood is local. A local
result is certified exact when its distance is below the query's
distance to the halo's x-limits (strict: a tie at the wall could have its
twin beyond it). Uncertified queries, up to ``repair_budget`` per rank
per pass, are repaired collectively: an ``all_gather`` broadcasts them,
every rank searches its own slab (K3 on the card in f32), and a ``pmin``
over d² then a second ``pmin`` over the winners' ORIGINAL target indices
pick the global first-tie winner; the ``psum`` of the winners' rows
divided by their count only merges halo copies of one and the same target
point, which is exact. The d² compared is each local winner's own, in
the kernels' order (``winner_d2``), so a repaired query gets exactly the
whole target's first minimum. The JAX package compares the square of the
rounded distance (``ld * ld``, :384), which can merge two different d²
whose square roots round alike, and then hands the tie to the lower
index, the farther point when its d² is the larger. Every gate in front
of a collective reads the ``pmax`` of the bad counts, so all ranks take
the same branch.

The JAX package pads every device's slab to one length with ``_FAR`` rows
(``shard_map`` needs one shape) and its grid builders and normals mask
them (``mask_far``). Here a rank's slab is a tensor of its own length
(ragged), so nothing needs masking and ``mask_far`` is left out: each
rank's slab grid equals the JAX per-slab grid on the real rows. An empty
slab holds one far row with index 2³¹−1, which no real row loses to.

Local search (``local_search``): "brute" (exact brute force over the
slab: K3 in f32 on the card, the plain version on the CPU and in f64),
"pallas" (the single-device exact chain over a per-rank slab grid built
on the rank's device: K1/K2 sweeps, coarse repair, budgeted K3; its
uncertified rows join the margin failures in the collective repair), or
"auto" (pallas on the card in f32 for slabs past 131,072 rows, brute
otherwise).

The streamed ingest (``parallel.ingest``: ``load_las_partitioned_target``
and ``_source``) hands in ``partition_state``, ``source_global`` and
``offset`` instead of clouds, and ``grid_params`` (sampled from the file)
for the per-slab sweep chain; ``fill_partition_normals`` estimates plane
normals on each rank's own slab (:306-342). On a mesh over several
processes (``parallel.mesh.init_multihost``) every step builds only this
process's ranks' slabs, shards and grids.

Left out: the ≥2M auto-segmentation, as on the other paths.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.models.icp import (
    ICPResult,
    _compose_callback,
    _resume_state,
    _run_segmented,
    package_result,
)
from iterativeclosestpoint_tpu_torch.ops.bruteforce import sqrt_rn, winner_d2
from iterativeclosestpoint_tpu_torch.ops.cellblock import auto_resolution_data
from iterativeclosestpoint_tpu_torch.ops.normals import (
    estimate_normals_cellpca_device,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    build_grid,
    build_zgrid,
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import nn_exact
from iterativeclosestpoint_tpu_torch.ops.sweep_nn import nn_colsweep_exact
from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
    resolve_slab_grid_params,
)
from iterativeclosestpoint_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    to_global,
)
from iterativeclosestpoint_tpu_torch.parallel.sharded import (
    compose_initial,
    per_device,
    run_loop,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import stage
from iterativeclosestpoint_tpu_torch.utils import hostmath
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device

_FAR = 1.0e6
_IMAX = 2**31 - 1


def _coarse_params(resolution: int, coarse_trange: int = 0):
    """The coarse repair grid's (resolution, trange)."""
    return max(resolution // 4, 8), coarse_trange or 16384


class PartitionState(NamedTuple):
    """Per-rank slab buffers (ragged: each rank's own length), indexed by
    global rank; None for the ranks of other processes."""

    halo_pts: list    # rank → (m_r, 3) slab + halo rows, on its device
    halo_idx: list    # rank → (m_r,) int32 original target index
    halo_nrm: list    # rank → (m_r, 3) normals (plane mode) or None
    x_lo: np.ndarray  # (D,) halo lower x-limit per rank
    x_hi: np.ndarray  # (D,) halo upper x-limit per rank


# ``icp_register`` options with no partitioned counterpart: the local
# search stands for ``nn_backend``, and the slab grids size their own cells.
_SINGLE_DEVICE_ONLY = ("nn_backend", "cell_capacity")


def partitioned_kwargs(kwargs: dict) -> dict:
    """``icp_register``'s keyword arguments as ``icp_register_partitioned``
    takes them: ``nn_backend`` ("auto", "pallas" or "bruteforce") becomes
    ``local_search`` unless that is given, ``cell_capacity`` goes, and
    every other key passes unchanged."""
    pk = {k: v for k, v in kwargs.items() if k not in _SINGLE_DEVICE_ONLY}
    if "local_search" not in pk:
        nn_backend = kwargs.get("nn_backend") or "auto"
        ls = {"auto": "auto", "pallas": "pallas",
              "bruteforce": "brute"}.get(nn_backend)
        if ls is None:
            raise ValueError(
                f"nn_backend={nn_backend!r} has no partitioned equivalent "
                "(use 'auto', 'pallas' or 'bruteforce')")
        pk["local_search"] = ls
    return pk


def _slab_selection(target: np.ndarray, n_dev: int, halo: float):
    """Host-side slab row selection: x-quantile walls ± halo."""
    qs = np.quantile(target[:, 0], np.linspace(0, 1, n_dev + 1))
    qs[0], qs[-1] = -np.inf, np.inf
    sels = []
    los = np.empty(n_dev)
    his = np.empty(n_dev)
    for d in range(n_dev):
        lo = qs[d] - halo
        hi = qs[d + 1] + halo
        sels.append(np.nonzero((target[:, 0] >= lo) & (target[:, 0] < hi))[0])
        los[d] = lo
        his[d] = hi
    return sels, los, his


def slab_tensors(rows: np.ndarray, gidx: np.ndarray, device, dtype,
                 normals: "np.ndarray | None" = None):
    """One rank's slab on its device: (points, int32 original indices,
    normals or None). An empty slab holds one far row with index 2³¹−1,
    which no real row loses to."""
    if not len(rows):
        rows = np.full((1, 3), _FAR)
        gidx = np.array([_IMAX], np.int32)
        normals = None if normals is None else np.zeros((1, 3))
    return (torch.as_tensor(rows, dtype=dtype, device=device),
            torch.as_tensor(gidx.astype(np.int32), device=device),
            None if normals is None
            else torch.as_tensor(normals, dtype=dtype, device=device))


def build_partition(target: np.ndarray, devices, halo: float,
                    dtype=torch.float32, normals: "np.ndarray | None" = None,
                    sels=None, los=None, his=None) -> PartitionState:
    """Host build: each rank's slab cut on the host and uploaded to its
    device (``devices``: one per rank; None skips a rank of another
    process)."""
    target = np.asarray(target)
    if sels is None:
        sels, los, his = _slab_selection(target, len(devices), halo)
    pts, idx, nrm = [], [], []
    for s, dev in zip(sels, devices):
        if dev is None:
            pts.append(None)
            idx.append(None)
            nrm.append(None)
            continue
        p, i, n = slab_tensors(target[s], s, dev, dtype,
                               None if normals is None else normals[s])
        pts.append(p)
        idx.append(i)
        nrm.append(n)
    return PartitionState(pts, idx, nrm, np.asarray(los), np.asarray(his))


def _target_normals(tgt_dev: torch.Tensor, target: np.ndarray):
    """Cell-PCA normals of the whole target on its device (the JAX
    package's resolution and cell: ``auto_resolution_data`` over the
    target's longest extent)."""
    r0 = auto_resolution_data(target)
    tmin = target.min(axis=0)
    ext0 = float((target.max(axis=0) - tmin).max()) or 1.0
    dev = tgt_dev.device
    return estimate_normals_cellpca_device(
        tgt_dev, torch.as_tensor(tmin, dtype=torch.float32, device=dev),
        torch.tensor(max(ext0 / r0, 1e-9), dtype=torch.float32, device=dev),
        resolution=r0)


def build_partition_device(target: np.ndarray, mesh: Mesh, halo: float,
                           with_normals: bool = False, sels=None, los=None,
                           his=None) -> PartitionState:
    """Device build (f32): the target uploaded once per distinct device of
    this process's ranks, each rank's slab (and its normals, estimated
    once per device over the whole target) gathered there by row index."""
    target = np.asarray(target)
    n = len(target)
    if sels is None:
        sels, los, his = _slab_selection(target, mesh.size, halo)
    full: dict = {}
    pts, idx, nrm = [], [], []
    for r, (s, dev) in enumerate(zip(sels, mesh.devices)):
        if not mesh.is_local(r):
            pts.append(None)
            idx.append(None)
            nrm.append(None)
            continue
        if dev not in full:
            t = torch.as_tensor(target, dtype=torch.float32, device=dev)
            nr = _target_normals(t, target) if with_normals else None
            # One far row appended: an empty slab reads it.
            full[dev] = (
                torch.cat([t, t.new_full((1, 3), _FAR)]),
                None if nr is None else torch.cat([nr, nr.new_zeros(1, 3)]))
        t_pad, n_pad = full[dev]
        rows = torch.as_tensor(s if len(s) else np.array([n]), device=dev)
        pts.append(t_pad[rows])
        idx.append(torch.where(rows < n, rows, _IMAX).to(torch.int32))
        nrm.append(None if n_pad is None else n_pad[rows])
    return PartitionState(pts, idx, nrm, np.asarray(los), np.asarray(his))


def fill_partition_normals(part: PartitionState, *,
                           resolution: int = 64) -> PartitionState:
    """Per-slab cell-PCA normals for an ingested ``PartitionState`` (plane
    mode; the loader leaves ``halo_nrm`` empty). Each of this process's
    ranks estimates them from its own slab (the slab and its halo cover
    every real row's neighbourhood within the halo width), on a grid over
    the slab's own bounding box: another grid than the whole target's, so
    near cell boundaries the normals differ from the non-ingest build's
    (JAX ``partition.py:306-342``). The slabs hold real rows only, so no
    far rows are masked."""
    nrm = []
    for r, halo in enumerate(part.halo_pts):
        if halo is None:
            nrm.append(None)
            continue
        h = halo.to(torch.float32)
        lo3 = h.amin(dim=0)
        cell = torch.clamp((h.amax(dim=0) - lo3).max() / resolution,
                           min=1e-9)
        nrm.append(estimate_normals_cellpca_device(
            h, lo3, cell, resolution=resolution).to(halo.dtype))
    return part._replace(halo_nrm=nrm)


def collective_repair(comm, query, m6, dist, certified, halo, gidx, nrm, *,
                      repair_budget: int, repair_passes: int,
                      with_normals: bool):
    """Budgeted multi-pass halo-exchange repair of the rows not
    ``certified``, with the first-tie combine over original target
    indices. Every rank calls it with its own rows; the gates read the
    ``pmax`` of the bad counts. Tallies ``repair_queries`` (this rank's
    uncertified rows) and ``repair_passes``."""
    f = query.dtype
    n = query.shape[0]
    n_bad = (~certified).sum(dtype=torch.int32)
    n_bad_max = comm.pmax(n_bad)
    nb_max, nb = torch.stack([n_bad_max, n_bad]).tolist()  # host read
    comm.tally["repair_queries"] += nb
    if nb_max == 0:
        return m6, dist
    K = min(repair_budget, n)
    perm = torch.argsort(certified.to(torch.int32), stable=True)
    ar = torch.arange(K, device=query.device)
    for p in range(repair_passes):
        if nb_max <= p * K:
            break
        # The last window is clamped to the rows' end; the live mask
        # follows the clamped start. (The JAX package's mask keeps the
        # unclamped p·K, partition.py:374-376, and so skips the last
        # n − p·K bad rows whenever the clamp moves the window; its own
        # brute tiers in nn_colsweep_exact use the clamped start.)
        start = min(p * K, n - K)
        rows = perm[start:start + K]
        live = (start + ar) < n_bad
        q_all = torch.cat(comm.all_gather(query[rows].contiguous()))
        li, _ = nn_exact(q_all, halo)
        gi = gidx[li]
        ld2 = winner_d2(q_all, halo, li)
        gd2 = comm.pmin(ld2)
        isw = ld2 <= gd2
        gi_min = comm.pmin(torch.where(isw, gi, torch.full_like(gi, _IMAX)))
        win = (isw & (gi == gi_min)).to(f)
        wins = comm.psum(win)
        lm = halo[li]
        lm6 = torch.cat([lm, nrm[li].to(f) if with_normals
                         else torch.zeros_like(lm)], dim=1)
        gm6 = comm.psum(lm6 * win[:, None]) / torch.clamp(wins, min=1.0)[
            :, None]
        gd = sqrt_rn(torch.clamp(gd2, min=0.0))
        seg = slice(comm.rank * K, (comm.rank + 1) * K)
        m6[rows] = torch.where(live[:, None], gm6[seg], m6[rows])
        dist[rows] = torch.where(live, gd[seg], dist[rows])
        comm.tally["repair_passes"] += 1
    return m6, dist


def _partitioned_nn(comm, state, *, local_search: str, with_normals: bool,
                    repair_budget: int, repair_passes: int, **chain):
    """A rank's nn_fn: the local search over its slab, the halo-margin
    certificate and the collective repair."""
    halo, gidx, nrm, x_lo, x_hi, grid, cgrid = state

    def nn(query, target, nn_state):
        del target, nn_state
        if local_search == "pallas":
            m3, knrm, dist, cert = nn_colsweep_exact(
                query, halo, grid, cgrid, nrm if with_normals else None,
                global_fallback=False, return_certified=True, **chain)
            m6 = torch.cat([m3, knrm], dim=1)
        else:
            idx, dist = nn_exact(query, halo)
            m6 = torch.cat([halo[idx], nrm[idx].to(query.dtype)
                            if with_normals else torch.zeros_like(query)],
                           dim=1)
            cert = None
        margin = torch.minimum(query[:, 0] - x_lo, x_hi - query[:, 0])
        certified = dist < margin
        if cert is not None:
            certified = cert & (dist.to(torch.float32) < margin)
        m6, dist = collective_repair(
            comm, query, m6, dist, certified, halo, gidx, nrm,
            repair_budget=repair_budget, repair_passes=repair_passes,
            with_normals=with_normals)
        if with_normals:
            return m6[:, 0:3], dist, m6[:, 3:6]
        return m6[:, 0:3], dist

    return nn


def _slab_grids(halo, nrm, *, resolution: int, trange: int,
                coarse_trange: int, fine_kernel: str):
    """A rank's fine and coarse slab grids on its own slab's bbox (the
    JAX ``_prepare_partitioned``'s per-device build; no far rows to
    mask). Returns (grid, coarse grid, origin, fine cell)."""
    coarse_resolution, coarse_trange = _coarse_params(resolution,
                                                      coarse_trange)
    h = halo.to(torch.float32)
    lo3 = h.amin(dim=0)
    ext = h.amax(dim=0) - lo3
    if fine_kernel == "zcol":
        # Anisotropic cells: an x-thin slab keeps its x resolution.
        cell = torch.clamp(ext / resolution, min=1e-9)
        grid = build_zgrid(h, lo3, cell, resolution=resolution,
                           zrange=trange, normals=nrm)
    else:
        cell = torch.clamp(ext.max() / resolution, min=1e-9)
        grid = build_grid(h, lo3, cell, resolution=resolution,
                          trange=trange, normals=nrm)
    cell_c = torch.clamp(ext.max() / coarse_resolution, min=1e-9)
    cgrid = build_grid(h, lo3, cell_c, resolution=coarse_resolution,
                       trange=coarse_trange, normals=nrm)
    return grid, cgrid, lo3, cell


def prepare_partition(
    target,
    *,
    mesh: Optional[Mesh] = None,
    halo: Optional[float] = None,
    dtype=torch.float32,
    center: bool = True,
    estimator: str = "point",
    local_search: str = "auto",
    partition_build: str = "auto",
    fine_kernel: str = "auto",
    grid_resolution: Optional[int] = None,
    n_queries_hint: Optional[int] = None,
    device=None,
) -> dict:
    """Pose-invariant per-target prep of ``icp_register_partitioned``:
    the centring offset, the slabs (with normals in plane mode), the
    resolved local search and its grid parameters. Reusable by every
    registration onto this target (``register_scans`` caches it per
    target scan). ``partition_build`` "auto" is the device build on the
    card in f32, the host build otherwise."""
    if mesh is None:
        mesh = make_mesh(device=device)
    if estimator not in ("point", "plane"):
        raise ValueError(f"unknown estimator {estimator!r}")
    for d in mesh.local_devices:
        resolve_device(d)
    n_dev = mesh.size
    target = np.asarray(target, np.float64)
    offset = hostmath.center_offset(target) if center else np.zeros(3)
    tgt_local = target - offset
    if halo is None:
        halo = 0.02 * float((tgt_local.max(0) - tgt_local.min(0)).max())
    f32 = dtype == torch.float32
    on_card = mesh.local_devices[0].type == "cuda"
    with_normals = estimator == "plane"
    if partition_build == "auto":
        use_device_build = on_card and f32
    elif partition_build in ("device", "host"):
        use_device_build = partition_build == "device"
    else:
        raise ValueError(f"unknown partition_build {partition_build!r}")

    sels, los, his = _slab_selection(tgt_local, n_dev, halo)
    m_loc = -(-max(len(s) for s in sels) // 128) * 128
    if use_device_build:
        part = build_partition_device(tgt_local, mesh, halo, with_normals,
                                      sels=sels, los=los, his=his)
    else:
        normals = None
        if with_normals:
            t = torch.as_tensor(tgt_local, dtype=torch.float32,
                                device=mesh.local_devices[0])
            normals = _target_normals(t, tgt_local).cpu().numpy()
        part = build_partition(
            tgt_local, [d if mesh.is_local(r) else None
                        for r, d in enumerate(mesh.devices)],
            halo, dtype=dtype, normals=normals, sels=sels, los=los, his=his)

    if local_search == "auto":
        local_search = ("pallas" if on_card and f32 and m_loc > 131072
                        else "brute")
    if local_search not in ("brute", "pallas"):
        raise ValueError(f"unknown local_search {local_search!r}")
    resolution = trange = coarse_trange = 0
    if local_search == "pallas":
        p = resolve_slab_grid_params(
            [tgt_local[s] for s in sels if len(s)], n_dev=n_dev,
            n_queries=(n_queries_hint or len(target)),
            grid_resolution=grid_resolution, fine_kernel=fine_kernel)
        resolution, trange = p["resolution"], p["trange"]
        coarse_trange, fine_kernel = p["coarse_trange"], p["fine_kernel"]
    else:
        fine_kernel = "sweep"
    return dict(
        mesh=mesh, offset=offset, halo=float(halo), part=part, m_loc=m_loc,
        local_search=local_search, resolution=resolution, trange=trange,
        coarse_trange=coarse_trange, fine_kernel=fine_kernel,
        with_normals=with_normals, dtype=dtype)


def icp_register_partitioned(
    source,
    target,
    *,
    mesh: Optional[Mesh] = None,
    halo: Optional[float] = None,
    repair_budget: int = 1024,
    repair_passes: int = 4,
    max_iterations: int = 50,
    tolerance: float = 1e-6,
    sigma_multiplier: float = 3.0,
    mode: str = "gui",
    estimator: str = "point",
    robust: str = "none",
    local_search: str = "auto",
    partition_build: str = "auto",
    fine_kernel: str = "auto",
    grid_resolution: Optional[int] = None,
    dtype=torch.float32,
    center: bool = True,
    return_registered: bool = True,
    initial_transform: Optional[np.ndarray] = None,
    segment_iterations: int = 0,
    progress_callback: Optional[Callable] = None,
    stop_event=None,
    segment_callback: Optional[Callable] = None,
    resume_carry=None,
    partition_state=None,
    source_global=None,
    offset=None,
    prepared_partition: Optional[dict] = None,
    grid_params: Optional[dict] = None,
    device=None,
) -> ICPResult:
    """ICP with the target split into x-slabs over ``mesh`` (default
    ``make_mesh(device=device)``), ``icp_register``'s surface otherwise.

    ``prepared_partition`` (from ``prepare_partition``) reuses a target's
    slabs; ``halo``, ``local_search``, ``partition_build``,
    ``fine_kernel`` and ``grid_resolution`` are then those it was built
    with. ``halo`` defaults to 2% of the target's extent: widen it, or
    pass a coarse ``initial_transform``, for badly misaligned pairs.
    ``resume_carry`` continues bit for bit, as on the other paths (the
    slabs, grids and layout are pose-invariant).

    ``partition_state`` + ``source_global`` + ``offset``: the streamed
    ingest's inputs (``parallel.ingest.load_las_partitioned_target`` and
    ``_source``), where no process holds a whole cloud; ``source`` and
    ``target`` are ignored (pass None) and ``return_registered=False`` is
    required (the wall-sharded rows have no global order back to the
    file's). ``grid_params`` (``parallel.ingest.
    estimate_partition_grid_params``) turns on the per-slab sweep chain
    (K1, K2, K3; f32); without it "auto" is the per-slab brute search.
    Plane mode estimates each slab's normals (``fill_partition_normals``)
    at ``grid_resolution``, else the sampled normals resolution.
    """
    if estimator not in ("point", "plane"):
        raise ValueError(f"unknown estimator {estimator!r}")
    if robust not in ("none", "huber", "tukey"):
        raise ValueError(f"unknown robust mode {robust!r}")
    if mesh is None:
        mesh = (prepared_partition["mesh"] if prepared_partition is not None
                else make_mesh(device=device))
    n_dev = mesh.size
    dev0 = mesh.local_devices[0]
    with_normals = estimator == "plane"
    T_init = perm_t = None
    if partition_state is not None:
        if source_global is None or offset is None:
            raise ValueError(
                "partition_state requires source_global and offset "
                "(parallel.ingest.load_las_partitioned_* provide them)")
        if initial_transform is not None:
            raise ValueError(
                "partition_state with initial_transform is not supported "
                "(resume through resume_carry instead)")
        if return_registered:
            raise ValueError(
                "partition_state requires return_registered=False (the "
                "wall-sharded order has no global inverse permutation)")
        offset = np.asarray(offset, np.float64)
        n_orig = int(source_global[2])
        part = partition_state
        gp = grid_params or {}
        if with_normals:
            part = fill_partition_normals(
                part, resolution=(grid_resolution
                                  or gp.get("normals_resolution")
                                  or gp.get("resolution") or 64))
        if grid_params is not None and local_search in ("auto", "pallas"):
            ls = "pallas"
            params = {k: grid_params[k] for k in (
                "resolution", "trange", "coarse_trange", "fine_kernel")}
        else:
            ls = "brute" if local_search == "auto" else local_search
            if ls != "brute":
                raise ValueError(
                    "partition_state with local_search='pallas' needs "
                    "grid_params (parallel.ingest."
                    "estimate_partition_grid_params: per-slab grid "
                    "parameters from the strided file sample)")
            params = dict(resolution=0, trange=0, coarse_trange=0,
                          fine_kernel="sweep")
        shards = [None if x is None else x.to(mesh.devices[r], dtype)
                  for r, x in enumerate(source_global[0])]
        weights = [None if x is None else x.to(mesh.devices[r], dtype)
                   for r, x in enumerate(source_global[1])]
    else:
        source = np.asarray(source, np.float64)
        n_orig = len(source)
        if initial_transform is not None:
            if resume_carry is not None:
                raise ValueError(
                    "initial_transform and resume_carry are mutually "
                    "exclusive")
            T_init = np.asarray(initial_transform, np.float64)
            source = source @ T_init[:3, :3].T + T_init[:3, 3]
        pp = prepared_partition
        if pp is None:
            with stage("partition_prep"):
                pp = prepare_partition(
                    target, mesh=mesh, halo=halo, dtype=dtype, center=center,
                    estimator=estimator, local_search=local_search,
                    partition_build=partition_build,
                    fine_kernel=fine_kernel, grid_resolution=grid_resolution,
                    n_queries_hint=n_orig)
        if pp["with_normals"] != with_normals:
            raise ValueError(
                f"prepared_partition was built with with_normals="
                f"{pp['with_normals']} but estimator={estimator!r}; rebuild "
                "the partition to match")
        if pp["dtype"] != dtype:
            raise ValueError(
                f"prepared_partition was built with dtype={pp['dtype']} but "
                f"this run asks for {dtype}; rebuild the partition to match")
        if pp["mesh"] is not mesh and pp["mesh"].devices != mesh.devices:
            raise ValueError("prepared_partition was built on another mesh")
        offset = pp["offset"]
        part = pp["part"]
        ls = pp["local_search"]
        params = {k: pp[k] for k in (
            "resolution", "trange", "coarse_trange", "fine_kernel")}

        # Sort the source by x so the equal shards line up with the
        # target's x-quantile slabs; the halo and the collective repair
        # absorb the rest. A stable sort of the f64 x on this process's
        # first device: the order of numpy's stable argsort (a 10M host
        # sort takes seconds), then zero-weight rows up to a rank
        # multiple.
        with stage("host_prep"):
            src_local = source - offset
        with stage("upload") as done:
            perm_t = torch.sort(torch.as_tensor(src_local[:, 0], device=dev0),
                                stable=True).indices
            src_sorted = torch.as_tensor(src_local, dtype=dtype,
                                         device=dev0)[perm_t]
            done(src_sorted)
        n_pad = -(-n_orig // n_dev) * n_dev
        w_all = torch.ones(n_pad, dtype=dtype, device=dev0)
        if n_pad > n_orig:
            src_sorted = torch.cat([src_sorted,
                                    src_sorted.new_zeros(n_pad - n_orig, 3)])
            w_all[n_orig:] = 0.0
        shards = to_global(src_sorted, mesh)
        weights = to_global(w_all, mesh)

    chain = {}
    runs, run_w = shards, weights
    grids = [(None, None)] * n_dev
    if ls == "pallas":
        resolution = params["resolution"]
        coarse_resolution, coarse_trange = _coarse_params(
            resolution, params["coarse_trange"])
        chain = dict(resolution=resolution,
                     coarse_resolution=coarse_resolution,
                     trange=params["trange"], coarse_trange=coarse_trange,
                     slabs=4, tile_q=128, fine=params["fine_kernel"])

        def prep(comm):
            # Pose-invariant per-rank prep: the slab grids and the
            # group-aligned layout of the rank's shard.
            r = comm.rank
            grid, cgrid, lo3, cell = _slab_grids(
                part.halo_pts[r], part.halo_nrm[r], resolution=resolution,
                trange=params["trange"],
                coarse_trange=params["coarse_trange"],
                fine_kernel=params["fine_kernel"])
            rows, lw = grouped_tile_order_device(
                shards[r], lo3, cell, resolution=resolution, tile_q=128,
                group="xy" if params["fine_kernel"] == "zcol" else "x")
            return grid, cgrid, shards[r][rows], weights[r][rows] * lw.to(
                dtype)

        with stage("slab_grids") as done:
            prepped = mesh.run(prep)
            done([p for p in prepped if p is not None])
        grids = [(None, None) if p is None else p[:2] for p in prepped]
        runs = [None if p is None else p[2] for p in prepped]
        run_w = [None if p is None else p[3] for p in prepped]

    states = [
        (part.halo_pts[r], part.halo_idx[r], part.halo_nrm[r],
         torch.tensor(part.x_lo[r], dtype=dtype, device=d),
         torch.tensor(part.x_hi[r], dtype=dtype, device=d), *grids[r])
        if mesh.is_local(r) else None
        for r, d in enumerate(mesh.devices)
    ]

    def nn_fns(comm):
        return _partitioned_nn(
            comm, states[comm.rank], local_search=ls,
            with_normals=with_normals, repair_budget=repair_budget,
            repair_passes=repair_passes, **chain)

    nn_fns.per_rank = True
    dummy = per_device(mesh, torch.zeros((1, 3), dtype=dtype))

    if T_init is not None:
        progress_callback = _compose_callback(progress_callback, T_init)
        segment_callback = _compose_callback(segment_callback, T_init)
    carry = None
    widen = mode == "gui"
    if resume_carry is not None:
        carry = _resume_state(resume_carry, offset, dtype, dev0)
        widen = False

    def dispatch(carry_, n_iter, widen_):
        return run_loop(
            mesh, runs, run_w, dummy, [()] * n_dev, nn_fns=nn_fns,
            carry=carry_, max_iterations=n_iter, widen_first=widen_,
            return_registered=return_registered, registered_from=shards,
            tolerance=tolerance, sigma_multiplier=sigma_multiplier,
            estimator=estimator, robust=robust)

    with stage("loop") as done:
        if segment_iterations and segment_iterations > 0:
            out = _run_segmented(
                dispatch, offset, max_iterations=max_iterations,
                segment_iterations=segment_iterations, widen_first=widen,
                progress_callback=progress_callback, stop_event=stop_event,
                carry_init=carry, segment_callback=segment_callback)
        else:
            out = dispatch(carry, max_iterations, widen)
        done(out["T_cum"])
    if return_registered:
        out["src"] = out["src"][:n_orig]
    res = package_result(out, offset, return_registered)
    res.nn_resolution = params["resolution"] or None
    if res.source_registered is not None:
        unperm = np.empty_like(res.source_registered)
        unperm[perm_t.cpu().numpy()] = res.source_registered
        res.source_registered = unperm
    if T_init is not None:
        res = compose_initial(res, T_init)
    return res
