"""Host-side parameter estimators of the slab sweep (numpy).

Copies of the estimators in the JAX package's ``ops/pallas_nn.py``:
``auto_trange`` :207, ``auto_coarse_trange`` :301, ``auto_zrange`` :336,
``estimate_grid_params`` :693, ``resolve_slab_grid_params`` :604 (the
partitioned target's shared per-slab parameters) and ``use_fused_sweep``
:998. Both packages
must pick the same resolution R, slab row budget ``trange`` and coarse
budget ``coarse_trange`` from the same cloud, so the arithmetic, the
ladders and the caps are kept exactly, including ``_COARSE_TRANGE_CAP``:
on the TPU it was a compile bound, here it only keeps the two packages on
the same budgets.

Not copied: ``fused_sweep_chunk`` (:1010) sizes the TPU kernel's VMEM
chunks, which the CUDA kernels do not have; ``_ranges`` (:185) serves only
the host query layout, which the port builds on the device.
"""

from __future__ import annotations

import numpy as np

from iterativeclosestpoint_tpu_torch.ops.cellblock import (
    _occupancy_model,
    auto_resolution_data,
    surface_boost_ok,
)
from iterativeclosestpoint_tpu_torch.utils.hostmath import bbox

# trange is quantized UP onto this ladder (more certification margin).
_TRANGE_LADDER = (768, 1024, 1536, 2048, 3072, 4096, 6144, 8192)

# auto_trange estimates its column-count distribution from at most this many
# points (strided subsample above it).
_AUTO_TRANGE_SAMPLE_CAP = 2_000_000

_COARSE_TRANGE_CAP = 16384

_ZRANGE_LADDER = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def auto_trange(
    target: np.ndarray,
    resolution: int,
    y_window: int = 4,
    floor: int = 768,
    cap: int = 8192,
    population: "int | None" = None,
    tile_q: int = 128,
) -> int:
    """Data-adaptive slab range (rows per slab).

    A slab holds the rows of one x-cell over the tile's dilated y-span and
    the full z column; rows beyond ``trange`` decertify the tile into the
    repair path. The budget is the mass-weighted p99.9 of the (x, w
    consecutive y) column-count sums with a 4/3 margin for mid-loop layout
    aging, where w is the occupancy-derived tile y-span plus 3, quantized
    up onto ``_TRANGE_LADDER``. ``population`` scales a strided sample up
    to the true point count.
    """
    target = np.asarray(target)
    R = resolution
    tmin, tmax = bbox(target)
    extent = float((tmax - tmin).max()) or 1.0
    cell = max(extent / R, 1e-9)
    pop_scale = (
        1.0 if population is None else population / max(len(target), 1)
    )
    stride = max(1, len(target) // _AUTO_TRANGE_SAMPLE_CAP)
    sampled = target[::stride, :2]
    c = np.clip(((sampled - tmin[:2]) / cell).astype(np.int64),
                0, R - 1)
    counts = np.bincount(c[:, 0] * R + c[:, 1], minlength=R * R) * stride
    if pop_scale != 1.0:
        counts = (counts * pop_scale).astype(np.int64)
    counts = counts.reshape(R, R)
    cs = np.concatenate(
        [np.zeros((R, 1), np.int64), np.cumsum(counts, axis=1)], axis=1
    )
    occ_cells = max(int((counts > 0).sum()), 1)
    occ = max(pop_scale * len(sampled) * stride / occ_cells, 1.0)
    span = int(np.ceil(tile_q / occ))
    w = max(min(max(y_window, span + 3), R), 1)
    win = (cs[:, w:] - cs[:, :-w]).reshape(-1)
    mass = win.astype(np.float64)
    total = mass.sum()
    if total <= 0:
        return floor
    order = np.argsort(win)
    cdf = np.cumsum(mass[order]) / total
    p999 = int(win[order][np.searchsorted(cdf, 0.999)])
    tr = int(np.clip(int(p999 * 4 / 3), floor, cap))
    for step in _TRANGE_LADDER:
        if tr <= step:
            return step
    return cap


def auto_coarse_trange(target, resolution, *, population=None):
    """Row budget for the 4×-coarser repair grid: ``auto_trange`` at the
    coarse resolution plus ONE ladder notch of drift margin (aged repair
    tiles are wider than the p99.9), capped at ``_COARSE_TRANGE_CAP``."""
    tr = auto_trange(target, max(resolution // 4, 8),
                     population=population)
    for step in _TRANGE_LADDER:
        if step > tr:
            return min(step, _COARSE_TRANGE_CAP)
    # auto_trange saturated the ladder top: the notch still exists.
    return min(2 * tr, _COARSE_TRANGE_CAP)


def auto_zrange(
    target: np.ndarray,
    resolution: int,
    tile_q: int = 128,
    floor: int = 256,
    cap: int = 4096,
    population: "int | None" = None,
) -> int:
    """Z-window row budget of the volume regime's column sweep: the
    z-axis analog of ``auto_trange`` on anisotropic (per-axis extent/R)
    cells: the z-column sweep's ``zrange``, and an input of the
    kernel-regime gate of ``estimate_grid_params``."""
    target = np.asarray(target)
    R = resolution
    tmin, tmax = bbox(target)
    cell = np.maximum((tmax - tmin) / R, 1e-9)
    pop = population if population is not None else len(target)
    pop_scale = pop / max(len(target), 1)
    stride = max(1, len(target) // _AUTO_TRANGE_SAMPLE_CAP)
    sampled = target[::stride]
    c = np.clip(((sampled - tmin) / cell).astype(np.int64), 0, R - 1)
    cid = (c[:, 0] * R + c[:, 1]) * R + c[:, 2]
    counts = (np.bincount(cid, minlength=R**3) * stride).reshape(R * R, R)
    if pop_scale != 1.0:
        counts = (counts * pop_scale).astype(np.int64)
    occ_cells = max(int((counts > 0).sum()), 1)
    occ = max(pop / occ_cells, 1.0)   # points per occupied cell
    span = int(np.ceil(tile_q / occ))          # expected tile z-span
    z_window = span + 4                        # ±1 dilation + aging margin
    cs = np.concatenate(
        [np.zeros((R * R, 1), np.int64), np.cumsum(counts, axis=1)], axis=1
    )
    w = max(min(z_window, R), 1)
    win = (cs[:, w:] - cs[:, :-w]).reshape(-1)
    mass = win.astype(np.float64)
    total = mass.sum()
    if total <= 0:
        return floor
    order = np.argsort(win)
    cdf = np.cumsum(mass[order]) / total
    p999 = int(win[order][np.searchsorted(cdf, 0.999)])
    zr = int(np.clip(int(p999 * 4 / 3), floor, cap))
    for step in _ZRANGE_LADDER:
        if zr <= step:
            return step
    return cap


def estimate_grid_params(target_local, resolution=None, model=None):
    """Returns (resolution, trange, coarse_trange, normals_resolution,
    zrange). ``model`` reuses a precomputed ``_occupancy_model`` of the
    cloud.

    ``resolution`` carries the surface boost (one pow-2 notch finer on
    surface clouds); ``normals_resolution`` is the unboosted base. The
    boost is refused when the base parameters land in the z-column
    regime (base trange ≥ 2048 at base R ≤ 128) and that regime's cost
    model (12 slots × zrange against slabs × trange, with the (x,y)-group
    padding) wins; ``zrange`` is then returned, else None.
    """
    target_local = np.asarray(target_local)
    zrange = None
    if resolution is not None:
        R = base = resolution
        tr = auto_trange(target_local, R)
    else:
        if model is None:
            model = _occupancy_model(target_local)
        R, base = auto_resolution_data(
            target_local, surface_boost_occupancy=32, return_base=True,
            model=model,
        )
        tr_base = auto_trange(target_local, base)
        tr = tr_base
        boosted = R != base
        if tr_base >= 2048 and base <= 128:
            boosted = False
            R = base
            zrange = auto_zrange(target_local, base)
            pad = 1.0 + (base**2 * (128 - 1) / 2) / max(
                len(target_local), 1
            )
            if not (12 * zrange * pad < 0.7 * 4 * tr_base):
                # The column sweep loses its own cost model: a sweep cloud
                # after all, and the boost gets its normal chance.
                boosted = surface_boost_ok(
                    target_local, 2 * base, model=model
                )
                R = 2 * base if boosted else base
        if boosted:
            tr = auto_trange(target_local, R)
    return (R, tr, auto_coarse_trange(target_local, R), base, zrange)


def resolve_slab_grid_params(
    slab_samples,
    *,
    n_dev: int,
    n_queries: int,
    grid_resolution: "int | None" = None,
    fine_kernel: str = "auto",
    populations=None,
):
    """Shared grid parameters of the partitioned target's slabs.

    Every rank's slab grid uses one (resolution, trange, coarse_trange,
    fine kernel): per-slab estimates combined by max, trange quantized up
    onto the ladder, the z-column cost-model gate at the unboosted base
    (with the per-rank (x, y)-layout padding), and the surface boost only
    when EVERY slab's own occupancy at the boosted R clears the gate.
    ``populations`` carries true per-slab counts when ``slab_samples``
    are strided samples. Returns dict(resolution, trange, coarse_trange,
    fine_kernel, normals_resolution).
    """
    pops = (populations if populations is not None
            else [None] * len(slab_samples))
    models = None
    if grid_resolution:
        resolution = normals_resolution = grid_resolution
    else:
        models = [_occupancy_model(np.asarray(s)) for s in slab_samples]
        resolution = normals_resolution = max(
            auto_resolution_data(s, population=p, model=m)
            for s, p, m in zip(slab_samples, pops, models)
        )

    def _trange_at(r):
        tr = max(auto_trange(s, r, population=p)
                 for s, p in zip(slab_samples, pops))
        for step in _TRANGE_LADDER:
            if tr <= step:
                return step
        return tr

    trange = _trange_at(resolution)
    out_kernel = "sweep"
    # The z-column gate at the UNBOOSTED base parameters.
    if fine_kernel == "zcol" or (
        fine_kernel == "auto" and trange >= 2048 and resolution <= 128
    ):
        zr = max(auto_zrange(s, resolution, population=p)
                 for s, p in zip(slab_samples, pops))
        q_per_dev = max(n_queries // max(n_dev, 1), 1)
        pad = 1.0 + (resolution**2 * (128 - 1) / 2) / q_per_dev
        if fine_kernel == "zcol" or 12 * zr * pad < 0.7 * 4 * trange:
            out_kernel = "zcol"
            trange = zr  # the exact chain reads trange as the z budget
    if out_kernel == "sweep" and not grid_resolution:
        if all(surface_boost_ok(s, 2 * resolution, population=p, model=m)
               for s, p, m in zip(slab_samples, pops, models)):
            resolution = 2 * resolution
            trange = _trange_at(resolution)
    coarse_tr = max(auto_coarse_trange(s, resolution, population=p)
                    for s, p in zip(slab_samples, pops))
    return dict(
        resolution=int(resolution), trange=int(trange),
        coarse_trange=int(coarse_tr), fine_kernel=out_kernel,
        normals_resolution=int(normals_resolution),
    )


def use_fused_sweep(slabs: int, trange: int) -> bool:
    """The gate that sends a sweep to the fused form (K1) rather than the
    slot-wise form (K2), kept identical to the JAX package so both run the
    same form on the same shapes."""
    return slabs > 1 and trange < 1536 and slabs * trange <= 24576
