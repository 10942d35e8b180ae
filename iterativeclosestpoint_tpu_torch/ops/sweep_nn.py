"""Exact grid 1-NN: the slab sweep, its certificate and its repair chain.

Counterpart of ``nn_colsweep`` (:1429), ``nn_colsweep_exact`` (:1869),
``make_pallas_nn_device`` (:764) and ``_pallas_fn`` (:2265) in the JAX
package's ``ops/pallas_nn.py``. The window, certificate and repair
bookkeeping are the reference's, written as tensor code; the sweeps
themselves are the CUDA kernels of ``ops/sweep_kernels.py``.

Each tile of 128 queries searches ``slabs`` x-slabs [minx-1 …] × the
tile's dilated y-span × the full z column, a superset of every query's
27-neighbourhood. A found distance within the query's distance to the
edge of its guaranteed window (edges at the grid or target boundary count
as infinite) certifies the result exact. Uncertified queries go through
the repair chain: a re-sweep on the 4×-coarser grid, then budgeted brute
force (K3), then an all-pairs fallback.

The JAX package gates each repair stage with ``lax.cond`` on a device
count. Here each gate reads its count to the host (``int(...)``) and the
stage runs only when the gate fires. In the certified steady state an
iteration therefore costs one fine kernel launch, a few small reductions
and two host reads (coarse census, brute census); the ICP loop adds a
third for its stop code.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.ops.bruteforce import sqrt_rn
from iterativeclosestpoint_tpu_torch.ops.cellblock import auto_resolution_data
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    PallasGrid,
    build_grids,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import (
    colsweep,
    nn_brute,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
    _COARSE_TRANGE_CAP,
    auto_trange,
    auto_zrange,
    estimate_grid_params,
    use_fused_sweep,
)
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device
from iterativeclosestpoint_tpu_torch.utils.hostmath import bbox


def _pad_rows(query, n):
    """Pad (n_in, 3) to (n, 3) by replicating the last row."""
    extra = n - query.shape[0]
    if extra:
        query = torch.cat([query, query[-1:].expand(extra, 3)], dim=0)
    return query


class SweepWindow(NamedTuple):
    """A tile-padded query batch and its sweep window: the kernel inputs
    (``q32``, ``base``, ``slack``) and the certificate (``complete``,
    ``radius``)."""

    q32: torch.Tensor       # (t·tile_q, 3) f32
    base: torch.Tensor      # (t, slabs) int32 128-aligned row bases
    slack: "torch.Tensor | None"  # (t, slabs) int32 lo | width << 7 (K1)
    complete: torch.Tensor  # (t·tile_q,) the query's x±1 slabs fit
    radius: torch.Tensor    # (t·tile_q,) f32 certificate radius


def sweep_window(query: torch.Tensor, grid: PallasGrid, *, resolution: int,
                 tile_q: int, slabs: int, trange: int,
                 fused: bool) -> SweepWindow:
    """Per-tile slab windows and per-query certificates for ``query``,
    whose length is a multiple of ``tile_q``."""
    R = resolution
    dev = query.device
    n = query.shape[0]
    t = n // tile_q
    m_rows = grid.tgt_t.shape[1]

    q32 = query.to(torch.float32).contiguous()
    org = grid.origin.to(torch.float32)
    cs = grid.cell_size.to(torch.float32)
    qcell = torch.floor((q32 - org[None, :]) / cs).to(torch.int32)
    # Clamp to the OCCUPIED cell range per axis (the grid cube spans the
    # longest axis in every dim; a query past the target's true edge on a
    # shorter axis would otherwise window only empty cells).
    occ_hi = torch.clamp(
        torch.floor((grid.bbox_hi.to(torch.float32) - org) / cs).to(
            torch.int32), max=R - 1)
    qcell = torch.minimum(torch.clamp(qcell, min=0), occ_hi[None, :])

    qc_t = qcell.reshape(t, tile_q, 3)
    minc = qc_t.amin(dim=1)  # (t, 3)
    maxc = qc_t.amax(dim=1)

    # Slab s covers x = minx-1+s, y ∈ [miny-1, maxy+1], all z: one
    # contiguous row range [col_start[x·R+ylo], col_start[x·R+yhi+1]).
    s_ix = torch.arange(slabs, dtype=torch.int32, device=dev)
    xs = minc[:, 0:1] - 1 + s_ix[None, :]  # (t, slabs)
    x_ok = (xs >= 0) & (xs < R) & (xs <= maxc[:, 0:1] + 1)
    xs_cl = torch.clamp(xs, 0, R - 1)
    y_lo = torch.clamp(minc[:, 1] - 1, 0, R - 1)[:, None]
    y_hi = torch.clamp(maxc[:, 1] + 1, 0, R - 1)[:, None]
    col = grid.col_start
    start = col[(xs_cl * R + y_lo).long()]
    end = col[(xs_cl * R + y_hi + 1).long()]
    zero = torch.zeros_like(start)
    start = torch.where(x_ok, start, zero)
    end = torch.where(x_ok, end, zero)

    # Bases are aligned down to 128 rows (the TPU's HBM tile); the fit
    # margin keeps room for that slack, so certificates match the JAX ones.
    slab_fit = (end - start) <= trange - 128  # (t, slabs)

    # Per-query completeness: the query's own x±1 slabs are present and fit.
    sx = qc_t[..., 0] - (minc[:, 0:1] - 1)  # (t, tile_q) slab coord
    in_box = sx + 1 <= slabs - 1
    fit3_tab = (
        slab_fit
        & torch.cat([slab_fit[:, :1], slab_fit[:, :-1]], dim=1)
        & torch.cat([slab_fit[:, 1:], slab_fit[:, -1:]], dim=1)
    )
    fit3 = ((sx[..., None] == s_ix) & fit3_tab[:, None, :]).any(dim=-1)
    query_complete = (in_box & fit3).reshape(n)

    # Certificate radius: distance from the query POINT (unclipped) to the
    # edge of its guaranteed window (x: own ±1 cells; y: the tile's dilated
    # span; z: unbounded). Edges at/beyond the grid boundary, or strictly
    # beyond the target's true extent, certify to infinity.
    pq = (q32 - org[None, :]).reshape(t, tile_q, 3)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    hi_rel = grid.bbox_hi.to(torch.float32) - org
    qx_c = qc_t[..., 0]
    rx_lo = torch.where(qx_c <= 1, inf,
                        pq[..., 0] - (qx_c - 1).to(torch.float32) * cs)
    rx_hi = torch.where(
        (qx_c >= R - 2) | ((qx_c + 2).to(torch.float32) * cs > hi_rel[0]),
        inf, (qx_c + 2).to(torch.float32) * cs - pq[..., 0],
    )
    my_lo = minc[:, 1:2]
    my_hi = maxc[:, 1:2]
    ry_lo = torch.where(my_lo <= 1, inf,
                        pq[..., 1] - (my_lo - 1).to(torch.float32) * cs)
    ry_hi = torch.where(
        (my_hi >= R - 2) | ((my_hi + 2).to(torch.float32) * cs > hi_rel[1]),
        inf, (my_hi + 2).to(torch.float32) * cs - pq[..., 1],
    )
    rx = torch.minimum(rx_lo, rx_hi)
    ry = torch.minimum(ry_lo, ry_hi)
    # Out-of-bbox strengthening: a candidate outside the window must escape
    # it in x or y, and it still lies inside the target bbox, so
    #   radius = min( sqrt(rx² + gy² + gz²), sqrt(ry² + gx² + gz²) ).
    gap = torch.clamp(torch.maximum(-pq, pq - hi_rel), min=0.0)
    gx, gy, gz = gap[..., 0], gap[..., 1], gap[..., 2]
    radius = torch.minimum(
        sqrt_rn((rx * rx + gy * gy) + gz * gz),
        sqrt_rn((ry * ry + gx * gx) + gz * gz),
    ).reshape(n)

    base = torch.clamp(start, max=m_rows - trange)
    base = ((base // 128) * 128).to(torch.int32).contiguous()
    slack = None
    if fused:
        # Packed (slack | width << 7); dead slabs have start = end = 0 →
        # width 0, every row masked.
        slack = ((start - base)
                 | (torch.clamp(end - start, max=trange) << 7)).to(
                     torch.int32).contiguous()
    return SweepWindow(q32, base, slack, query_complete, radius)


def sweep_results(out: torch.Tensor, win: SweepWindow, dtype):
    """(matched, normal, dist, certified, tie) from a sweep's (t, 8, 128)
    output. Row 7 ≠ 1 is an exact tie: its certificate may hold, but only
    brute force resolves it in first-tie order."""
    n = win.q32.shape[0]
    d2 = out[:, 6, :].reshape(n)
    unique = out[:, 7, :].reshape(n) == 1.0
    dist = sqrt_rn(torch.clamp(d2, min=0.0)).to(dtype)
    matched = out[:, 0:3, :].transpose(1, 2).reshape(n, 3).to(dtype)
    normal = out[:, 3:6, :].transpose(1, 2).reshape(n, 3).to(dtype)
    covered = win.complete & (dist <= win.radius)
    return matched, normal, dist, covered & unique, covered & ~unique


def nn_colsweep(
    query: torch.Tensor,
    grid: PallasGrid,
    *,
    resolution: int,
    tile_q: int = 128,
    slabs: int = 6,
    trange: int = 2048,
    fused: bool = False,
    return_tie: bool = False,
):
    """Slab-sweep grid 1-NN.

    ``query`` (N, 3) f32 in tile layout, any N (padded here by replicating
    the last row). Returns (matched (N,3), normal (N,3) — the grid's rows
    3-5, far padding unless normals are packed, dist (N,), certified (N,)
    bool) and, with ``return_tie``, the rows whose certificate held but
    whose winner was an exact tie.
    """
    n_in = query.shape[0]
    query = _pad_rows(query, -(-n_in // tile_q) * tile_q)
    win = sweep_window(query, grid, resolution=resolution, tile_q=tile_q,
                       slabs=slabs, trange=trange, fused=fused)
    out = colsweep(win.base, win.q32, grid.tgt_t, slabs=slabs, trange=trange,
                   fused=fused, slack=win.slack)
    res = sweep_results(out, win, query.dtype)
    return tuple(x[:n_in] for x in (res if return_tie else res[:4]))


def nn_colsweep_exact(
    query: torch.Tensor,
    target: torch.Tensor,
    grid: PallasGrid,
    coarse_grid: "PallasGrid | None" = None,
    *,
    resolution: int,
    coarse_resolution: int = 0,
    tile_q: int = 128,
    slabs: int = 6,
    trange: int = 2048,
    coarse_trange: int = 16384,
    coarse_budget: int = 65536,
    coarse_passes: int = 4,
    brute_batch: int = 4096,
    brute_passes: int = 16,
    global_fallback: bool = True,
):
    """Exact NN: fine sweep → coarse-grid repair → budgeted brute → global
    fallback.

    Only budget overflow with ``global_fallback=False`` leaves rows
    unproven. Repair bookkeeping runs at tile granularity: bad tiles are
    compacted to the front by a stable argsort of per-tile flags and
    re-searched whole (overwriting a certified row with another exact
    result is harmless). Tie-decertified rows skip the coarse stages,
    which can never certify an exact tie.

    Returns (matched (N,3), normal (N,3), dist (N,)).
    """
    dev = query.device
    n_in = query.shape[0]
    t = -(-n_in // tile_q)
    n = t * tile_q
    query = _pad_rows(query, n)

    m3, nrm, dist, certified, tie = nn_colsweep(
        query, grid, resolution=resolution, tile_q=tile_q, slabs=slabs,
        trange=trange, fused=use_fused_sweep(slabs, trange), return_tie=True,
    )
    q_t = query.reshape(t, tile_q, 3)
    m_t = torch.cat([m3, nrm], dim=1).reshape(t, tile_q, 6)
    d_t = dist.reshape(t, tile_q)
    c_t = certified.reshape(t, tile_q)
    tie_t = tie.reshape(t, tile_q)

    def tgt6(bi):
        bm = target[bi]
        return torch.cat([bm, torch.zeros_like(bm)], dim=1)

    if coarse_grid is not None and coarse_resolution:
        # Staged budgets: a small first stage for the steady-state drizzle,
        # a middle stage for the moderate drift tail, then full-budget
        # passes, the later ones gated on progress.
        ct_full = max(min(coarse_budget // tile_q, t), 1)
        ct_small = max(min(64, ct_full // 2), 1)
        ct_mid = max(min(3 * ct_small, ct_full // 2), 1)

        def coarse_bad():
            return (~c_t & ~tie_t).any(dim=1)

        def coarse_repair(ct):
            """Coarse-repair the first ``ct`` tiles of the bad-first tile
            permutation (still-bad tiles always compact to the front)."""
            bad = coarse_bad()
            n_bad = bad.sum()
            tsel = torch.argsort((~bad).to(torch.int32), stable=True)[:ct]
            qc = q_t[tsel].reshape(ct * tile_q, 3)
            m_c, n_c, d_c, cert_c = nn_colsweep(
                qc, coarse_grid, resolution=coarse_resolution,
                tile_q=tile_q, slabs=slabs, trange=coarse_trange,
            )
            m_c6 = torch.cat([m_c, n_c], dim=1).reshape(ct, tile_q, 6)
            live = (torch.arange(ct, device=dev) < n_bad)[:, None]
            upd = live & cert_c.reshape(ct, tile_q)
            m_t[tsel] = torch.where(upd[..., None], m_c6, m_t[tsel])
            d_t[tsel] = torch.where(upd, d_c.reshape(ct, tile_q), d_t[tsel])
            c_t[tsel] = c_t[tsel] | upd

        n_bad0 = int(coarse_bad().sum())  # host read
        if n_bad0 > 0:
            coarse_repair(ct_small)
        if ct_mid > ct_small and ct_full > ct_mid and n_bad0 > ct_small:
            coarse_repair(ct_mid)
        if ct_full > ct_small and n_bad0 > 0:
            # Pass 1 fires on any leftover; passes 2.. only while the
            # previous pass kept certifying tiles. A pass that does not
            # fire changes nothing, so no later pass can fire either.
            n_prev = None
            for _ in range(coarse_passes):
                n_now = int(coarse_bad().sum())  # host read
                fire = n_now > 0 if n_prev is None else 0 < n_now < n_prev
                if not fire:
                    break
                coarse_repair(ct_full)
                n_prev = n_now

    bad_tile2 = (~c_t).any(dim=1)
    n_bad_t2 = int(bad_tile2.sum())  # host read
    bt = max(brute_batch // tile_q, 1)         # tiles per brute pass
    kmax = min(brute_passes * bt, t)           # total tile budget
    bt_small = min(max(bt // 8, 1), kmax)

    def brute_repair(lo, nb):
        """Brute-repair tiles [lo, lo+nb) of the bad-first permutation."""
        tperm = torch.argsort((~bad_tile2).to(torch.int32), stable=True)
        rows = tperm[lo:lo + nb]
        bi, bd = nn_brute(q_t[rows].reshape(nb * tile_q, 3), target)
        live = (lo + torch.arange(nb, device=dev) < n_bad_t2)[:, None]
        m_t[rows] = torch.where(live[..., None],
                                tgt6(bi).reshape(nb, tile_q, 6), m_t[rows])
        d_t[rows] = torch.where(live, bd.reshape(nb, tile_q), d_t[rows])

    if kmax > 0 and n_bad_t2 > 0:
        brute_repair(0, bt_small)  # the drizzle (≤ bt_small bad tiles)
        if n_bad_t2 > bt_small:
            # Bulk passes; tiles fixed by the first stage are brute-forced
            # again (same exact result).
            nb = min(bt, kmax)
            for p in range(brute_passes):
                if n_bad_t2 > p * bt:
                    brute_repair(min(p * bt, t - nb), nb)

    if global_fallback and n_bad_t2 > kmax:
        bi, bd = nn_brute(query.contiguous(), target)
        m_t = tgt6(bi).reshape(t, tile_q, 6)
        d_t = bd.reshape(t, tile_q)

    matched = m_t.reshape(n, 6)
    dist = d_t.reshape(n)
    return matched[:n_in, 0:3], matched[:n_in, 3:6], dist[:n_in]


def _pallas_fn(resolution: int, coarse_resolution: int, trange: int,
               coarse_trange: int, global_fallback: bool, slabs: int = 4,
               tile_q: int = 128):
    """The ICP loop's nn_fn: (query, target, (grid, coarse)) →
    (matched, dist)."""

    def fn(query, target, nn_state):
        grid, coarse = nn_state
        m, _nrm, d = nn_colsweep_exact(
            query, target, grid, coarse,
            resolution=resolution, coarse_resolution=coarse_resolution,
            trange=trange, coarse_trange=coarse_trange,
            global_fallback=global_fallback, slabs=slabs, tile_q=tile_q,
        )
        return m, d

    # The ICP driver reads these to build the matching query layout.
    fn.tile_q = tile_q
    fn.layout_group = "x"
    return fn


def make_pallas_nn_device(
    target_local: np.ndarray,
    resolution: "int | None" = None,
    trange: "int | None" = None,
    slabs: int = 4,
    target_dev: "torch.Tensor | None" = None,
    tile_q: int = 128,
    est: "tuple | None" = None,
    device=None,
):
    """Grids + (nn_fn, nn_state, resolution) for the ICP driver.

    Host work is the estimator pass (``estimate_grid_params``, or ``est``
    precomputed) and one bbox sweep; both grid levels are sorted and padded
    on the device of ``target_dev`` (default: ``target_local`` uploaded to
    ``device``). The kernel-regime gate is the JAX package's; its z-column
    regime is not ported yet and raises. The grids carry no normals
    (point-to-plane mode, ROADMAP P10).
    """
    target_local = np.asarray(target_local)
    coarse_trange = None
    est_zrange = None
    if est is not None and resolution is None and trange is None:
        resolution, trange_est, coarse_trange, _base, est_zrange = est
    elif resolution is None and trange is None:
        resolution, trange_est, coarse_trange, _base, est_zrange = (
            estimate_grid_params(target_local))
    else:
        if resolution is None:
            resolution = auto_resolution_data(
                target_local, surface_boost_occupancy=32)
        trange_est = (trange if trange is not None
                      else auto_trange(target_local, resolution))
    # Kernel regime: the z-window column sweep wins on volume clouds when
    # its candidate count (12 slots × zrange) undercuts slabs × trange.
    if trange is None and trange_est >= 2048 and resolution <= 128:
        zr_est = (est_zrange if est_zrange is not None
                  else auto_zrange(target_local, resolution, tile_q=tile_q))
        pad = 1.0 + (resolution**2 * (tile_q - 1) / 2) / max(
            len(target_local), 1)
        if 12 * zr_est * pad < 0.7 * slabs * trange_est:
            raise NotImplementedError(
                "the volume regime's z-column sweep is not ported yet "
                "(ROADMAP P11)")
    trange = trange_est
    tmin, tmax = bbox(target_local)
    if target_dev is None:
        target_dev = torch.as_tensor(target_local, dtype=torch.float32,
                                     device=resolve_device(device))
    coarse_resolution = max(resolution // 4, 8)
    if coarse_trange is None:
        coarse_trange = _COARSE_TRANGE_CAP
    ext = float((tmax - tmin).max())
    dev = target_dev.device
    grid, coarse = build_grids(
        target_dev,
        torch.as_tensor(tmin, dtype=torch.float32, device=dev),
        torch.tensor(max(ext / resolution, 1e-9), dtype=torch.float32,
                     device=dev),
        torch.tensor(max(ext / coarse_resolution, 1e-9),
                     dtype=torch.float32, device=dev),
        resolution=resolution, trange=trange,
        coarse_resolution=coarse_resolution, coarse_trange=coarse_trange,
    )
    global_fallback = len(target_local) <= 300_000
    return (
        _pallas_fn(resolution, coarse_resolution, trange, coarse_trange,
                   global_fallback, slabs=slabs, tile_q=tile_q),
        (grid, coarse),
        resolution,
    )
