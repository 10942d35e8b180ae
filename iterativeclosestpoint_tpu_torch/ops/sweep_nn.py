"""Exact grid 1-NN: the slab sweep, its certificate and its repair chain.

Counterpart of ``nn_colsweep`` (:1429), ``nn_colsweep_z`` (:1692),
``nn_colsweep_exact`` (:1869), ``make_pallas_nn_device`` (:764),
``make_pallas_nn`` (:2209), ``make_pallas_brute`` (:944) and
``_pallas_fn`` (:2265) in the JAX package's ``ops/pallas_nn.py``. The
windows, certificates and repair bookkeeping are the reference's, written
as tensor code; the sweeps themselves are the CUDA kernels of
``ops/sweep_kernels.py``.

The slab sweep (surface clouds): each tile of 128 queries searches
``slabs`` x-slabs [minx-1 …] × the tile's dilated y-span × the full z
column, a superset of every query's 27-neighbourhood. The z-column sweep
(volume clouds): each tile, aligned to one (x, y) column at layout time,
searches up to 12 (x, y) columns of its dilated window, each only over
its dilated z-span, through the full R³ CSR. A found distance within the
query's distance to the edge of its guaranteed window (edges at the grid
or target boundary count as infinite) certifies the result exact.
Uncertified queries go through the repair chain: a slab re-sweep on the
4×-coarser grid, then budgeted brute force, then an all-pairs fallback.
Both brute stages run in the query's dtype (``nn_exact``): K3 at f32, the
plain ``nn_bruteforce`` at f64, as the JAX repair's ``nn_bruteforce``
serves both.

The windows are one CUDA kernel launch each on the card
(``csrc/sweep_window.cu``, which reads nothing back); their plain versions
(``_sweep_window_plain``, ``_zcol_window_plain``) run for CPU tensors.

The JAX package gates each repair stage with ``lax.cond`` on a device
count. Here each gate reads its count to the host (``int(...)``) and the
stage runs only when the gate fires. In the certified steady state an
iteration therefore costs a window and a fine kernel launch, a few small
reductions and two host reads (coarse census, brute census); the ICP loop
adds a third for its stop code. Each of these is a ``read/*`` span, and
the repair chain's span ``nn/repair`` counts its tiles, the window span
``nn/window`` its kernel launches (``window_kernels``: 0 on the plain
path; ``runtime/timing.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.ops.bruteforce import sqrt_rn
from iterativeclosestpoint_tpu_torch.ops.cellblock import auto_resolution_data
from iterativeclosestpoint_tpu_torch.ops.normals import (
    estimate_normals_cellpca,
    estimate_normals_cellpca_device,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    PallasGrid,
    ZPallasGrid,
    build_grids,
    build_pallas_grid,
    build_zgrids,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import (
    colsweep,
    nn_brute,
    nn_exact,
    sweep_window_kernel,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
    _AUTO_TRANGE_SAMPLE_CAP,
    _COARSE_TRANGE_CAP,
    _zrange_device,
    auto_trange,
    auto_zrange,
    estimate_grid_params,
    use_fused_sweep,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import count, stage
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device
from iterativeclosestpoint_tpu_torch.utils.hostmath import bbox

# z-column sweep: (x, y) column slots per tile (``xy_slots``), the JAX
# package's default and the only value its callers use. A tile laid out
# in one column needs at most its 3 × 3 dilated neighbourhood; the rest is
# room for drift. The kernels take up to 16.
XY_SLOTS = 12


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
    complete: torch.Tensor  # (t·tile_q,) the query's window fits
    radius: torch.Tensor    # (t·tile_q,) f32 certificate radius


def _tile_cells(query, grid, R: int, tile_q: int):
    """Shared front of both windows: f32 queries, (3,) origin and cells,
    the occupied-range-clamped query cells per tile (t, tile_q, 3), their
    per-tile min and max, the query offsets from the origin (t, tile_q, 3)
    and the target's true extent in that frame."""
    t = query.shape[0] // tile_q
    q32 = query.to(torch.float32).contiguous()
    org = grid.origin.to(torch.float32)
    cs = torch.broadcast_to(grid.cell_size.to(torch.float32), (3,))
    hi_rel = grid.bbox_hi.to(torch.float32) - org
    qcell = torch.floor((q32 - org[None, :]) / cs).to(torch.int32)
    # Clamp to the OCCUPIED cell range per axis (the grid cube spans the
    # longest axis in every dim; a query past the target's true edge on a
    # shorter axis would otherwise window only empty cells).
    occ_hi = torch.clamp(torch.floor(hi_rel / cs).to(torch.int32),
                         max=R - 1)
    qcell = torch.minimum(torch.clamp(qcell, min=0), occ_hi[None, :])
    qc_t = qcell.reshape(t, tile_q, 3)
    pq = (q32 - org[None, :]).reshape(t, tile_q, 3)
    return q32, cs, qc_t, qc_t.amin(dim=1), qc_t.amax(dim=1), pq, hi_rel


def _edge_dist(p, lo_c, hi_c, cell, hi, R: int):
    """Distance along one axis from the query coordinate ``p`` to the edge
    of a window covering cells [lo_c - 1, hi_c + 1]. An edge at or beyond
    the grid boundary, or strictly beyond the target's true extent ``hi``,
    is infinitely far."""
    with stage("read/inf"):  # a host-to-device copy for CUDA tensors
        inf = torch.tensor(float("inf"), dtype=torch.float32,
                           device=p.device)
    r_lo = torch.where(lo_c <= 1, inf, p - (lo_c - 1).to(torch.float32) * cell)
    r_hi = torch.where(
        (hi_c >= R - 2) | ((hi_c + 2).to(torch.float32) * cell > hi),
        inf, (hi_c + 2).to(torch.float32) * cell - p,
    )
    return torch.minimum(r_lo, r_hi)


def _slot_bases(start, end, m_rows: int, trange: int, fused: bool):
    """128-aligned row bases and, for K1, the packed (lo | width << 7)
    slot masks of the row ranges [start, end). ``start`` ≤ M =
    ``m_rows`` − ``trange``, so ``start − base`` < 128 always fits the
    7-bit ``lo`` field K1 reads."""
    base = torch.clamp(start, max=m_rows - trange)
    base = ((base // 128) * 128).to(torch.int32).contiguous()
    slack = None
    if fused:
        # Dead slots have start = end = 0 → width 0, every row masked.
        slack = ((start - base)
                 | (torch.clamp(end - start, max=trange) << 7)).to(
                     torch.int32).contiguous()
    return base, slack


def _window_kernel(name, query, grid, csr, **kw) -> SweepWindow:
    """A window through its kernel (``sweep_window_kernel``), counted on
    the enclosing span as ``window_kernels``."""
    q32 = query.to(torch.float32).contiguous()
    out = sweep_window_kernel(name, q32, csr, grid.origin, grid.cell_size,
                              grid.bbox_hi, m_rows=grid.tgt_t.shape[1], **kw)
    count("window_kernels")
    return SweepWindow(q32, *out)


def sweep_window(query: torch.Tensor, grid: PallasGrid, *, resolution: int,
                 tile_q: int, slabs: int, trange: int,
                 fused: bool) -> SweepWindow:
    """Per-tile slab windows and per-query certificates for ``query``,
    whose length is a multiple of ``tile_q``: the ``slab_window`` kernel
    for CUDA tensors (``tile_q`` 128), the plain version for CPU ones."""
    if query.device.type == "cpu":
        count("window_kernels", 0)
        return _sweep_window_plain(query, grid, resolution=resolution,
                                   tile_q=tile_q, slabs=slabs, trange=trange,
                                   fused=fused)
    return _window_kernel("slab_window", query, grid, grid.col_start,
                          resolution=resolution, tile_q=tile_q, slots=slabs,
                          trange=trange, fused=fused)


def _sweep_window_plain(query: torch.Tensor, grid: PallasGrid, *,
                        resolution: int, tile_q: int, slabs: int,
                        trange: int, fused: bool) -> SweepWindow:
    """``sweep_window``'s plain version (any device, any ``tile_q``)."""
    R = resolution
    dev = query.device
    n = query.shape[0]
    q32, cs, qc_t, minc, maxc, pq, hi_rel = _tile_cells(query, grid, R,
                                                        tile_q)

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
    # span; z: unbounded).
    rx = _edge_dist(pq[..., 0], qc_t[..., 0], qc_t[..., 0], cs[0],
                    hi_rel[0], R)
    ry = _edge_dist(pq[..., 1], minc[:, 1:2], maxc[:, 1:2], cs[1],
                    hi_rel[1], R)
    # Out-of-bbox strengthening: a candidate outside the window must escape
    # it in x or y, and it still lies inside the target bbox, so
    #   radius = min( sqrt(rx² + gy² + gz²), sqrt(ry² + gx² + gz²) ).
    gap = torch.clamp(torch.maximum(-pq, pq - hi_rel), min=0.0)
    gx, gy, gz = gap[..., 0], gap[..., 1], gap[..., 2]
    radius = torch.minimum(
        sqrt_rn((rx * rx + gy * gy) + gz * gz),
        sqrt_rn((ry * ry + gx * gx) + gz * gz),
    ).reshape(n)

    base, slack = _slot_bases(start, end, grid.tgt_t.shape[1], trange, fused)
    return SweepWindow(q32, base, slack, query_complete, radius)


def zcol_window(query: torch.Tensor, grid: ZPallasGrid, *, resolution: int,
                tile_q: int, zrange: int, fused: bool,
                xy_slots: int = XY_SLOTS) -> SweepWindow:
    """Per-tile z-window column slots and per-tile certificates for
    ``query`` in an (x, y)-group layout, whose length is a multiple of
    ``tile_q`` (``nn_colsweep_z`` :1692-1832 of the JAX package): the
    ``zcol_window`` kernel for CUDA tensors (``tile_q`` 128), the plain
    version for CPU ones.

    Slot k covers column (x, y) = (lo_x + k // ny, lo_y + k % ny) of the
    tile's dilated window [min-1, max+1]² and its cells [lo_z, hi_z]: one
    contiguous row range of the R³ CSR. The tile is complete when every
    window column fits ``zrange − 128`` rows and the window has at most
    ``xy_slots`` columns.
    """
    if query.device.type == "cpu":
        count("window_kernels", 0)
        return _zcol_window_plain(query, grid, resolution=resolution,
                                  tile_q=tile_q, zrange=zrange, fused=fused,
                                  xy_slots=xy_slots)
    return _window_kernel("zcol_window", query, grid, grid.cell_start,
                          resolution=resolution, tile_q=tile_q,
                          slots=xy_slots, trange=zrange, fused=fused)


def _zcol_window_plain(query: torch.Tensor, grid: ZPallasGrid, *,
                       resolution: int, tile_q: int, zrange: int,
                       fused: bool, xy_slots: int = XY_SLOTS) -> SweepWindow:
    """``zcol_window``'s plain version (any device, any ``tile_q``)."""
    R = resolution
    dev = query.device
    n = query.shape[0]
    q32, cs, _qc_t, minc, maxc, pq, hi_rel = _tile_cells(query, grid, R,
                                                         tile_q)
    lo = torch.clamp(minc - 1, 0, R - 1)  # (t, 3) window low cells
    hi = torch.clamp(maxc + 1, 0, R - 1)
    nx = hi[:, 0] - lo[:, 0] + 1
    ny = hi[:, 1] - lo[:, 1] + 1

    k = torch.arange(xy_slots, dtype=torch.int32, device=dev)[None, :]
    ny_c = torch.clamp(ny, min=1)[:, None]
    dx = torch.div(k, ny_c, rounding_mode="floor")
    dy = k - dx * ny_c
    in_win = dx < nx[:, None]
    xs = torch.clamp(lo[:, 0:1] + dx, 0, R - 1)
    ys = torch.clamp(lo[:, 1:2] + dy, 0, R - 1)
    col = (xs * R + ys) * R
    start = grid.cell_start[(col + lo[:, 2:3]).long()]
    end = grid.cell_start[(col + hi[:, 2:3] + 1).long()]
    zero = torch.zeros_like(start)
    start = torch.where(in_win, start, zero)
    end = torch.where(in_win, end, zero)

    col_fit = (end - start) <= zrange - 128
    tile_ok = col_fit.all(dim=1) & (nx * ny <= xy_slots)  # (t,)
    complete = tile_ok[:, None].expand(-1, tile_q).reshape(n)

    # Certificate radius: distance to the covered window's edge in all
    # three axes. A candidate outside the window escapes it along some
    # axis a and still lies in the target bbox, so the escape bound is
    # sqrt(r_a² + Σ_{b≠a} g_b²); the sum is the JAX package's order,
    # r_a² + (g_b0² + g_b1²).
    gap = torch.clamp(torch.maximum(-pq, pq - hi_rel), min=0.0)
    g2 = gap * gap
    esc = []
    for a in range(3):
        r = _edge_dist(pq[..., a], minc[:, a:a + 1], maxc[:, a:a + 1],
                       cs[a], hi_rel[a], R)
        b0, b1 = (b for b in range(3) if b != a)
        esc.append(sqrt_rn(r * r + (g2[..., b0] + g2[..., b1])))
    radius = torch.minimum(torch.minimum(esc[0], esc[1]), esc[2]).reshape(n)

    base, slack = _slot_bases(start, end, grid.tgt_t.shape[1], zrange, fused)
    return SweepWindow(q32, base, slack, complete, radius)


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
    first_tie: bool = False,
    fused: bool = False,
    return_tie: bool = False,
):
    """Slab-sweep grid 1-NN.

    ``query`` (N, 3) f32 in tile layout, any N (padded here by replicating
    the last row). Returns (matched (N,3), normal (N,3) — the grid's rows
    3-5, far padding unless normals are packed, dist (N,), certified (N,)
    bool) and, with ``return_tie``, the rows whose certificate held but
    whose winner was an exact tie.

    ``first_tie=True`` runs the sweep's first-tie form: the winner is the
    first minimum in scan order, as in the default form, but an exact tie
    keeps it instead of decertifying (``certified`` is the certificate
    alone, the tie mask all False).
    """
    n_in = query.shape[0]
    query = _pad_rows(query, -(-n_in // tile_q) * tile_q)
    with stage("nn/window"):
        win = sweep_window(query, grid, resolution=resolution,
                           tile_q=tile_q, slabs=slabs, trange=trange,
                           fused=fused)
    with stage("nn/sweep"):
        out = colsweep(win.base, win.q32, grid.tgt_t, slabs=slabs,
                       trange=trange, fused=fused, slack=win.slack,
                       first_tie=first_tie)
    res = sweep_results(out, win, query.dtype)
    return tuple(x[:n_in] for x in (res if return_tie else res[:4]))


def nn_colsweep_z(
    query: torch.Tensor,
    grid: ZPallasGrid,
    *,
    resolution: int,
    tile_q: int = 128,
    xy_slots: int = XY_SLOTS,
    zrange: int = 512,
    first_tie: bool = False,
    return_tie: bool = False,
):
    """Z-window column sweep: the volume regime's grid 1-NN.

    ``query`` (N, 3) f32 in an (x, y)-group layout
    (``grouped_tile_order_device(group="xy")``), any N. Each tile reads up
    to ``xy_slots`` short z-window runs through the R³ CSR instead of the
    slab sweep's full z columns. At ``xy_slots·zrange`` ≤ 24576 lanes the
    slots run through K1 with per-slot lane masks; past it through K2's
    unmasked slot-wise form, as the JAX package gates it (its gate encodes
    a TPU VMEM bound; keeping it keeps the two packages on the same kernel
    and so on the same certified rows). Overlapping K2 slots may show a
    row twice, which the index-identity tie rule does not count as a tie.

    Left out on purpose: the JAX package's ``chunk`` argument and its
    ``fused_sweep_chunk`` sizing, which tune the TPU kernel's unrolled
    VMEM chunk loop; the CUDA kernels stage rows in fixed chunks.

    Returns (matched (N,3), normal (N,3), dist (N,), certified (N,)) and,
    with ``return_tie``, the tie-decertified rows; ``first_tie`` as in
    ``nn_colsweep``.
    """
    n_in = query.shape[0]
    query = _pad_rows(query, -(-n_in // tile_q) * tile_q)
    fused = xy_slots * zrange <= 24576
    with stage("nn/window"):
        win = zcol_window(query, grid, resolution=resolution, tile_q=tile_q,
                          zrange=zrange, fused=fused, xy_slots=xy_slots)
    with stage("nn/sweep"):
        out = colsweep(win.base, win.q32, grid.tgt_t, slabs=xy_slots,
                       trange=zrange, fused=fused, slack=win.slack,
                       first_tie=first_tie)
    res = sweep_results(out, win, query.dtype)
    return tuple(x[:n_in] for x in (res if return_tie else res[:4]))


def nn_colsweep_exact(
    query: torch.Tensor,
    target: torch.Tensor,
    grid: "PallasGrid | ZPallasGrid",
    coarse_grid: "PallasGrid | None" = None,
    target_normals: "torch.Tensor | None" = None,
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
    fine: str = "sweep",
    xy_slots: int = XY_SLOTS,
    return_certified: bool = False,
):
    """Exact NN: fine sweep → coarse-grid repair → budgeted brute → global
    fallback.

    ``fine="zcol"``: the fine level is the z-column sweep on a
    ``ZPallasGrid`` with ``xy_slots`` column slots (``trange`` is then its
    ``zrange``; the query layout must be (x, y)-group aligned); the coarse
    repair grid stays an x-slab ``PallasGrid``.

    Only budget overflow with ``global_fallback=False`` leaves rows
    unproven. Repair bookkeeping runs at tile granularity: bad tiles are
    compacted to the front by a stable argsort of per-tile flags and
    re-searched whole (overwriting a certified row with another exact
    result is harmless). Tie-decertified rows skip the coarse stages,
    which can never certify an exact tie.

    ``target_normals`` (M, 3), for point-to-plane: the brute tiers and
    the global fallback gather the winner's normal beside its coordinates
    (the sweeps read it from the grid's rows 3-5).

    Returns (matched (N,3), normal (N,3), dist (N,)) and, with
    ``return_certified``, a per-query mask of results proven exact (sweep
    or coarse certificate, or a brute repair within budget; all rows with
    ``global_fallback``). The partitioned target composes it with its
    halo-margin certificate.
    """
    dev = query.device
    n_in = query.shape[0]
    t = -(-n_in // tile_q)
    n = t * tile_q
    query = _pad_rows(query, n)

    if fine == "zcol":
        m3, nrm, dist, certified, tie = nn_colsweep_z(
            query, grid, resolution=resolution, tile_q=tile_q,
            xy_slots=xy_slots, zrange=trange, return_tie=True,
        )
    elif fine == "sweep":
        m3, nrm, dist, certified, tie = nn_colsweep(
            query, grid, resolution=resolution, tile_q=tile_q, slabs=slabs,
            trange=trange, fused=use_fused_sweep(slabs, trange),
            return_tie=True,
        )
    else:
        raise ValueError(f"unknown fine kernel {fine!r}")
    q_t = query.reshape(t, tile_q, 3)
    m_t = torch.cat([m3, nrm], dim=1).reshape(t, tile_q, 6)
    d_t = dist.reshape(t, tile_q)
    c_t = certified.reshape(t, tile_q)
    tie_t = tie.reshape(t, tile_q)

    def tgt6(bi):
        bm = target[bi]
        nm = (target_normals[bi].to(bm.dtype) if target_normals is not None
              else torch.zeros_like(bm))
        return torch.cat([bm, nm], dim=1)

    searched = 0  # tiles the repair passes search

    with stage("nn/repair"):
        if coarse_grid is not None and coarse_resolution:
            # Staged budgets: a small first stage for the steady-state
            # drizzle, a middle stage for the moderate drift tail, then
            # full-budget passes, the later ones gated on progress.
            ct_full = max(min(coarse_budget // tile_q, t), 1)
            ct_small = max(min(64, ct_full // 2), 1)
            ct_mid = max(min(3 * ct_small, ct_full // 2), 1)

            def coarse_bad():
                return (~c_t & ~tie_t).any(dim=1)

            def coarse_repair(ct):
                """Coarse-repair the first ``ct`` tiles of the bad-first
                tile permutation (still-bad tiles always compact to the
                front)."""
                nonlocal searched
                bad = coarse_bad()
                n_bad = bad.sum()
                tsel = torch.argsort((~bad).to(torch.int32),
                                     stable=True)[:ct]
                qc = q_t[tsel].reshape(ct * tile_q, 3)
                m_c, n_c, d_c, cert_c = nn_colsweep(
                    qc, coarse_grid, resolution=coarse_resolution,
                    tile_q=tile_q, slabs=slabs, trange=coarse_trange,
                )
                m_c6 = torch.cat([m_c, n_c], dim=1).reshape(ct, tile_q, 6)
                live = (torch.arange(ct, device=dev) < n_bad)[:, None]
                upd = live & cert_c.reshape(ct, tile_q)
                m_t[tsel] = torch.where(upd[..., None], m_c6, m_t[tsel])
                d_t[tsel] = torch.where(upd, d_c.reshape(ct, tile_q),
                                        d_t[tsel])
                c_t[tsel] = c_t[tsel] | upd
                searched += ct

            with stage("read/gate"):
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
                    with stage("read/gate"):
                        n_now = int(coarse_bad().sum())  # host read
                    fire = (n_now > 0 if n_prev is None
                            else 0 < n_now < n_prev)
                    if not fire:
                        break
                    coarse_repair(ct_full)
                    n_prev = n_now

        bad_tile2 = (~c_t).any(dim=1)
        with stage("read/gate"):
            n_bad_t2 = int(bad_tile2.sum())  # host read
        bt = max(brute_batch // tile_q, 1)     # tiles per brute pass
        kmax = min(brute_passes * bt, t)       # total tile budget
        bt_small = min(max(bt // 8, 1), kmax)

        def brute_repair(lo, nb):
            """Brute-repair tiles [lo, lo+nb) of the bad-first
            permutation."""
            nonlocal searched
            tperm = torch.argsort((~bad_tile2).to(torch.int32),
                                  stable=True)
            rows = tperm[lo:lo + nb]
            bi, bd = nn_exact(q_t[rows].reshape(nb * tile_q, 3), target)
            live = (lo + torch.arange(nb, device=dev) < n_bad_t2)[:, None]
            m_t[rows] = torch.where(live[..., None],
                                    tgt6(bi).reshape(nb, tile_q, 6),
                                    m_t[rows])
            d_t[rows] = torch.where(live, bd.reshape(nb, tile_q), d_t[rows])
            searched += nb

        if kmax > 0 and n_bad_t2 > 0:
            brute_repair(0, bt_small)  # the drizzle (≤ bt_small bad tiles)
            if n_bad_t2 > bt_small:
                # Bulk passes; tiles fixed by the first stage are
                # brute-forced again (same exact result).
                nb = min(bt, kmax)
                for p in range(brute_passes):
                    if n_bad_t2 > p * bt:
                        brute_repair(min(p * bt, t - nb), nb)

        fallback = global_fallback and n_bad_t2 > kmax
        if fallback:
            bi, bd = nn_exact(query, target)
            m_t = tgt6(bi).reshape(t, tile_q, 6)
            d_t = bd.reshape(t, tile_q)
        # The chain's outcome from the counts read above (no new read).
        coarse = coarse_grid is not None and coarse_resolution
        count("bad_tiles", n_bad0 if coarse else n_bad_t2)
        count("repair_tiles", searched)
        count("unproven_tiles",
              0 if global_fallback else max(0, n_bad_t2 - kmax))
        count("fallbacks", int(fallback))

    matched = m_t.reshape(n, 6)
    dist = d_t.reshape(n)
    if return_certified:
        if global_fallback:
            cert = torch.ones((n,), dtype=torch.bool, device=dev)
        else:
            # The brute stages fix the first kmax bad tiles of the
            # bad-first order.
            rank = torch.cumsum(bad_tile2.to(torch.int32), dim=0) - 1
            fixed = bad_tile2 & (rank < kmax)
            cert = (c_t | fixed[:, None]).reshape(n)
        return (matched[:n_in, 0:3], matched[:n_in, 3:6], dist[:n_in],
                cert[:n_in])
    return matched[:n_in, 0:3], matched[:n_in, 3:6], dist[:n_in]


def _pallas_fn(resolution: int, coarse_resolution: int, trange: int,
               coarse_trange: int, global_fallback: bool,
               with_normals: bool = False, slabs: int = 4,
               tile_q: int = 128, fine: str = "sweep"):
    """The ICP loop's nn_fn: (query, target, (grid, coarse, normals)) →
    (matched, dist), or (matched, dist, normal) ``with_normals`` (the
    point-to-plane contract). ``fine="zcol"`` runs the z-column sweep,
    ``trange`` being its ``zrange``."""

    def fn(query, target, nn_state):
        grid, coarse, normals = nn_state
        m, nrm, d = nn_colsweep_exact(
            query, target, grid, coarse,
            normals if with_normals else None,
            resolution=resolution, coarse_resolution=coarse_resolution,
            trange=trange, coarse_trange=coarse_trange,
            global_fallback=global_fallback, slabs=slabs, tile_q=tile_q,
            fine=fine,
        )
        if with_normals:
            return m, d, nrm
        return m, d

    # The ICP loop reads these to build the matching query layout (the
    # z-column sweep needs (x, y)-group tiles, the slab sweep x-groups)
    # and to check the estimator against the grid's contents.
    fn.tile_q = tile_q
    fn.with_normals = with_normals
    fn.layout_group = "xy" if fine == "zcol" else "x"
    return fn


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def make_pallas_nn_device(
    target_local: "np.ndarray | None",
    resolution: "int | None" = None,
    trange: "int | None" = None,
    slabs: int = 4,
    target_dev: "torch.Tensor | None" = None,
    tile_q: int = 128,
    with_normals: bool = False,
    est: "tuple | None" = None,
    device=None,
    normals: "torch.Tensor | None" = None,
    kernel: str = "auto",
):
    """Grids + (nn_fn, nn_state, resolution) for the ICP driver;
    ``nn_state`` is (grid, coarse, normals).

    Host work is the estimator pass (``estimate_grid_params``), none with
    ``est`` precomputed. The box is one ``aminmax`` over ``target_dev``,
    read back once (``prep_reads``), or a host ``bbox`` where
    ``target_local`` is a copy in another precision (an f64 cloud beside
    its f32 upload). Both grid levels are sorted and padded on the device
    of ``target_dev`` (default: ``target_local`` uploaded to ``device``).
    ``target_local`` may be None with ``target_dev`` and ``est``; the host
    estimators (no ``est``, or a forced ``resolution`` or ``trange``)
    raise a ``ValueError`` without it (``auto_zrange``'s pass runs on the
    device then). The kernel-regime gate is the JAX package's: volume
    clouds go to the z-column sweep on anisotropic cells, everything else
    to the slab sweep. ``kernel`` "sweep" or "zcol" forces one of the two,
    as the JAX package's option does (the kernel smoke check runs both on
    one target).

    ``with_normals=True`` estimates the target's normals on its device
    (cell PCA at the unboosted base resolution: a boosted cell would hold
    a quarter of the points) and packs them into both grid levels; the
    nn_fn then returns the winner's normal too. ``normals`` passes normals
    already estimated at that base resolution (the two-stage fine level
    builds a second factory over the same target).
    """
    if target_local is not None:
        target_local = np.asarray(target_local)
    if target_dev is None:
        if target_local is None:
            raise ValueError("make_pallas_nn_device needs target_local or "
                             "target_dev")
        target_dev = torch.as_tensor(target_local, dtype=torch.float32,
                                     device=resolve_device(device))
    n = target_dev.shape[0]
    dev = target_dev.device

    def host_cloud(what):
        if target_local is None:
            raise ValueError(f"make_pallas_nn_device: {what} runs on the "
                             "host cloud; pass target_local, or est")
        return target_local

    if (target_local is not None
            and _NP_DTYPE.get(target_dev.dtype) != target_local.dtype):
        # The host copy holds other values than the device's: its box.
        tmin, tmax = bbox(target_local)
    else:
        lo, hi = (v.double() for v in torch.aminmax(target_dev, dim=0))
        tmin, tmax = torch.stack([lo, hi]).cpu().numpy()
        count("prep_reads")

    def zrange_at(r):
        if target_local is not None:
            return auto_zrange(target_local, r, tile_q=tile_q)
        if tile_q != 128:
            host_cloud(f"auto_zrange (tile_q={tile_q})")
        # auto_zrange's pass on the device, bit for bit at a power-of-two r.
        return _zrange_device(
            target_dev, max(1, n // _AUTO_TRANGE_SAMPLE_CAP), lo, hi, r)

    coarse_trange = None
    est_zrange = None
    normals_resolution = resolution  # a forced R sizes the normals too
    if est is not None and resolution is None and trange is None:
        (resolution, trange_est, coarse_trange, normals_resolution,
         est_zrange) = est
    elif resolution is None and trange is None:
        (resolution, trange_est, coarse_trange, normals_resolution,
         est_zrange) = estimate_grid_params(host_cloud("the estimate"))
    else:
        if resolution is None:
            resolution, normals_resolution = auto_resolution_data(
                host_cloud("auto_resolution_data"),
                surface_boost_occupancy=32, return_base=True)
        trange_est = (trange if trange is not None
                      else auto_trange(host_cloud("auto_trange"),
                                       resolution))
    # Kernel regime: the z-window column sweep wins on volume clouds when
    # its candidate count (12 slots × zrange, with the (x, y)-group
    # layout's padding) undercuts slabs × trange.
    zrange = None
    if kernel not in ("auto", "sweep", "zcol"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if (kernel == "auto" and trange is None and trange_est >= 2048
            and resolution <= 128):
        zr_est = (est_zrange if est_zrange is not None
                  else zrange_at(resolution))
        pad = 1.0 + (resolution**2 * (tile_q - 1) / 2) / max(n, 1)
        if 12 * zr_est * pad < 0.7 * slabs * trange_est:
            zrange = zr_est
    if kernel == "zcol":
        zrange = (est_zrange if est_zrange is not None
                  else zrange_at(resolution))
    trange = trange_est
    ext = float((tmax - tmin).max())
    origin = torch.as_tensor(tmin, dtype=torch.float32, device=dev)
    if not with_normals:
        normals = None
    elif normals is None:
        nr = normals_resolution or resolution
        with stage("normals") as done:
            normals = estimate_normals_cellpca_device(
                target_dev, origin,
                torch.tensor(max(ext / nr, 1e-9), dtype=torch.float32,
                             device=dev),
                resolution=nr)
            done(normals)

    coarse_resolution = max(resolution // 4, 8)
    if coarse_trange is None:
        coarse_trange = _COARSE_TRANGE_CAP
    cell_c = torch.tensor(max(ext / coarse_resolution, 1e-9),
                          dtype=torch.float32, device=dev)
    levels = dict(resolution=resolution, coarse_resolution=coarse_resolution,
                  coarse_trange=coarse_trange)
    if zrange is not None:
        # Anisotropic cells, per-axis extent / R: cubic cells would starve
        # flat-box clouds of z resolution.
        cell3 = np.maximum((tmax - tmin) / resolution, 1e-9)
        grid, coarse = build_zgrids(
            target_dev, origin,
            torch.as_tensor(cell3, dtype=torch.float32, device=dev), cell_c,
            normals, zrange=zrange, **levels)
        trange = zrange  # the exact chain reads trange as the z budget
    else:
        grid, coarse = build_grids(
            target_dev, origin,
            torch.tensor(max(ext / resolution, 1e-9), dtype=torch.float32,
                         device=dev),
            cell_c, normals, trange=trange, **levels)
    global_fallback = n <= 300_000
    return (
        _pallas_fn(resolution, coarse_resolution, trange, coarse_trange,
                   global_fallback, with_normals, slabs=slabs, tile_q=tile_q,
                   fine="sweep" if zrange is None else "zcol"),
        (grid, coarse, normals),
        resolution,
    )


# make_pallas_brute's target cap: the JAX package's one-cell slab had to
# fit the TPU's VMEM. K3 has no cap; the factory keeps the JAX contract.
BRUTE_MAX_ROWS = 131072


def make_pallas_nn(
    target_local: np.ndarray,
    resolution: "int | None" = None,
    trange: "int | None" = None,
    dtype=np.float32,
    with_normals: bool = False,
    *,
    device=None,
):
    """(nn_fn, nn_state, resolution) with both grid levels built on the
    host and uploaded to ``device`` (None: the card), the JAX package's
    ``make_pallas_nn`` choices: R from ``auto_resolution_data``, trange
    ``max(auto_trange, 2048)`` (so its fine sweep runs K2 slot-wise over
    the JAX factory's 6 slabs), host cell-PCA normals ``with_normals``, a
    coarse grid at ``max(R // 4, 8)`` with trange 16,384, and the global
    fallback only up to 300,000 target points. ``make_pallas_nn_device``
    is the device-built factory the ICP driver uses; this one serves
    callers that pass ``nn_fn``/``nn_state`` to ``icp_register``, which
    keeps the source's row order: its tiles of 128 rows must be compact
    (e.g. in this grid's x-group order, ``grouped_tile_order``) for the
    sweeps to certify, since past 300,000 target points the rows left
    over by the brute tiers' budget stay approximate, as in the JAX
    package. ``dtype`` is accepted and, as in the JAX package, the grids
    are f32."""
    del dtype
    target_local = np.asarray(target_local)
    if resolution is None:
        resolution = auto_resolution_data(target_local)
    if trange is None:
        trange = max(auto_trange(target_local, resolution), 2048)
    normals = normals_dev = None
    if with_normals:
        normals = estimate_normals_cellpca(target_local, resolution)
        normals_dev = torch.as_tensor(normals, dtype=torch.float32,
                                      device=resolve_device(device))
    grid = build_pallas_grid(target_local, resolution, trange=trange,
                             normals=normals, device=device)
    # The 4×-coarser repair level (certificate radius 4 fine cells).
    coarse_resolution = max(resolution // 4, 8)
    coarse = build_pallas_grid(target_local, coarse_resolution,
                               trange=_COARSE_TRANGE_CAP, normals=normals,
                               device=device)
    global_fallback = len(target_local) <= 300_000
    return (
        _pallas_fn(resolution, coarse_resolution, trange, _COARSE_TRANGE_CAP,
                   global_fallback, with_normals, slabs=6),
        (grid, coarse, normals_dev),
        resolution,
    )


def make_pallas_brute(target_local: np.ndarray, dtype=np.float32,
                      normals: "np.ndarray | None" = None, *, device=None):
    """All-pairs exact 1-NN for the ICP driver: (nn_fn, nn_state), the JAX
    package's ``make_pallas_brute`` contract. ``nn_state`` is the one-cell
    grid (every row in target order, ``normals`` (M, 3) in rows 3-5);
    ``nn_fn(query, target, nn_state)`` returns (matched, dist), or
    (matched, dist, normal) with normals, of the first minimum in row
    order, computed in f32 and returned in the query's dtype.

    The JAX package swept its one-cell grid with the slab kernel's
    first-tie form, capped at m ≤ 131,072 by the TPU's VMEM; that cap is
    kept (a ``ValueError`` before anything is built). The nn_fn runs K3,
    the port's kernel for this exact launch and the coarse level's brute
    force: the one-cell sweep's first-tie form computes the same winners
    (``nn_colsweep(..., resolution=1, slabs=1, first_tie=True)``).
    ``dtype`` is accepted and, as in the JAX package, the grid is f32."""
    del dtype
    target_local = np.asarray(target_local)
    m = len(target_local)
    trange = max(-(-m // 128) * 128, 128)
    if trange > BRUTE_MAX_ROWS:
        raise ValueError(f"pallas brute limited to m<={BRUTE_MAX_ROWS}, "
                         f"got {m}")
    grid = build_pallas_grid(target_local, resolution=1, trange=trange,
                             normals=normals, device=device)
    rows = grid.tgt_t[:, :m].T
    return _brute_fn(rows[:, 0:3].contiguous(),
                     None if normals is None else rows[:, 3:6]), grid


def _brute_fn(pts: torch.Tensor, normals: "torch.Tensor | None"):
    """make_pallas_brute's nn_fn: K3 over the one-cell grid's real rows
    ``pts`` (M, 3), gathered once, with their ``normals``."""

    def fn(query, target, nn_state):
        del target, nn_state  # the grid's rows, as in the JAX adapter
        idx, dist = nn_brute(query.to(torch.float32).contiguous(), pts)
        matched = pts[idx].to(query.dtype)
        if normals is not None:
            return matched, dist.to(query.dtype), normals[idx].to(
                query.dtype)
        return matched, dist.to(query.dtype)

    return fn
