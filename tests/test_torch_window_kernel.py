"""The sweep windows' kernels (``csrc/sweep_window.cu``) against their
plain versions, and their wrapper's checks.

The card tests (``-m cuda``) hold ``slab_window`` and ``zcol_window``
against ``_sweep_window_plain`` and ``_zcol_window_plain`` on the same CUDA
tensors at the main paths' shapes, bit for bit: bases, slot masks,
completeness and radii (NaN where the plain version has NaN). Each query
set adds to a laid-out copy of the target rows past the target's box on
each axis, a tile scattered over the whole target, and rows of NaN and
±1e30, and ends off a tile boundary. They import no JAX, so on a machine
with a card::

    python -m pytest --noconftest -m cuda tests/test_torch_window_kernel.py

The CPU tests hold the wrapper's checks and the dispatch: CPU tensors
take the plain version and launch nothing.
"""

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
from iterativeclosestpoint_tpu_torch.ops import sweep_nn as tsn
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    build_grid,
    build_zgrid,
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import collect
from iterativeclosestpoint_tpu_torch.utils.synth import make_cloud


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _grid(dev, tgt, R, trange, zcol):
    """A slab grid (cubic cells) or a z-column grid (per-axis cells) of
    ``tgt`` on ``dev``."""
    lo, hi = tgt.min(axis=0).astype(np.float64), tgt.max(axis=0)
    t_dev = torch.as_tensor(tgt, device=dev)
    lo_dev = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    if zcol:
        cell3 = torch.as_tensor(np.maximum((hi - lo) / R, 1e-9),
                                dtype=torch.float32, device=dev)
        return build_zgrid(t_dev, lo_dev, cell3, resolution=R, zrange=trange)
    cell = torch.tensor(float((hi - lo).max()) / R, dtype=torch.float32,
                        device=dev)
    return build_grid(t_dev, lo_dev, cell, resolution=R, trange=trange)


def _queries(dev, tgt, grid, R, group, seed=11):
    """The target + N(0, 0.05) in the sweep's tile layout, then a tile of
    rows near one point moved past the box for each side of each axis, a
    tile drawn from the whole target, rows of NaN and ±1e30; padded to
    whole tiles as ``nn_colsweep`` pads. Returns (queries, extra rows,
    the scattered tile's rows)."""
    rng = np.random.default_rng(seed)
    q = tgt + rng.normal(0, 0.05, tgt.shape).astype(np.float32)
    q_dev = torch.as_tensor(q, device=dev)
    rows, _ = grouped_tile_order_device(q_dev, grid.origin, grid.cell_size,
                                        resolution=R, group=group)
    lo, hi = tgt.min(axis=0), tgt.max(axis=0)
    extra = []
    for a in range(3):
        for side in (lo, hi):
            p = tgt[rng.integers(len(tgt))] + rng.normal(0, 0.5, (128, 3))
            p[:, a] = side[a] + (0.05 if side is hi else -0.05) * (
                hi[a] - lo[a])
            extra.append(p)
    extra.append(tgt[rng.choice(len(tgt), 128, replace=False)])
    nan, big = float("nan"), 1e30
    extra.append(np.array([[nan, 0, 0], [0, nan, 0], [nan, nan, nan],
                           [big, 0, 0], [-big, 0, 0], [0, big, 0],
                           [0, 0, -big], [big, -big, big]]) + lo)
    extra = np.concatenate(extra).astype(np.float32)
    query = torch.cat([q_dev[rows], torch.as_tensor(extra, device=dev)])
    assert query.shape[0] % 128  # the callers' padding runs
    scattered = slice(len(rows) + 6 * 128, len(rows) + 7 * 128)
    return (tsn._pad_rows(query, -(-query.shape[0] // 128) * 128), extra,
            scattered)


def _bits_equal(a, b):
    """f32 tensors equal bit for bit, NaN where the other has NaN."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a.masked_fill(nan, 0).view(torch.int32),
                       b.masked_fill(nan, 0).view(torch.int32))


# (kind, target, R, trange, slots, fused): the 1M fine slab grid (K1), the
# same target at the 10M base's trange (K2's slab form, no masks), a 1M
# coarse repair grid (6 slabs, trange 16384), the 1M box in z-columns
# (K1, 12 slots) and its slot-wise form (K2, zrange 3072).
CASES = {
    "slab_fine": ("slab", "terrain", 128, 768, 4, True),
    "slab_k2": ("slab", "terrain", 128, 1536, 4, False),
    "slab_coarse": ("slab", "terrain", 32, 16384, 6, True),
    "zcol_fine": ("zcol", "uniform", 64, 512, 12, True),
    "zcol_k2": ("zcol", "uniform", 64, 3072, 12, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_window_kernel_matches_plain(card, case):
    kind, cloud, R, trange, slots, fused = CASES[case]
    tgt = make_cloud(1_000_000, seed=3, kind=cloud, extent=100.0).astype(
        np.float32)
    grid = _grid(card, tgt, R, trange, kind == "zcol")
    query, extra, scattered = _queries(card, tgt, grid, R,
                                       "xy" if kind == "zcol" else "x")
    lo, hi = tgt.min(axis=0), tgt.max(axis=0)
    for a in range(3):  # gaps past the box on both sides of every axis
        assert (extra[:, a] < lo[a]).any() and (extra[:, a] > hi[a]).any()
    if kind == "zcol":
        kw = dict(resolution=R, tile_q=128, zrange=trange, fused=fused,
                  xy_slots=slots)
        kernel, plain, name = tsn.zcol_window, tsn._zcol_window_plain, \
            "zcol_window"
    else:
        kw = dict(resolution=R, tile_q=128, slabs=slots, trange=trange,
                  fused=fused)
        kernel, plain, name = tsn.sweep_window, tsn._sweep_window_plain, \
            "slab_window"
    t = query.shape[0] // 128
    shape = (name, (t, slots, trange, fused))
    before = sk.LAUNCHES[name], sk.LAUNCH_SHAPES[shape]
    win_k = kernel(query, grid, **kw)
    torch.cuda.synchronize()
    assert (sk.LAUNCHES[name], sk.LAUNCH_SHAPES[shape]) == (
        before[0] + 1, before[1] + 1)
    assert win_k.q32.data_ptr() == query.data_ptr()  # f32: passed through
    win_p = plain(query, grid, **kw)
    assert win_k.base.shape == (t, slots)
    assert torch.equal(win_k.base, win_p.base)
    if fused:
        assert torch.equal(win_k.slack, win_p.slack)
        assert bool((win_p.slack == 0).any())  # dead slots
    else:
        assert win_k.slack is None and win_p.slack is None
    assert win_k.complete.dtype == torch.bool
    assert torch.equal(win_k.complete, win_p.complete)
    _bits_equal(win_k.radius, win_p.radius)
    # What the cases are there for: complete and incomplete tiles, the
    # scattered tile incomplete (its x-span exceeds its slabs, its window
    # exceeds 12 columns), NaN, infinite and finite radii.
    assert bool(win_p.complete.any())
    assert not bool(win_p.complete[scattered].all())
    r = win_p.radius
    assert bool(torch.isnan(r).any()) and bool(torch.isinf(r).any())
    assert bool((torch.isfinite(r) & (r > 0)).any())


@pytest.mark.cuda
def test_window_kernels_count_on_the_window_span(card):
    tgt = make_cloud(20_000, seed=3, extent=100.0).astype(np.float32)
    grid = _grid(card, tgt, 32, 768, False)
    query, _, _ = _queries(card, tgt, grid, 32, "x")
    with collect(sync=False) as col:
        tsn.nn_colsweep(query, grid, resolution=32, slabs=4, trange=768,
                        fused=True)
    assert col.meta["nn/window"]["window_kernels"] == 1
    assert "read/inf" not in col.meta


# -- the wrapper's checks and the dispatch, on the CPU ----------------------


def _cpu_case(zcol=False, n=4000, R=16):
    tgt = make_cloud(n, seed=3, kind="uniform" if zcol else "terrain",
                     extent=50.0).astype(np.float32)
    grid = _grid("cpu", tgt, R, 512 if zcol else 768, zcol)
    q = torch.as_tensor(tgt[:1024] + 0.01, dtype=torch.float32)
    return grid, q


def _wrapper_args(grid, q):
    return (q, grid.col_start, grid.origin, grid.cell_size, grid.bbox_hi)


WRAPPER_KW = dict(resolution=16, tile_q=128, slots=4, trange=768,
                  fused=True)

BAD = {
    "q_dtype": (lambda a, k: ((a[0].double(),) + a[1:], k), TypeError),
    "q_shape": (lambda a, k: ((a[0][:, :2].contiguous(),) + a[1:], k),
                ValueError),
    "q_rows": (lambda a, k: ((a[0][:1000],) + a[1:], k), ValueError),
    "q_strided": (lambda a, k: ((a[0].T.contiguous().T,) + a[1:], k),
                  ValueError),
    "csr_dtype": (lambda a, k: ((a[0], a[1].long()) + a[2:], k), TypeError),
    "csr_shape": (lambda a, k: ((a[0], a[1][:-1]) + a[2:], k), ValueError),
    "origin_shape": (lambda a, k: (a[:2] + (a[2][:2],) + a[3:], k),
                     ValueError),
    "cell_shape": (lambda a, k: (a[:3] + (a[3].reshape(1),) + a[4:], k),
                   ValueError),
    "tile_q": (lambda a, k: (a, dict(k, tile_q=64)), ValueError),
    "slots": (lambda a, k: (a, dict(k, slots=17)), ValueError),
    "cpu": (lambda a, k: (a, k), ValueError),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_window_kernel_wrapper_checks(bad):
    grid, q = _cpu_case()
    edit, err = BAD[bad]
    args, kw = edit(_wrapper_args(grid, q), WRAPPER_KW)
    before = dict(sk.LAUNCHES)
    with pytest.raises(err):
        sk.sweep_window_kernel("slab_window", *args,
                               m_rows=grid.tgt_t.shape[1], **kw)
    assert sk.LAUNCHES == before


@pytest.mark.parametrize("zcol", [False, True])
def test_cpu_tensors_take_the_plain_window(zcol):
    grid, q = _cpu_case(zcol)
    before, shapes = dict(sk.LAUNCHES), dict(sk.LAUNCH_SHAPES)
    if zcol:
        kw = dict(resolution=16, tile_q=128, zrange=512, fused=True)
        got = tsn.zcol_window(q, grid, **kw)
        want = tsn._zcol_window_plain(q, grid, **kw)
    else:
        kw = dict(resolution=16, tile_q=128, slabs=4, trange=768, fused=True)
        got = tsn.sweep_window(q, grid, **kw)
        want = tsn._sweep_window_plain(q, grid, **kw)
    assert sk.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with collect(sync=False) as col:
        if zcol:
            tsn.nn_colsweep_z(q, grid, resolution=16, zrange=512)
        else:
            tsn.nn_colsweep(q, grid, resolution=16, slabs=4, trange=768,
                            fused=True)
    assert col.meta["nn/window"]["window_kernels"] == 0
    assert sk.LAUNCHES == before and dict(sk.LAUNCH_SHAPES) == shapes
