"""The sweep kernels' merge rule, through the plain versions on the CPU.

K1 and K2 cut a tile's scan into contiguous ranges of the scan order and
join the partial winners with one rule (``csrc/sweep.cuh::merge_best``,
``merge_best_plain`` in PyTorch). ``colsweep_plain(splits=S)`` sweeps the
S ranges on their own and joins them the same way; it must equal the
unsplit sweep on every row: winner rows (and so the winner's rows 0-5,
here tagged with the row index in rows 3-5), d² and tie flag, tie rows
included. Tolerance: none.
"""

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import (
    BIG,
    colsweep_plain,
    merge_best_plain,
)


def _target(pts, trange):
    """(8, M + trange) tgt_t: xyz of ``pts``, rows 3-5 the row index (so
    the output names the winning row), far padding."""
    m = len(pts)
    tgt_t = torch.full((8, m + trange), 1e6)
    tgt_t[0:3, :m] = torch.as_tensor(pts, dtype=torch.float32).T
    tgt_t[3:6, :] = torch.arange(m + trange, dtype=torch.float32)
    return tgt_t


def _case(case):
    """(base, slack, tgt_t, q, slabs, trange, fused) of one fixture."""
    rng = np.random.default_rng(["tie_free", "dup_rows", "overlap",
                                 "boundary"].index(case))
    tiles = 2
    if case == "tie_free":
        # K1: 4 disjoint slots per tile, lo ≠ 0, odd widths, one empty.
        slabs, trange = 4, 256
        pts = rng.uniform(0, 10, (4 * 384, 3))
        base = np.arange(slabs)[None, :] * 384 + np.zeros((tiles, 1), int)
        lo = rng.integers(0, 128, (tiles, slabs))
        width = rng.integers(1, trange, (tiles, slabs))
        width[0, 2] = 0
        slack = torch.as_tensor(lo | (width << 7), dtype=torch.int32)
        fused = True
    elif case == "dup_rows":
        # K2: every point twice, 700 rows apart: exact d² ties.
        slabs, trange = 3, 256
        half = rng.uniform(0, 10, (700, 3))
        pts = np.vstack([half, half])
        base = rng.integers(0, (1400 - trange) // 128 + 1,
                            (tiles, slabs)) * 128
        slack, fused = None, False
    elif case == "overlap":
        # K2: slabs 0 and 1 share rows [128, 256), slab 2 repeats slab 0.
        slabs, trange = 3, 256
        pts = rng.uniform(0, 10, (600, 3))
        base = np.array([[0, 128, 0], [256, 128, 256]])
        slack, fused = None, False
    else:
        # Lane = row over 5 back-to-back slabs of 128; rows (2k+1, 2k+2)
        # are duplicates, so every even split boundary (S = 2, 3, 8 cut at
        # 320; 214, 428; 80, 160, …) falls inside a slab and between the
        # two rows of a tie.
        slabs, trange = 5, 128
        pts = rng.uniform(0, 10, (640, 3))
        pts[2::2] = pts[1:-1:2]
        base = np.tile(np.arange(slabs) * 128, (tiles, 1))
        slack, fused = None, False
    tgt_t = _target(pts, trange)
    if case == "boundary":
        near = np.array([79, 80, 213, 214, 319, 320, 427, 428, 159, 160])
        idx = np.resize(near, tiles * 128)
    else:
        idx = rng.integers(0, len(pts), tiles * 128)
    q = pts[idx] + rng.normal(0, 0.01, (tiles * 128, 3))
    if case == "boundary":
        q[::2] = pts[idx[::2]]  # exactly on a duplicated point
    return (torch.as_tensor(base, dtype=torch.int32), slack, tgt_t,
            torch.as_tensor(q, dtype=torch.float32), slabs, trange, fused)


@pytest.mark.parametrize("splits", [2, 3, 8])
@pytest.mark.parametrize("case", ["tie_free", "dup_rows", "overlap",
                                  "boundary"])
def test_split_plain_equals_unsplit(case, splits):
    base, slack, tgt_t, q, slabs, trange, fused = _case(case)
    kw = dict(slabs=slabs, trange=trange, fused=fused, slack=slack)
    one = colsweep_plain(base, q, tgt_t, **kw)
    split = colsweep_plain(base, q, tgt_t, splits=splits, **kw)
    assert torch.equal(split, one)
    ties = int((one[:, 7] == 2.0).sum())
    if case in ("tie_free", "overlap"):
        # Overlapping slabs show rows twice; that is no tie.
        assert ties == 0
    else:
        assert ties > 50
    if case == "boundary":
        # The winner on a tie row is the earlier (odd) row of the pair.
        row = one[:, 3][one[:, 7] == 2.0]
        assert torch.all(row % 2 == 1)


def _best(d2, row, tie):
    return (torch.tensor([d2], dtype=torch.float32),
            torch.tensor([row]), torch.tensor([tie]))


@pytest.mark.parametrize("a, b, want", [
    # Equal d², the same row in both ranges: no tie, the row stays.
    ((2.0, 7, False), (2.0, 7, False), (2.0, 7, False)),
    # Equal d², different rows: a tie, the earlier range's row.
    ((2.0, 7, False), (2.0, 3, False), (2.0, 7, True)),
    # Nothing found in the earlier range (row −1): the later one wins.
    ((BIG, -1, False), (5.0, 3, False), (5.0, 3, False)),
    # Nothing found in either range.
    ((BIG, -1, False), (BIG, -1, False), (BIG, -1, False)),
    # A smaller d² wins with its own flag, from either side.
    ((2.0, 7, True), (1.0, 3, False), (1.0, 3, False)),
    ((1.0, 7, True), (2.0, 3, False), (1.0, 7, True)),
    # A tie inside the later range survives an equal d².
    ((2.0, 7, False), (2.0, 7, True), (2.0, 7, True)),
])
def test_merge_best_plain(a, b, want):
    got = merge_best_plain(_best(*a), _best(*b))
    for g, w in zip(got, _best(*want)):
        assert torch.equal(g, w)
