"""The sweep's three CUDA kernels, their wrappers and their plain versions.

| kernel | source | replaces (``iterativeclosestpoint_tpu/ops/pallas_nn.py``) |
| --- | --- | --- |
| K1 ``colsweep_fused`` | ``csrc/colsweep_fused.cu`` | ``_colsweep_fused_kernel`` :1165 |
| K1 as zcol | ``csrc/colsweep_fused.cu`` | ``nn_colsweep_z`` :1692, launched at :1833 with 12 z-window slots |
| K2 ``colsweep`` | ``csrc/colsweep.cu`` | ``_colsweep_kernel`` :1025 (and zcol's slot-wise form past 24576 lanes) |
| K3 ``brute_nn`` | ``csrc/brute_nn.cu`` | ``_colsweep_kernel(first_tie=True)`` on a one-cell grid |

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel on the current stream of the tensors'
card (a mesh rank's thread may hold tensors on another card than the
process's current one) or raises; each
launch adds one to ``LAUNCHES[name]`` and to ``LAUNCH_SHAPES[(name,
shape)]``, the shape being (tiles, slabs, trange) for a sweep (slabs =
12 and trange = zrange for the z-column sweep) and (queries, targets)
for K3 (under a lock: mesh ranks launch from several threads). The
kernels allocate nothing: the wrappers
allocate outputs with ``torch.empty`` / ``torch.full``.

Sweep output contract (K1, K2 and their plain version): (t, 8, 128) f32
per tile of 128 queries — rows 0-5 the winner's rows 0-5 of ``tgt_t``
(xyz and normal), row 6 its d², row 7 1.0 for a unique winner and 2.0 for
an exact tie. The winner is the first minimum in scan order (slab by
slab, row by row). A tie is another row index with exactly the winner's
d². When no candidate falls below 1e18 the winner rows are 0 and row 6
holds 1e18.

The kernels cut a tile's scan into contiguous ranges of the scan order
(all three across the warps of a CTA, K2's small stages and K3 also
across CTAs) and join the partial winners with one merge rule, whose
tensor form is ``merge_best_plain``: the earlier range keeps an equal d²,
so the joined winner is still the first minimum, and the flag is set when
the two winners are different rows. ``colsweep_plain(splits=S)`` runs the
plain version the same way. K3's CTAs join across target splits by a
64-bit ``atomicMin`` on (d² bits, row), which keeps the lowest row among
equal d², the same first minimum.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from iterativeclosestpoint_tpu_torch.ops import _build
from iterativeclosestpoint_tpu_torch.ops.bruteforce import (
    nn_bruteforce,
    winner_dist,
)

TILE_Q = 128
BIG = 1.0e18
MAX_SLABS = 16  # csrc/sweep.cuh kMaxSlots
MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y (K3's splits)
# A K3 CTA's fixed cost (query and first-pass staging, group merge,
# atomics) in rows of scan. chip_smoke.py phase 3 times K3 over split
# counts; on an H100 its 29,412 x 29,412 sweep fits 130-330 rows, and any
# value from 100 to 1,000 gives the same splits at the main paths' shapes.
K3_CTA_SETUP_ROWS = 188

LAUNCHES = {"colsweep_fused": 0, "colsweep": 0, "brute_nn": 0}
LAUNCH_SHAPES: collections.Counter = collections.Counter()
_TALLY_LOCK = threading.Lock()


def reset_launches() -> None:
    with _TALLY_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        LAUNCH_SHAPES.clear()


def _tally(name, shape) -> None:
    with _TALLY_LOCK:
        LAUNCHES[name] += 1
        LAUNCH_SHAPES[(name, shape)] += 1


def _check(name, x, dtype, shape=None):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name, shape, device, *args):
    """Launch ``name`` on ``device``'s current stream, with ``device`` as
    the current device for the launch."""
    fn = getattr(_build.library(name), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    _tally(name, shape)


def merge_best_plain(a, b):
    """Join two partial winners (d2, row, tie) of the same queries, ``a``
    over a contiguous range of the scan order before ``b``'s range: the
    rule of ``csrc/sweep.cuh::merge_best``. A smaller d² wins with its tie
    flag; on an equal d² ``a``'s row stays (``b``'s when ``a`` found none,
    row −1) and the flag is set when either flag is or the two rows
    differ. The same row in both ranges is not a tie."""
    ad, ar, at = a
    bd, br, bt = b
    take_b = bd < ad
    eq = ad == bd
    d2 = torch.where(take_b, bd, ad)
    row = torch.where(take_b | (eq & (ar < 0)), br, ar)
    both = (ar >= 0) & (br >= 0) & (ar != br)
    tie = torch.where(take_b, bt, torch.where(eq, at | bt | both, at))
    return d2, row, tie


def _partial_best(d2, valid, rows):
    """(d2, row, tie) of each query over a range of lanes: the first
    minimum, −1 and 1e18 where no valid lane falls below 1e18."""
    dmin, arg = d2.min(dim=2)
    win = torch.gather(rows, 1, arg)  # (tb, 128) winner rows
    found = dmin < BIG
    tie = found & (
        (d2 == dmin[:, :, None]) & valid
        & (rows[:, None, :] != win[:, :, None])
    ).any(dim=2)
    return (torch.where(found, dmin, torch.full_like(dmin, BIG)),
            torch.where(found, win, torch.full_like(win, -1)), tie)


def colsweep_plain(base, q, tgt_t, *, slabs: int, trange: int,
                   fused: bool, slack=None, splits: int = 1):
    """Plain PyTorch version of K1 (``fused=True``) and K2.

    With ``splits`` > 1 each tile's slabs·trange lanes are cut into
    contiguous ranges of ⌈lanes / splits⌉, each range is swept on its own
    and the partial winners are joined in scan order by
    ``merge_best_plain``, as the kernels join theirs; the result equals the
    unsplit sweep on every row. Tiles run in groups so the
    (tiles, 128, slabs·trange) d² block stays near 2²⁵ floats on the card
    and, on the CPU, near 2²² floats per torch thread up to 2²⁵: on one
    thread a block nearer the cache runs faster, on many a large block
    amortises each operation's fork and join across the threads.
    """
    t = base.shape[0]
    dev = q.device
    L = slabs * trange
    width = -(-L // splits)
    out = torch.empty((t, 8, TILE_Q), dtype=torch.float32, device=dev)
    lanes = torch.arange(trange, dtype=torch.int64, device=dev)
    block = (1 << 25 if q.is_cuda
             else min((1 << 22) * torch.get_num_threads(), 1 << 25))
    step = max(1, block // (TILE_Q * L))
    for t0 in range(0, t, step):
        t1 = min(t, t0 + step)
        tb = t1 - t0
        rows = (base[t0:t1].to(torch.int64)[:, :, None] + lanes).reshape(
            tb, L)
        cx, cy, cz = (tgt_t[r][rows][:, None, :] for r in range(3))
        qb = q[t0 * TILE_Q:t1 * TILE_Q].reshape(tb, TILE_Q, 3)
        # d2 = (dx·dx + dy·dy) + dz·dz, in place: (tb, 128, L).
        d2 = qb[:, :, 0:1] - cx
        d2.mul_(d2)
        d = qb[:, :, 1:2] - cy
        d2.add_(d.mul_(d))
        torch.sub(qb[:, :, 2:3], cz, out=d)
        d2.add_(d.mul_(d))
        if fused:
            v = slack[t0:t1].to(torch.int64)
            u = lanes - (v & 127)[:, :, None]
            valid = ((u >= 0) & (u < (v >> 7)[:, :, None])).reshape(tb, 1, L)
            d2.masked_fill_(~valid, BIG)
        else:
            valid = torch.ones((tb, 1, L), dtype=torch.bool, device=dev)
        best = None
        for l0 in range(0, L, width):
            part = _partial_best(d2[:, :, l0:l0 + width],
                                 valid[:, :, l0:l0 + width],
                                 rows[:, l0:l0 + width])
            best = part if best is None else merge_best_plain(best, part)
        dmin, win, tie = best
        found = win >= 0
        ext = tgt_t[0:6][:, win.clamp(min=0)]  # (6, tb, 128)
        out[t0:t1, 0:6] = torch.where(
            found[None], ext, torch.zeros_like(ext)).permute(1, 0, 2)
        out[t0:t1, 6] = dmin
        out[t0:t1, 7] = torch.where(tie, 2.0, 1.0)
    return out


def sweep_splits(tiles: int, slabs: int, trange: int, device) -> int:
    """CTAs per tile for K2: about 4 CTAs per SM over all tiles, each
    split at least one staged pass of 1024 rows (1 once the tiles alone
    fill the card)."""
    ctas = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(ctas // max(tiles, 1), slabs * trange // 1024))


def colsweep(base, q, tgt_t, *, slabs: int, trange: int, fused: bool,
             slack=None):
    """K1 (``fused=True``, with ``slack``) or K2 over ``t`` tiles.

    ``base`` (t, slabs) int32: 128-aligned row bases, ≤ M; ``slack``
    (t, slabs) int32: lo | (width << 7) per slot (K1 only); ``q``
    (t·128, 3) f32; ``tgt_t`` (8, M + trange) f32. Returns (t, 8, 128).
    K1's slots must be disjoint row ranges, as the slab and z-column
    windows are (its kernel counts an equal d² as another row); K2's slabs
    may overlap. The kernels take at most 16 slabs.
    """
    t = base.shape[0]
    _check("base", base, torch.int32, (t, slabs))
    _check("q", q, torch.float32, (t * TILE_Q, 3))
    _check("tgt_t", tgt_t, torch.float32)
    if tgt_t.shape[0] != 8 or tgt_t.shape[1] < trange:
        raise ValueError(f"tgt_t: expected (8, M + {trange}), "
                         f"got {tuple(tgt_t.shape)}")
    if fused:
        _check("slack", slack, torch.int32, (t, slabs))
    if q.device.type == "cpu":
        return colsweep_plain(base, q, tgt_t, slabs=slabs, trange=trange,
                              fused=fused, slack=slack)
    tensors = [base, q, tgt_t] + ([slack] if fused else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("colsweep: all tensors must be on one device")
    if slabs > MAX_SLABS or tgt_t.shape[1] >= 2**31:
        raise ValueError(f"colsweep: the kernels take ≤ {MAX_SLABS} slabs "
                         "and row indices that fit int32")
    # One launch covers every tile. The JAX package split the tile axis
    # into parts (``_sweep_kernel_call``, pallas_nn.py:1385-1421) because
    # its scalar-prefetch base table had to fit the TPU's 1 MB SMEM; each
    # CTA here reads its own bases from device memory, so that split is
    # left out on purpose.
    out = torch.empty((t, 8, TILE_Q), dtype=torch.float32, device=q.device)
    stride = tgt_t.shape[1]
    shape = (t, slabs, trange)
    if fused:
        _launch("colsweep_fused", shape, q.device, base.data_ptr(),
                slack.data_ptr(), q.data_ptr(), tgt_t.data_ptr(), stride, t,
                slabs, trange, out.data_ptr())
    else:
        splits = sweep_splits(t, slabs, trange, q.device)
        # Per-split partials (d² bits, row, tie) for the merge launch.
        part = (torch.empty((3, t, splits, TILE_Q), dtype=torch.int32,
                            device=q.device) if splits > 1 else None)
        _launch("colsweep", shape, q.device, base.data_ptr(), q.data_ptr(),
                tgt_t.data_ptr(), stride, t, slabs, trange, splits,
                0 if part is None else part.data_ptr(), out.data_ptr())
    return out


@functools.lru_cache(maxsize=256)
def brute_splits(n: int, m: int, sms: int) -> int:
    """Target splits S for K3 on a card with ``sms`` SMs.

    Every CTA scans ⌈m / S⌉ rows for one tile of queries, so the busiest
    SM runs ⌈tiles·S / sms⌉ equal CTAs, and the kernel's time goes as
    ⌈tiles·S / sms⌉ · (⌈m / S⌉ + ``K3_CTA_SETUP_ROWS``). S minimises that,
    with each split at least one staged pass of 1024 rows and, where the
    rows allow, at least 3 CTAs per SM (at 1-2 the SM issues slower)."""
    tiles = -(-n // TILE_Q)
    hi = max(1, min(m // 1024, MAX_GRID_Y))
    lo = min(hi, -(-3 * sms // tiles))
    return min(range(lo, hi + 1), key=lambda s: (
        -(-tiles * s // sms) * (-(-m // s) + K3_CTA_SETUP_ROWS), s))


def _check_brute(query, target):
    _check("query", query, torch.float32)
    _check("target", target, torch.float32)
    if query.ndim != 2 or query.shape[1] != 3 or target.ndim != 2 \
            or target.shape[1] != 3:
        raise ValueError("nn_brute: query and target must be (N, 3), (M, 3)")


def brute_keys(query, target, splits: int):
    """Launch K3 over ``splits`` contiguous target splits (CUDA tensors
    only). Returns (N,) int64 keys, (d² bits << 32) | row of each query's
    first minimum, all ones where no candidate fell below 1e18. The split
    count never changes the keys."""
    _check_brute(query, target)
    if query.device.type != "cuda" or target.device != query.device:
        raise ValueError("brute_keys: query and target on one CUDA device")
    n, m = query.shape[0], target.shape[0]
    if m >= 2**31:
        raise ValueError("nn_brute: target rows must fit int32")
    splits = max(1, min(splits, m, MAX_GRID_Y))
    keys = torch.full((n,), -1, dtype=torch.int64, device=query.device)
    _launch("brute_nn", (n, m), query.device, query.data_ptr(), n,
            target.data_ptr(), m, splits, -(-m // splits), keys.data_ptr())
    return keys


def nn_brute(query, target):
    """K3: exact 1-NN, first-minimum order. Returns (idx (N,) int64,
    dist (N,)) like ``nn_bruteforce``, its plain version; the distance is
    recomputed from the winner as there."""
    _check_brute(query, target)
    if query.device.type == "cpu":
        return nn_bruteforce(query, target)
    sms = torch.cuda.get_device_properties(query.device).multi_processor_count
    keys = brute_keys(query, target,
                      brute_splits(query.shape[0], target.shape[0], sms))
    # All-ones keys (no candidate below 1e18) map to row 0, the plain
    # version's initial winner.
    idx = torch.where(keys < 0, 0, keys & 0xFFFFFFFF)
    return idx, winner_dist(query, target, idx)


def nn_exact(query, target):
    """Exact 1-NN in the query's dtype: f32 through K3 (``nn_brute``; its
    plain version for CPU tensors), f64 through the plain
    ``nn_bruteforce`` (the oracle-parity path, which K3 does not cover)."""
    if query.dtype == torch.float32:
        return nn_brute(query.contiguous(), target.contiguous())
    return nn_bruteforce(query, target)
