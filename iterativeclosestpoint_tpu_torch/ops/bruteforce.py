"""Exact brute-force 1-NN in plain PyTorch.

Counterpart of the JAX package's ``ops/bruteforce.py::nn_bruteforce`` and
the plain version of the K3 kernel (``ops/sweep_kernels.py::nn_brute``).
Queries run in chunks and targets in tiles, so peak memory is
O(query_chunk × target_tile). Three rules make it the reference's twin:

* d² is the explicit difference ``((dx*dx + dy*dy) + dz*dz)``, never the
  |q|² − 2q·t + |t|² matmul form, which in f32 loses ~|coords|²·eps of d²
  at 50 m extents and corrupts the argmin near convergence;
* the argmin is the first minimum (``torch.min`` returns the first index
  within a tile; a later tile wins only with a strictly smaller d²);
* the returned distance is recomputed from the winner's coordinates.
"""

from __future__ import annotations

import torch


def sq_dist(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Squared distances ``((dx*dx + dy*dy) + dz*dz)`` of queries (..., n,
    3) against targets (..., m, 3) → (..., n, m), each operation its own
    tensor op so every step rounds on its own (the CUDA kernels use the
    same order with ``__fsub_rn``/``__fmul_rn``/``__fadd_rn``). In place,
    on two (..., n, m) buffers."""
    d2 = q[..., :, None, 0] - t[..., None, :, 0]
    d2.mul_(d2)
    d = q[..., :, None, 1] - t[..., None, :, 1]
    d2.add_(d.mul_(d))
    torch.sub(q[..., :, None, 2], t[..., None, :, 2], out=d)
    return d2.add_(d.mul_(d))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root. ``torch.sqrt`` of f32 on CUDA is not
    (it differs from the CPU's in the last bit on some inputs), so f32 goes
    through f64: rounding the f64 square root to f32 gives the correctly
    rounded f32 one (f64 carries more than 2·24+2 bits). Distances and
    certificate radii then agree bit for bit between the card and the
    CPU."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def winner_d2(query: torch.Tensor, target: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """Each query's d² to its winner ``target[idx]``, in the kernels' order
    ``((dx*dx + dy*dy) + dz*dz)``: the value the winner was chosen by."""
    diff = query - target[idx]
    return ((diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
            + diff[:, 2] * diff[:, 2])


def winner_dist(query: torch.Tensor, target: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Exact distance from each query to its winner ``target[idx]``."""
    return sqrt_rn(winner_d2(query, target, idx))


def nn_bruteforce(
    query: torch.Tensor,
    target: torch.Tensor,
    *,
    query_chunk: "int | None" = None,
    target_tile: "int | None" = None,
):
    """Exact 1-NN of each query point in the target cloud.

    Returns (indices (N,) int64, distances (N,) in the query dtype). The
    chunk sizes bound memory only; they do not change the result. By
    default a (query_chunk, target_tile) block is 2048 × 8192 on the card
    and 512 × 2048 on the CPU, where a block nearer the cache runs several
    times faster, on one thread as on eight.
    """
    if query_chunk is None or target_tile is None:
        query_chunk, target_tile = ((2048, 8192) if query.is_cuda
                                    else (512, 2048))
    n = query.shape[0]
    m = target.shape[0]
    big = 3.0e18 if query.dtype == torch.float64 else 1.0e18
    idx = torch.zeros((n,), dtype=torch.int64, device=query.device)
    for q0 in range(0, n, query_chunk):
        qb = query[q0:q0 + query_chunk]
        best = torch.full((qb.shape[0],), big, dtype=query.dtype,
                          device=query.device)
        best_idx = torch.zeros((qb.shape[0],), dtype=torch.int64,
                               device=query.device)
        for t0 in range(0, m, target_tile):
            d2 = sq_dist(qb, target[t0:t0 + target_tile])
            tile_min, tile_arg = d2.min(dim=1)
            take = tile_min < best
            best = torch.where(take, tile_min, best)
            best_idx = torch.where(take, tile_arg + t0, best_idx)
        idx[q0:q0 + query_chunk] = best_idx
    return idx, winner_dist(query, target, idx)
