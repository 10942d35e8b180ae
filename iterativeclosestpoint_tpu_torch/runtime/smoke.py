"""Kernel smoke check: the exact NN chains against brute force.

Counterpart of the JAX package's ``runtime/smoke.py``. On one small shape
per regime (16,384 queries against 50,000 targets) the full exact chain
(``make_pallas_nn_device`` + ``nn_colsweep_exact``) must give the same
matched points as brute force: the slab sweep on a terrain target, the
z-column sweep on a uniform cube. On the card that holds K1, K1 over the
z-window slots and the repair chain (K2, K3 tiers) against K3 (``nn_brute``);
on the CPU the same chains run the plain versions against
``ops/bruteforce.py::nn_bruteforce``. Any mismatch raises. Standalone::

    python -m iterativeclosestpoint_tpu_torch.runtime.smoke
"""

from __future__ import annotations

import time


def kernel_smoke(n: int = 16384, m: int = 50_000, seed: int = 3,
                 device=None) -> dict:
    """Exactness of both fine sweeps' full repair chains against brute
    force on one shape each (surface regime: the slab sweep; volume
    regime: the z-column sweep). ``device``: None means the card, "cpu"
    the plain versions. Raises AssertionError on any mismatch; returns the
    wall seconds of each chain's call."""
    import numpy as np
    import torch

    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
        grouped_tile_order_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import nn_brute
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
    )
    from iterativeclosestpoint_tpu_torch.utils.device import resolve_device
    from iterativeclosestpoint_tpu_torch.utils.synth import make_cloud

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for kernel, kind in (("sweep", "terrain"), ("zcol", "uniform")):
        if kind == "terrain":
            tgt = make_cloud(m, seed=seed, kind="terrain", extent=50.0)
        else:
            tgt = rng.uniform(-25, 25, (m, 3))
        q = tgt[rng.choice(m, n, replace=False)] + rng.normal(
            0, 0.05, (n, 3)
        )
        offset = (tgt.min(axis=0) + tgt.max(axis=0)) / 2.0
        tgtl = (tgt - offset).astype(np.float32)
        ql = (q - offset).astype(np.float32)
        tgt_dev = torch.as_tensor(tgtl, device=dev)

        nn_fn, state, R = make_pallas_nn_device(
            tgtl, resolution=16, kernel=kernel, target_dev=tgt_dev,
        )
        grid = state[0]
        rows, w = grouped_tile_order_device(
            torch.as_tensor(ql, device=dev), grid.origin, grid.cell_size,
            resolution=R, group=nn_fn.layout_group,
        )
        q_dev = torch.as_tensor(ql, device=dev)[rows]

        t0 = time.perf_counter()
        matched, dist = nn_fn(q_dev, tgt_dev, state)[:2]
        matched = matched.cpu().numpy()
        dist = dist.cpu().numpy()
        dt = time.perf_counter() - t0

        bi, bd = nn_brute(q_dev, tgt_dev)
        bm = tgtl[bi.cpu().numpy()]
        real = w.cpu().numpy() > 0
        if not np.array_equal(matched[real], bm[real]):
            bad = (matched[real] != bm[real]).any(axis=1).sum()
            raise AssertionError(
                f"[{kernel}] {bad}/{real.sum()} matched coordinates "
                "differ from brute force"
            )
        derr = np.abs(dist[real] - bd.cpu().numpy()[real]).max()
        if derr > 1e-5:
            raise AssertionError(f"[{kernel}] distance mismatch {derr}")
        out[kernel] = dt
    return out


def main() -> int:
    res = kernel_smoke()
    for k, dt in res.items():
        print(f"smoke[{k}]: exact vs brute force OK "
              f"({dt*1e3:.0f} ms first call incl. launch)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
