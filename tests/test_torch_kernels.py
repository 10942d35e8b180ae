"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one (the CPU suite runs
the plain versions through the parity tests instead). On a machine with a
card and no JAX, run them without the repository's conftest (which
imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerance: none. With FMA contraction forbidden the kernels and the plain
versions round the same operations in the same order, so winners and d²
are bit-identical on rows without an exact tie, and the tie flags equal.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from _k3_planted import planted
from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
from iterativeclosestpoint_tpu_torch.ops.bruteforce import nn_bruteforce
from iterativeclosestpoint_tpu_torch.ops.normals import (
    estimate_normals_cellpca_device,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    build_grid,
    build_zgrid,
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
    nn_colsweep_exact,
    sweep_window,
    zcol_window,
)
from iterativeclosestpoint_tpu_torch.utils.synth import make_cloud

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _normals(t_dev, lo, cell, R):
    """Cell-PCA normals of the target on the card (the plane path's)."""
    return estimate_normals_cellpca_device(
        t_dev, lo, torch.tensor(cell, dtype=torch.float32,
                                device=t_dev.device), resolution=R)


def _setup(dev, n=60_000, R=32, trange=768, dup=False, normals=False):
    tgt = make_cloud(n, seed=3, extent=50.0).astype(np.float32)
    if dup:
        tgt[n // 2:] = tgt[: n - n // 2]
    rng = np.random.default_rng(4)
    q = tgt + rng.normal(0, 0.05, tgt.shape).astype(np.float32)
    t_dev = torch.as_tensor(tgt, device=dev)
    lo = tgt.min(axis=0)
    cell = float((tgt.max(axis=0).astype(np.float64) - lo).max()) / R
    lo_dev = torch.as_tensor(lo, device=dev)
    grid = build_grid(t_dev, lo_dev,
                      torch.tensor(cell, dtype=torch.float32, device=dev),
                      resolution=R, trange=trange,
                      normals=_normals(t_dev, lo_dev, cell, R) if normals
                      else None)
    q_dev = torch.as_tensor(q, device=dev)
    rows, _ = grouped_tile_order_device(q_dev, grid.origin, grid.cell_size,
                                        resolution=R)
    return tgt, t_dev, grid, q_dev[rows]


def _zcol_setup(dev, zrange, n=200_000, R=32, normals=False):
    """The volume regime's window: a uniform 10:10:2 box on per-axis cells,
    an (x, y)-group layout and 12 z-window slots per tile."""
    tgt = make_cloud(n, seed=5, kind="uniform", extent=50.0).astype(
        np.float32)
    q = tgt + np.random.default_rng(6).normal(0, 0.05, tgt.shape).astype(
        np.float32)
    lo, hi = tgt.min(axis=0).astype(np.float64), tgt.max(axis=0)
    cell3 = torch.as_tensor(np.maximum((hi - lo) / R, 1e-9),
                            dtype=torch.float32, device=dev)
    t_dev = torch.as_tensor(tgt, device=dev)
    lo_dev = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    nrm = (_normals(t_dev, lo_dev, float((hi - lo).max()) / R, R)
           if normals else None)
    grid = build_zgrid(t_dev, lo_dev, cell3, resolution=R, zrange=zrange,
                       normals=nrm)
    q_dev = torch.as_tensor(q, device=dev)
    rows, _ = grouped_tile_order_device(q_dev, grid.origin, grid.cell_size,
                                        resolution=R, group="xy")
    return zcol_window(q_dev[rows], grid, resolution=R, tile_q=128,
                       zrange=zrange, fused=12 * zrange <= 24576), grid


def _same(out_k, out_p):
    tie = out_p[:, 7] != 1.0
    assert torch.equal(out_k[:, 7] != 1.0, tie)
    free = (~tie)[:, None, :].expand(-1, 7, -1)
    assert torch.equal(out_k[:, 0:7][free], out_p[:, 0:7][free])


def _check_normals_rows(grid, trange):
    """Rows 3-5 hold real unit normals (the plane path's grids)."""
    nrm = grid.tgt_t[3:6, :-trange]
    assert float(nrm.abs().amax()) <= 1.0 + 1e-6
    assert float(nrm[2].abs().sum()) > 0


# "normals" cases: rows 3-5 of the grid hold real normals (point-to-plane)
# and each kernel must return its winner's, bit-identical to plain.
@pytest.mark.parametrize("case", ["tie_free", "dup", "zcol", "normals",
                                  "zcol_normals"])
def test_k1_fused_matches_plain(card, case):
    if case.startswith("zcol"):  # 12 z-window slots of 512 rows (volume)
        win, grid = _zcol_setup(card, 512, normals=case == "zcol_normals")
        kw = dict(slabs=12, trange=512, fused=True, slack=win.slack)
    else:
        _, _, grid, q = _setup(card, dup=case == "dup",
                               normals=case == "normals")
        win = sweep_window(q, grid, resolution=32, tile_q=128, slabs=4,
                           trange=768, fused=True)
        kw = dict(slabs=4, trange=768, fused=True, slack=win.slack)
    if case.endswith("normals"):
        _check_normals_rows(grid, kw["trange"])
    args = (win.base, win.q32, grid.tgt_t)
    before = sk.LAUNCHES["colsweep_fused"]
    out_k = sk.colsweep(*args, **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["colsweep_fused"] == before + 1
    _same(out_k, sk.colsweep_plain(*args, **kw))


@pytest.mark.parametrize("case", ["tie_free", "dup", "zcol", "normals"])
def test_k2_matches_plain(card, case):
    if case == "zcol":  # zcol's slot-wise form: 12 unmasked slots × 3072
        win, grid = _zcol_setup(card, 3072)
        n_t = 256  # a slice of the tiles keeps the plain version short
        win = win._replace(base=win.base[:n_t].contiguous(),
                           q32=win.q32[:n_t * 128].contiguous())
        kw = dict(slabs=12, trange=3072, fused=False)
    else:
        _, _, grid, q = _setup(card, R=8, trange=8192, dup=case == "dup",
                               normals=case == "normals")
        win = sweep_window(q, grid, resolution=8, tile_q=128, slabs=4,
                           trange=8192, fused=False)
        kw = dict(slabs=4, trange=8192, fused=False)
    if case == "normals":
        _check_normals_rows(grid, kw["trange"])
    args = (win.base, win.q32, grid.tgt_t)
    before = sk.LAUNCHES["colsweep"]
    out_k = sk.colsweep(*args, **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["colsweep"] == before + 1
    _same(out_k, sk.colsweep_plain(*args, **kw))


def _odd_slots(dev, stride_mod4, dup, tiles=48, slabs=5, trange=512):
    """K1 inputs by hand: per tile, ``slabs`` disjoint slots in shuffled
    order, each inside its own ``trange`` rows, with lo ≠ 0, lengths not a
    multiple of 4 (some capped at trange − lo), empty slots and a tile
    whose slots are all empty; the target has M + trange ≡ ``stride_mod4``
    (mod 4) columns, so its y and z rows are not 16-byte aligned unless
    that is 0."""
    rng = np.random.default_rng(7 + stride_mod4)
    m = slabs * trange + (stride_mod4 - slabs * trange) % 4
    pts = rng.uniform(0, 10, (m, 3)).astype(np.float32)
    if dup:
        pts[m // 2:] = pts[: m - m // 2]
    tgt_t = torch.full((8, m + trange), 1e6)
    tgt_t[0:3, :m] = torch.as_tensor(pts).T
    tgt_t[3:6] = torch.arange(m + trange, dtype=torch.float32)
    base = np.stack([rng.permutation(slabs) * trange for _ in range(tiles)])
    lo = rng.integers(1, 128, (tiles, slabs))
    width = rng.integers(0, trange + 1, (tiles, slabs))
    width[rng.random((tiles, slabs)) < 0.2] = 0
    width[3] = 0  # a tile with every slot empty
    q = pts[rng.integers(0, m, tiles * 128)] + rng.normal(
        0, 0.05, (tiles * 128, 3)).astype(np.float32)
    as_dev = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa
    return (as_dev(base, torch.int32), as_dev(q, torch.float32),
            tgt_t.to(dev), as_dev(lo | (width << 7), torch.int32), slabs,
            trange)


@pytest.mark.parametrize("stride_mod4, dup", [(0, False), (3, False),
                                              (1, True)])
def test_k1_odd_slots_match_plain(card, stride_mod4, dup):
    base, q, tgt_t, slack, slabs, trange = _odd_slots(card, stride_mod4, dup)
    assert tgt_t.shape[1] % 4 == stride_mod4
    kw = dict(slabs=slabs, trange=trange, fused=True, slack=slack)
    out_k = sk.colsweep(base, q, tgt_t, **kw)
    torch.cuda.synchronize()
    out_p = sk.colsweep_plain(base, q, tgt_t, **kw)
    _same(out_k, out_p)
    assert torch.all(out_k[3, 6] == sk.BIG)  # the empty tile
    assert torch.all(out_k[3, 7] == 1.0)
    if dup:
        assert int((out_p[:, 7] == 2.0).sum()) > 0


@pytest.mark.parametrize("tiles, dup", [(64, False), (512, False),
                                        (64, True)])
def test_k2_split_matches_plain(card, tiles, dup):
    """K2 at the repair chain's first stage (64 tiles: split across CTAs
    and merged) and at its full budget (512 tiles: one CTA per tile)."""
    _, _, grid, q = _setup(card, n=70_000, R=8, trange=8192, dup=dup)
    q = q[:tiles * 128].contiguous()
    win = sweep_window(q, grid, resolution=8, tile_q=128, slabs=4,
                       trange=8192, fused=False)
    splits = sk.sweep_splits(tiles, 4, 8192, card)
    assert (splits > 1) == (tiles == 64)
    kw = dict(slabs=4, trange=8192, fused=False)
    args = (win.base, win.q32, grid.tgt_t)
    before = sk.LAUNCHES["colsweep"]
    out_k = sk.colsweep(*args, **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["colsweep"] == before + 1
    _same(out_k, sk.colsweep_plain(*args, **kw))


@pytest.mark.parametrize("dup", [False, True])
def test_k3_matches_plain(card, dup):
    tgt, t_dev, _, q = _setup(card, n=20_000, dup=dup)
    q = q[:5000].contiguous()
    ik, dk = sk.nn_brute(q, t_dev)
    ip, dp = nn_bruteforce(q, t_dev)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)


# (queries, targets): partial last tiles (n = 1, 100, 129, 29,412), partial
# steps and passes (m = 5, 1,023, 1,025, 4,099), many splits (512 ×
# 200,000), and a query ~1e10 m from every target.
K3_EDGES = {
    "n1": (1, 3000), "n100": (100, 3000), "n129": (129, 3000),
    "n29412": (29_412, 29_412), "m5": (300, 5), "m1023": (300, 1023),
    "m1025": (300, 1025), "m4099": (300, 4099),
    "many_splits": (512, 200_000), "far": (100, 3000),
}


@pytest.mark.parametrize("case", list(K3_EDGES))
def test_k3_edges_match_plain(card, case):
    """K3 at its edges, with exact d² ties planted across every split,
    warp-quarter, step and pass seam of the wrapper's split layout: equal
    to the plain version bit for bit, the lower row winning each tie."""
    n, m = K3_EDGES[case]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits = sk.brute_splits(n, m, sms)
    if case == "many_splits":
        assert splits >= 64
    q, tgt, rows = planted(n, m, splits, seed=n + m)
    k = min(len(rows), n)
    if case == "far":
        q[-1] = (1e10, -1e10, 1e10)
        k = min(k, n - 1)
    qd = torch.as_tensor(q, device=card)
    td = torch.as_tensor(tgt, device=card)
    before = sk.LAUNCHES["brute_nn"]
    ik, dk = sk.nn_brute(qd, td)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["brute_nn"] == before + 1
    ip, dp = nn_bruteforce(qd, td)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert k > 0 and torch.equal(ik[:k].cpu(), torch.as_tensor(rows[:k]))
    if case == "far":
        assert int(ik[-1]) == 0


def test_exact_chain_on_card_matches_cpu(card):
    tgt, t_dev, grid, q = _setup(card, n=30_000, R=32, trange=2048)
    shifted = (q + 1.5 * grid.cell_size).contiguous()
    coarse = build_grid(t_dev, grid.origin, grid.cell_size * 4,
                        resolution=8, trange=8192)
    kw = dict(resolution=32, coarse_resolution=8, slabs=4, trange=2048,
              coarse_trange=8192)
    m_k, _, d_k = nn_colsweep_exact(shifted, t_dev, grid, coarse, **kw)
    cpu = lambda g: type(g)(*(x.cpu() for x in g))  # noqa: E731
    m_p, _, d_p = nn_colsweep_exact(shifted.cpu(), t_dev.cpu(), cpu(grid),
                                    cpu(coarse), **kw)
    assert torch.equal(m_k.cpu(), m_p) and torch.equal(d_k.cpu(), d_p)


def test_exact_chain_with_normals_on_card_matches_cpu(card):
    """The repair chain with normals: a shifted query forces coarse
    repair, and far outliers (their own tiles at the end of the layout)
    the brute tier; every row's normal is its winner's, on the card as on
    the CPU."""
    tgt, t_dev, grid, q = _setup(card, n=30_000, R=32, trange=2048,
                                 normals=True)
    nrm = _normals(t_dev, grid.origin, float(grid.cell_size), 32)
    far = torch.as_tensor(np.random.default_rng(8).uniform(
        -200, 200, (300, 3)).astype(np.float32), device=card)
    shifted = torch.cat([q + 1.5 * grid.cell_size, far]).contiguous()
    coarse = build_grid(t_dev, grid.origin, grid.cell_size * 4,
                        resolution=8, trange=8192, normals=nrm)
    kw = dict(resolution=32, coarse_resolution=8, slabs=4, trange=2048,
              coarse_trange=8192)
    before = sk.LAUNCHES["brute_nn"]
    m_k, n_k, d_k = nn_colsweep_exact(shifted, t_dev, grid, coarse, nrm,
                                      **kw)
    assert sk.LAUNCHES["brute_nn"] > before
    cpu = lambda g: type(g)(*(x.cpu() for x in g))  # noqa: E731
    m_p, n_p, d_p = nn_colsweep_exact(shifted.cpu(), t_dev.cpu(), cpu(grid),
                                      cpu(coarse), nrm.cpu(), **kw)
    assert torch.equal(m_k.cpu(), m_p) and torch.equal(d_k.cpu(), d_p)
    assert torch.equal(n_k.cpu(), n_p)
    d0, idx = cKDTree(tgt).query(m_p.numpy())
    assert not d0.any()
    assert torch.equal(nrm.cpu()[torch.as_tensor(idx)], n_p)


@pytest.mark.parametrize("backend", ["cellblock", "hashgrid"])
def test_grid_backends_on_card_match_cpu(card, backend):
    """The test and reference backends on the card: near queries and far
    outliers (their brute repairs launch K3) give the CPU's winners and
    distances bit for bit, and the exact ones."""
    from iterativeclosestpoint_tpu_torch.ops import cellblock, hashgrid

    tgt = make_cloud(30_000, seed=3, extent=50.0)
    rng = np.random.default_rng(9)
    q = np.vstack([tgt[rng.choice(30_000, 6000)]
                   + rng.normal(0, 0.05, (6000, 3)),
                   rng.uniform(-200, 200, (300, 3))]).astype(np.float32)
    q = q[cellblock.morton_order(q, 32)]
    out = []
    for dev in (card, torch.device("cpu")):
        if backend == "cellblock":
            fn, state, _ = cellblock.make_cellblock_nn(tgt, 32, device=dev)
        else:
            fn, state = hashgrid.make_hashgrid_nn(tgt, 32, capacity=8,
                                                  device=dev)
        before = sk.LAUNCHES["brute_nn"]
        t_dev = torch.as_tensor(tgt.astype(np.float32), device=dev)
        m, d = fn(torch.as_tensor(q, device=dev), t_dev, state)
        out.append((m.cpu(), d.cpu(), sk.LAUNCHES["brute_nn"] - before))
    (m_k, d_k, k3), (m_p, d_p, _) = out
    assert k3 > 0
    assert torch.equal(m_k, m_p) and torch.equal(d_k, d_p)
    d_ref, _ = cKDTree(tgt.astype(np.float32)).query(q)
    np.testing.assert_allclose(d_k.numpy(), d_ref, atol=1e-6)


def test_pose_graph_on_card_matches_cpu(card):
    """The f64 Gauss-Newton on the card: the CPU's poses within 1e-12, and
    two card solves bit-equal (the block sums are a dense product)."""
    from iterativeclosestpoint_tpu_torch.models.posegraph import (
        optimize_pose_graph,
    )
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        random_rigid_transform,
    )

    poses = [np.eye(4)] + [random_rigid_transform(seed=20 + s)
                           for s in range(1, 6)]
    edges = [(i, j, np.linalg.inv(poses[i]) @ poses[j])
             for i in range(6) for j in range(i + 1, 6) if j - i <= 2]
    kw = dict(n_poses=6, robust="huber", max_iterations=10)
    a = optimize_pose_graph(edges, device=card, **kw)
    b = optimize_pose_graph(edges, device=card, **kw)
    c = optimize_pose_graph(edges, device="cpu", **kw)
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_allclose(a.poses, c.poses, atol=1e-12)
    assert a.iterations == c.iterations


def test_four_mesh_ranks_on_one_card(card):
    """Four mesh ranks on one card (threads launching the kernels on the
    card's stream): the data-parallel and the partitioned paths launch K1
    from the rank threads and give the 4-rank CPU result: the same
    iterations and stop code, within 1e-4 m (f32, other summation order
    on the card). Plane mode: it converges in a few iterations, where
    point mode slides on this terrain and two f32 orders drift apart
    (ROADMAP §3)."""
    from iterativeclosestpoint_tpu_torch.parallel import (
        icp_register_partitioned,
        icp_register_sharded,
        make_mesh,
    )
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    src, tgt, _ = make_registration_pair(n=20_000, seed=7, noise_sigma=0.02,
                                         kind="terrain")
    kw = dict(max_iterations=8, tolerance=0.0, return_registered=False,
              estimator="plane")
    for fn, extra in ((icp_register_sharded, dict(nn_backend="pallas")),
                      (icp_register_partitioned,
                       dict(local_search="pallas", halo=0.5))):
        sk.reset_launches()
        on_card = fn(src, tgt, mesh=make_mesh(devices=["cuda:0"] * 4),
                     **kw, **extra)
        launches = dict(sk.LAUNCHES)
        on_cpu = fn(src, tgt, mesh=make_mesh(devices=["cpu"] * 4), **kw,
                    **extra)
        assert launches["colsweep_fused"] > 0, (fn.__name__, launches)
        assert (on_card.iterations, on_card.stop_reason) == (
            on_cpu.iterations, on_cpu.stop_reason)
        gap = np.abs((src @ on_card.transform[:3, :3].T
                      + on_card.transform[:3, 3])
                     - (src @ on_cpu.transform[:3, :3].T
                        + on_cpu.transform[:3, 3])).max()
        assert gap < 1e-4, (fn.__name__, gap)


def test_mesh_across_cards(card):
    """One rank per visible card (needs two or more; skips otherwise):
    the collectives move tensors between cards (a rank's fold runs on its
    own card, every rank holding the same bits), the cross-rank tie
    returns B exactly, and the data-parallel and partitioned paths give
    the 1-rank result's iterations and stop code within 1e-4 m."""
    from iterativeclosestpoint_tpu_torch.parallel import (
        icp_register_partitioned,
        icp_register_sharded,
        make_mesh,
    )
    from iterativeclosestpoint_tpu_torch.parallel import partition as tpart
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    mesh = make_mesh()
    sums = mesh.run(lambda c: c.psum(
        torch.full((3,), 0.1 * (c.rank + 1), device=c.device)))
    assert all(s.device == d for s, d in zip(sums, mesh.devices))
    assert len({tuple(s.cpu().tolist()) for s in sums}) == 1

    base = np.random.default_rng(7).uniform(-50, 50, (1000, 3))
    B = np.array([[+1.0, 0.0, 200.0]])
    A = np.array([[-1.0, 0.0, 200.0]])
    two = make_mesh(n_devices=2)
    part = tpart.build_partition(np.concatenate([base, B, A]), two.devices,
                                 1e-3)

    def tie(comm):
        r = comm.rank
        state = (part.halo_pts[r], part.halo_idx[r], None,
                 torch.tensor(part.x_lo[r], dtype=torch.float32,
                              device=comm.device),
                 torch.tensor(part.x_hi[r], dtype=torch.float32,
                              device=comm.device), None, None)
        nn = tpart._partitioned_nn(comm, state, local_search="brute",
                                   with_normals=False, repair_budget=64,
                                   repair_passes=2)
        return nn(torch.tensor([[0.0, 0.0, 200.0]], device=comm.device),
                  None, None)[0].cpu()

    for m in two.run(tie):
        np.testing.assert_array_equal(m.numpy(), B.astype(np.float32))

    src, tgt, _ = make_registration_pair(n=20_000, seed=7, noise_sigma=0.02,
                                         kind="terrain")
    kw = dict(max_iterations=8, tolerance=0.0, return_registered=False,
              estimator="plane")
    for fn, extra in ((icp_register_sharded, dict(nn_backend="pallas")),
                      (icp_register_partitioned,
                       dict(local_search="pallas", halo=0.5))):
        many = fn(src, tgt, mesh=mesh, **kw, **extra)
        one = fn(src, tgt, mesh=make_mesh(n_devices=1), **kw, **extra)
        assert (many.iterations, many.stop_reason) == (one.iterations,
                                                       one.stop_reason)
        gap = np.abs((src @ many.transform[:3, :3].T + many.transform[:3, 3])
                     - (src @ one.transform[:3, :3].T
                        + one.transform[:3, 3])).max()
        assert gap < 1e-4, (fn.__name__, gap)
