"""Port parity: the partitioned target (``parallel/partition.py``: x-slabs
+ halo, collective repair) on CPU mesh ranks, against the port's single
device path and the JAX package's ``icp_register_partitioned`` on as
many virtual devices (mirrors ``tests/test_partition.py``; its ingest
cases are in ``test_torch_ingest.py`` and ``test_torch_multihost.py``).

Tolerances and why:

* slab selection, the device build against the host build, and each
  rank's slab grids, normals rows and query layout against the JAX
  per-device ones: exact (the same selections, sorts and gathers; the
  port's ragged slabs hold the JAX buffers' real rows);
* f64 trajectories against single device and against the JAX package on
  the same mesh size: the JAX test's rtol 1e-9 / atol 1e-9 (summation
  order only);
* f32 pallas (and z-column) local search against brute: the JAX test's
  rtol/atol 1e-5 (the two searches return the same exact neighbours; f32
  sums differ in order only through the layout);
* the cross-rank tie: the matched point is exactly the first target in
  original order, never an average.

About 60 s alone on one worker.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.parallel import partition as jpart
from iterativeclosestpoint_tpu.parallel.mesh import make_mesh as jax_mesh
from iterativeclosestpoint_tpu.utils.synth import (
    apply_transform_np,
    make_cloud,
    make_registration_pair,
    random_rigid_transform,
)
from iterativeclosestpoint_tpu_torch import (
    icp_register,
    icp_register_multiscale,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.parallel import make_mesh
from iterativeclosestpoint_tpu_torch.parallel import partition as tpart
from iterativeclosestpoint_tpu_torch.parallel.mesh import pad_to_multiple
from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset

F64 = torch.float64
F32 = torch.float32


def _mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _reg_err(Ta, Tb, pts):
    return float(np.abs(apply_transform_np(Ta, pts)
                        - apply_transform_np(Tb, pts)).max())


def _same(a, b, rtol=1e-9, atol=1e-9):
    assert a.iterations == b.iterations
    np.testing.assert_array_equal(a.history_valid, b.history_valid)
    np.testing.assert_allclose(a.history_rmse, b.history_rmse, rtol=rtol,
                               atol=1e-12)
    np.testing.assert_allclose(a.transform, b.transform, atol=atol)


def test_slab_selection_matches_jax():
    """Each rank's slab rows and original indices are the JAX buffer's
    real rows; the walls overlap by twice the halo."""
    rng = np.random.default_rng(0)
    tgt = rng.uniform(-50, 50, (10_000, 3))
    jp = jpart.build_partition(tgt, n_dev=4, halo=2.0)
    tp = tpart.build_partition(tgt, ["cpu"] * 4, 2.0, dtype=F32)
    j_pts, j_idx = np.asarray(jp.halo_pts), np.asarray(jp.halo_idx)
    assert sum(len(p) for p in tp.halo_pts) >= 10_000
    for r in range(4):
        m = len(tp.halo_pts[r])
        np.testing.assert_array_equal(tp.halo_pts[r].numpy(), j_pts[r, :m])
        np.testing.assert_array_equal(tp.halo_idx[r].numpy(), j_idx[r, :m])
        assert (j_pts[r, m:, 0] >= 1e5).all()  # the rest is JAX padding
    np.testing.assert_array_equal(tp.x_lo.astype(np.float32),
                                  np.asarray(jp.x_lo))
    np.testing.assert_array_equal(tp.x_hi.astype(np.float32),
                                  np.asarray(jp.x_hi))
    assert np.all(tp.x_hi[:-1] - tp.x_lo[1:] >= 2.0 * 2.0 - 1e-6)


def test_partition_device_build_matches_host():
    """The device build (one target copy per device, slabs and normals
    gathered there) equals the host build: slabs, indices and the point
    and plane trajectories."""
    src, tgt, _ = make_registration_pair(n=2500, seed=140, noise_sigma=0.01,
                                         kind="terrain")
    mesh = _mesh(4)
    tl = tgt - center_offset(tgt)
    halo = 0.02 * float((tl.max(0) - tl.min(0)).max())
    p_host = tpart.build_partition(tl, mesh.devices, halo, dtype=F32)
    p_dev = tpart.build_partition_device(tl, mesh, halo)
    for a, b in zip(p_host.halo_pts + p_host.halo_idx,
                    p_dev.halo_pts + p_dev.halo_idx):
        assert torch.equal(a, b)
    for est in ("point", "plane"):
        kw = dict(mesh=mesh, dtype=F32, max_iterations=10, tolerance=1e-9,
                  estimator=est)
        r_host = tpart.icp_register_partitioned(src, tgt,
                                                partition_build="host", **kw)
        r_dev = tpart.icp_register_partitioned(src, tgt,
                                               partition_build="device", **kw)
        assert r_dev.iterations == r_host.iterations
        np.testing.assert_array_equal(r_dev.history_rmse, r_host.history_rmse)
        np.testing.assert_array_equal(r_dev.transform, r_host.transform)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_partitioned_matches_single_device(n_dev):
    src, tgt, _ = make_registration_pair(n=3000, seed=130, noise_sigma=0.01)
    res_1 = icp_register(src, tgt, dtype=F64, nn_backend="bruteforce",
                         max_iterations=20, device="cpu")
    res_p = tpart.icp_register_partitioned(src, tgt, mesh=_mesh(n_dev),
                                           dtype=F64, max_iterations=20)
    res_j = jpart.icp_register_partitioned(
        src, tgt, mesh=jax_mesh(n_devices=n_dev), dtype=jnp.float64,
        max_iterations=20)
    for ref in (res_1, res_j):
        _same(res_p, ref)
        np.testing.assert_allclose(res_p.source_registered,
                                   ref.source_registered, atol=1e-9)


def test_tiny_halo_forces_collective_repair():
    """A halo far below the NN distances fails the margin everywhere: the
    collective repair runs every iteration and stays exact."""
    src, tgt, T_true = make_registration_pair(n=800, seed=131)
    mesh = _mesh(4)
    res = tpart.icp_register_partitioned(
        src, tgt, mesh=mesh, dtype=F64, halo=1e-4, repair_budget=256,
        max_iterations=25)
    res_1 = icp_register(src, tgt, dtype=F64, nn_backend="bruteforce",
                         max_iterations=25, device="cpu")
    k = min(res.iterations, res_1.iterations)
    np.testing.assert_allclose(res.history_rmse[:k], res_1.history_rmse[:k],
                               rtol=1e-9, atol=1e-12)
    assert _reg_err(res.transform, T_true, src) < 1e-4
    # The collective repair ran (every rank enters every pass).
    st = mesh.stats
    assert sum(s["repair_queries"] for s in st) > 0
    assert len({s["repair_passes"] for s in st}) == 1
    assert st[0]["repair_passes"] > 0


def test_cross_rank_tie_resolves_first_tie_order():
    """Equidistant candidates held by different ranks resolve to the one
    first in original target order, exactly (never their average)."""
    rng = np.random.default_rng(7)
    base = rng.uniform(-50, 50, (1000, 3))
    B = np.array([[+1.0, 0.0, 200.0]])  # original index 1000 → slab 1
    A = np.array([[-1.0, 0.0, 200.0]])  # original index 1001 → slab 0
    tgt = np.concatenate([base, B, A])
    mesh = _mesh(2)
    part = tpart.build_partition(tgt, mesh.devices, 1e-3, dtype=F32)
    q = torch.tensor([[0.0, 0.0, 200.0]], dtype=F32)

    def rank_fn(comm):
        r = comm.rank
        state = (part.halo_pts[r], part.halo_idx[r], None,
                 torch.tensor(part.x_lo[r], dtype=F32),
                 torch.tensor(part.x_hi[r], dtype=F32), None, None)
        nn = tpart._partitioned_nn(
            comm, state, local_search="brute", with_normals=False,
            repair_budget=64, repair_passes=2)
        return nn(q.clone(), None, None)

    for m, d in mesh.run(rank_fn):
        np.testing.assert_array_equal(m.numpy(), B.astype(np.float32))
        np.testing.assert_allclose(d.numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("budget", [200, 500])
def test_collective_repair_every_query_exact(budget):
    """A source lifted 500 m above its target fails every slab margin:
    each of the 4 ranks' 500 queries goes through the collective repair,
    in windows of ``budget`` rows (200: the last window is clamped to the
    rows' end, 300-500 instead of 400-600). Every winner and distance is
    the plain brute force's over the whole target (its first minimum),
    bit for bit."""
    from iterativeclosestpoint_tpu_torch.ops.bruteforce import nn_bruteforce

    src, tgt, _ = make_registration_pair(n=2000, seed=9, noise_sigma=0.02,
                                         kind="terrain", extent=100.0)
    lift = np.eye(4)
    lift[2, 3] = 500.0
    mesh = _mesh(4)
    seen = {}
    orig = tpart.collective_repair

    def spy(comm, query, *a, **k):
        out = orig(comm, query, *a, **k)
        seen[comm.rank] = (query, out[0][:, :3], out[1])
        return out

    tpart.collective_repair = spy
    try:
        tpart.icp_register_partitioned(
            src, tgt, mesh=mesh, dtype=F32, halo=1e-4, local_search="brute",
            initial_transform=lift, max_iterations=1, repair_budget=budget,
            repair_passes=3, return_registered=False)
    finally:
        tpart.collective_repair = orig
    assert sum(s["repair_queries"] for s in mesh.stats) == 2000
    tgt_t = torch.as_tensor((tgt - center_offset(tgt)).astype(np.float32))
    for q, m, d in seen.values():
        bi, bd = nn_bruteforce(q, tgt_t)
        assert torch.equal(m, tgt_t[bi]) and torch.equal(d, bd)


def test_partitioned_pallas_local_search_matches_brute():
    src, tgt, _ = make_registration_pair(n=2000, seed=132, noise_sigma=0.01,
                                         kind="terrain")
    kw = dict(mesh=_mesh(2), dtype=F32, max_iterations=8, tolerance=1e-9)
    res_b = tpart.icp_register_partitioned(src, tgt, local_search="brute",
                                           **kw)
    res_p = tpart.icp_register_partitioned(src, tgt, local_search="pallas",
                                           grid_resolution=16, **kw)
    assert res_p.nn_resolution == 16
    _same(res_p, res_b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fine_kernel", ["sweep", "zcol"])
def test_slab_grids_and_layout_match_jax(fine_kernel):
    """Each rank's slab grids (fine and coarse, normals in rows 3-5) and
    its shard's query layout equal the JAX per-device ones bit for bit:
    the JAX buffers' far rows sort past every real cell (``mask_far``),
    which the port's ragged slabs simply do not have. The grid parameters
    are resolved identically (``resolve_slab_grid_params``)."""
    kind = "uniform" if fine_kernel == "zcol" else "terrain"
    src, tgt, _ = make_registration_pair(n=6000, seed=141, noise_sigma=0.01,
                                         kind=kind, extent=20.0)
    n_dev = 2
    tl = tgt - center_offset(tgt)
    sl = (src - center_offset(tgt))
    halo = 0.02 * float((tl.max(0) - tl.min(0)).max())
    nrm = np.random.default_rng(3).normal(size=tl.shape).astype(np.float32)
    kw = dict(local_search="pallas", fine_kernel=fine_kernel,
              n_queries_hint=len(src), estimator="plane")
    jpp = jpart.prepare_partition(tgt, mesh=jax_mesh(n_devices=n_dev),
                                  partition_build="host", **kw)
    tpp = tpart.prepare_partition(tgt, mesh=_mesh(n_dev), **kw)
    keys = ("resolution", "trange", "coarse_trange", "fine_kernel", "m_loc")
    assert {k: tpp[k] for k in keys} == {k: jpp[k] for k in keys}
    assert tpp["fine_kernel"] == fine_kernel

    jp = jpart.build_partition(tl, n_dev, halo, dtype=np.float32,
                               normals=nrm)
    tp = tpart.build_partition(tl, ["cpu"] * n_dev, halo, dtype=F32,
                               normals=nrm)
    perm = np.argsort(sl[:, 0], kind="stable")
    src_pad, w = pad_to_multiple(sl[perm].astype(np.float32), n_dev)
    R, tr, ct = jpp["resolution"], jpp["trange"], jpp["coarse_trange"]
    j_src, j_w, j_grid, j_cgrid = jpart._prepare_partitioned(
        jnp.asarray(src_pad), jnp.asarray(w), jp, mesh=jax_mesh(
            n_devices=n_dev), resolution=R, trange=tr, tile_q=128,
        with_normals=True, fine_kernel=fine_kernel, coarse_trange=ct)
    per = len(src_pad) // n_dev
    j_src = np.asarray(j_src).reshape(n_dev, -1, 3)
    j_w = np.asarray(j_w).reshape(n_dev, -1)
    for r in range(n_dev):
        grid, cgrid, lo3, cell = tpart._slab_grids(
            tp.halo_pts[r], tp.halo_nrm[r], resolution=R, trange=tr,
            coarse_trange=ct, fine_kernel=fine_kernel)
        for tg, jg in ((grid, j_grid), (cgrid, j_cgrid)):
            m = tg.tgt_t.shape[1]
            for f in jg._fields:
                want = np.asarray(getattr(jg, f))[r]
                if f == "tgt_t":
                    want = want[:, :m]
                np.testing.assert_array_equal(getattr(tg, f).numpy(), want,
                                              err_msg=f)
        shard = torch.as_tensor(src_pad[r * per:(r + 1) * per])
        rows, lw = grouped_tile_order_device(
            shard, lo3, cell, resolution=R, tile_q=128,
            group="xy" if fine_kernel == "zcol" else "x")
        np.testing.assert_array_equal(shard[rows].numpy(), j_src[r])
        np.testing.assert_array_equal(
            (torch.as_tensor(w[r * per:(r + 1) * per])[rows] * lw).numpy(),
            j_w[r])


def test_partitioned_plane_estimator():
    src, tgt, T_true = make_registration_pair(n=4000, seed=133,
                                              noise_sigma=0.005,
                                              kind="terrain")
    res = tpart.icp_register_partitioned(src, tgt, mesh=_mesh(4), dtype=F64,
                                         estimator="plane",
                                         max_iterations=20)
    assert res.success
    assert np.abs(res.transform - T_true).max() < 1e-3


def test_partitioned_robust_tukey_beats_plain():
    rng = np.random.default_rng(3)
    n = 6000
    tgt = make_cloud(n, seed=7)
    T_true = random_rigid_transform(seed=5, max_yaw_deg=3.0,
                                    max_pitch_roll_deg=1.5, max_txy=0.5,
                                    max_tz=0.3)
    src = apply_transform_np(np.linalg.inv(T_true), tgt)
    src += rng.normal(0, 0.01, src.shape)
    src[rng.choice(n, int(n * 0.2), replace=False), 0] += 0.25
    kw = dict(mesh=_mesh(4), dtype=F64, max_iterations=60, tolerance=1e-9,
              return_registered=False)
    plain = tpart.icp_register_partitioned(src, tgt, **kw)
    rob = tpart.icp_register_partitioned(src, tgt, robust="tukey", **kw)
    assert (_reg_err(rob.transform, T_true, src)
            < _reg_err(plain.transform, T_true, src) * 0.05)


def test_partitioned_robust_matches_single_device():
    """tukey with the bias concentrated in one rank's slab: the exact
    global median keeps the single-device trajectory."""
    src, tgt, _ = make_registration_pair(n=3000, seed=133, noise_sigma=0.01)
    src = src[np.argsort(src[:, 0])]
    src[: len(src) // 4, 0] += 0.2
    kw = dict(dtype=F64, max_iterations=25, robust="tukey")
    res_1 = icp_register(src, tgt, nn_backend="bruteforce", device="cpu",
                         **kw)
    res_p = tpart.icp_register_partitioned(src, tgt, mesh=_mesh(4), **kw)
    _same(res_p, res_1)


def test_partitioned_segmented_trajectory_identical():
    src, tgt, _ = make_registration_pair(n=1500, seed=135, noise_sigma=0.02)
    kw = dict(mesh=_mesh(4), dtype=F64, max_iterations=10, tolerance=1e-9)
    one = tpart.icp_register_partitioned(src, tgt, **kw)
    seen = []
    seg = tpart.icp_register_partitioned(
        src, tgt, segment_iterations=4, progress_callback=seen.append, **kw)
    assert seg.iterations == one.iterations
    assert len(seen) == one.iterations
    np.testing.assert_array_equal(seg.history_rmse, one.history_rmse)
    np.testing.assert_array_equal(seg.history_transform,
                                  one.history_transform)
    np.testing.assert_array_equal(seg.source_registered,
                                  one.source_registered)


def test_partitioned_initial_transform():
    """A coarse pose pre-aligns the partition layout (the 10M recipe:
    ladder, then the partitioned fine pass); also through the multiscale
    entry point's ``fine_path="partitioned"``."""
    src, tgt, T_true = make_registration_pair(n=3000, seed=136,
                                              noise_sigma=0.01)
    coarse = icp_register_multiscale(src, tgt, strides=(8, 8),
                                     max_iterations=10,
                                     return_registered=False, device="cpu")
    mesh = _mesh(4)
    res = tpart.icp_register_partitioned(
        src, tgt, mesh=mesh, dtype=F64, initial_transform=coarse.transform,
        max_iterations=20)
    assert res.success
    assert np.abs(res.transform - T_true).max() < 1e-3
    ms = icp_register_multiscale(src, tgt, strides=(8, 1), mesh=mesh,
                                 fine_path="partitioned", dtype=F64,
                                 max_iterations=20, device="cpu")
    assert ms.final.success
    assert np.abs(ms.transform - T_true).max() < 1e-3


def test_partitioned_resume_bit_identical(tmp_path):
    """Stop a live partitioned session run mid-way, resume from its
    rolling checkpoint: the concatenated trajectory is the uninterrupted
    run's, exactly (the session's mesh: one rank per card, one CPU rank
    here); and the same on 4 ranks through ``resume_carry``."""
    from iterativeclosestpoint_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
        resume_arguments,
    )
    from iterativeclosestpoint_tpu_torch.runtime.session import (
        RegistrationSession,
    )
    from iterativeclosestpoint_tpu_torch.utils.config import ICPConfig

    src, tgt, _ = make_registration_pair(n=3000, seed=131, noise_sigma=0.01)
    MAX = 40
    kw = dict(dtype=F32, tolerance=1e-5, return_registered=False)
    full = tpart.icp_register_partitioned(src, tgt, mesh=_mesh(1),
                                          max_iterations=MAX, **kw)
    assert full.message == "converged" and full.iterations > 7

    sess = RegistrationSession(device="cpu")
    sess.set_clouds(src, tgt)
    ev = sess._stop_event
    real_iter = sess.metrics.iteration

    def stop_at_6(rec, total):
        real_iter(rec, total)
        if rec["iteration"] >= 6:
            ev.set()

    sess.metrics.iteration = stop_at_6
    res1 = sess.run(config=ICPConfig(max_iterations=MAX, tolerance=1e-5),
                    parallel="partition", live_every=3,
                    checkpoint_path=tmp_path / "p.json")
    assert res1.message == "stopped by user"
    k = res1.iterations
    assert 0 < k < full.iterations
    ck = load_checkpoint(tmp_path / "p.json")
    assert ck["iteration"] == k
    patch = resume_arguments(ck, MAX)
    res2 = tpart.icp_register_partitioned(src, tgt, mesh=_mesh(1), **kw,
                                          **patch)
    assert res2.message == full.message
    assert k + res2.iterations == full.iterations
    np.testing.assert_array_equal(
        np.concatenate([res1.history_rmse, res2.history_rmse]),
        full.history_rmse)
    np.testing.assert_array_equal(res2.transform, full.transform)

    mesh = _mesh(4)
    full4 = tpart.icp_register_partitioned(src, tgt, mesh=mesh,
                                           max_iterations=12, **kw)
    first = tpart.icp_register_partitioned(src, tgt, mesh=mesh,
                                           max_iterations=5, **kw)
    rest = tpart.icp_register_partitioned(
        src, tgt, mesh=mesh, max_iterations=7, resume_carry={
            "transform": first.transform,
            "transform_local": first.carry_transform_local,
            "offset": first.center_offset,
            "prev_error": first.carry_prev_error,
            "no_improve": first.carry_no_improve}, **kw)
    np.testing.assert_array_equal(
        np.concatenate([first.history_transform, rest.history_transform]),
        full4.history_transform)


def test_partitioned_zcol_kernel_matches_brute():
    """The z-column local search on a volume: every iteration's matches
    are exact (held against a k-d tree) and the trajectory is the brute
    one. Its f32 sums run in the layout's order, so the poses differ at
    f32 roundoff, and on this fixture one of 2,000 points sits on the
    iteration-6 3σ threshold and swaps for another (the inlier counts
    stay equal, the RMSE moves 2.7e-5 relative): held at rtol 1e-4 and
    1e-4 m, the f32 gate of PARITY.md."""
    from scipy.spatial import cKDTree

    src, tgt, _ = make_registration_pair(n=2000, seed=133, noise_sigma=0.01,
                                         kind="uniform", extent=20.0)
    kw = dict(mesh=_mesh(2), dtype=F32, max_iterations=8, tolerance=1e-9)
    res_b = tpart.icp_register_partitioned(src, tgt, local_search="brute",
                                           **kw)
    seen = []
    orig = tpart.collective_repair

    def spy(comm, query, *a, **k):
        out = orig(comm, query, *a, **k)
        seen.append((query.clone(), out[1].clone()))
        return out

    tpart.collective_repair = spy
    try:
        res_z = tpart.icp_register_partitioned(
            src, tgt, local_search="pallas", fine_kernel="zcol",
            grid_resolution=8, **kw)
    finally:
        tpart.collective_repair = orig
    tree = cKDTree((tgt - center_offset(tgt)).astype(np.float32))
    for q, d in seen:
        want = tree.query(q.numpy().astype(np.float64))[0]
        assert np.abs(d.numpy() - want).max() < 1e-5
    assert res_z.iterations == res_b.iterations
    np.testing.assert_array_equal(res_z.history_valid, res_b.history_valid)
    np.testing.assert_allclose(res_z.history_rmse, res_b.history_rmse,
                               rtol=1e-4)
    assert _reg_err(res_z.transform, res_b.transform, src) < 1e-4


@pytest.mark.parametrize("extra, match", [
    (dict(offset=np.zeros(3)), "requires source_global and offset"),
    (dict(source_global="sg"), "requires source_global and offset"),
    (dict(source_global="sg", offset=np.zeros(3),
          initial_transform=np.eye(4)), "initial_transform"),
    (dict(source_global="sg", offset=np.zeros(3),
          return_registered=True), "return_registered=False"),
])
def test_partition_state_input_checks(extra, match):
    """The JAX package's checks on the ingest inputs
    (partition.py:833-848), raised by both packages on the same call."""
    extra = dict({"return_registered": False}, **extra)
    for fn, mesh in ((tpart.icp_register_partitioned, _mesh(2)),
                     (jpart.icp_register_partitioned, jax_mesh(2))):
        with pytest.raises(ValueError, match=match):
            fn(None, None, mesh=mesh, partition_state="part", **extra)


@pytest.mark.parametrize("kwargs, local_search", [
    (dict(nn_backend="bruteforce", cell_capacity=8, max_iterations=3),
     "brute"),
    (dict(nn_backend="pallas"), "pallas"),
    (dict(), "auto"),
    (dict(nn_backend="cellblock", local_search="brute"), "brute"),
])
def test_partitioned_kwargs(kwargs, local_search):
    """The one rule that turns single-device kwargs into partitioned ones:
    the backend becomes the local search unless one is given, the hashgrid
    cell capacity goes, every other key passes."""
    pk = tpart.partitioned_kwargs(kwargs)
    assert pk.pop("local_search") == local_search
    assert pk == {k: v for k, v in kwargs.items()
                  if k not in ("nn_backend", "cell_capacity",
                               "local_search")}


def test_partitioned_kwargs_unknown_backend_raises():
    with pytest.raises(ValueError, match="no partitioned equivalent"):
        tpart.partitioned_kwargs(dict(nn_backend="hashgrid"))
