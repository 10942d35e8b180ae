"""Port parity: point-to-plane mode against the JAX package, on the CPU.

Normals, the SE(3) exponential, the 6×6 plane step, grids that carry
normals in rows 3-5, the exact chain's gathered normals and whole plane
trajectories, on the same inputs (numpy seeds) in both packages; the JAX
Pallas kernel runs in interpret mode. Tolerances and why:

* the host normals are the same numpy code: equal;
* device normals: the port sums each cell's moments in fixed point (an
  order-free sum) where the JAX package scatter-adds in f32, and XLA
  rounds ``acos``/``cos`` its own way, so normals are held by angle
  (sign-free |cos| ≥ 0.9999 on ≥ 99.9% of rows) and by equal fallback
  rows (+z exactly);
* ``se3_exp`` and the plane step in f64: 1e-15 and 1e-12 (the same
  operations, summed in another order);
* grids with normals: bit-equal (the same stable sort of the same data);
* exact-chain normals: equal, and each row's normal is its winner's;
* trajectories: f64 brute force within 1e-9 m (the oracle gate), f32
  pallas within 1e-4 m (the f32 parity gate of PARITY.md), with equal
  iteration counts and stop codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from scipy.spatial import cKDTree

from iterativeclosestpoint_tpu.models.icp import _plane_global as jax_plane
from iterativeclosestpoint_tpu.models.icp import icp_register as jax_icp
from iterativeclosestpoint_tpu.ops import normals as jnormals
from iterativeclosestpoint_tpu.ops import pallas_nn as jpn
from iterativeclosestpoint_tpu.ops.cellblock import (
    auto_resolution_data,
    morton_order,
)
from iterativeclosestpoint_tpu.ops.se3 import se3_exp as jax_se3_exp
from iterativeclosestpoint_tpu.utils.synth import (
    make_cloud,
    make_registration_pair,
)
from iterativeclosestpoint_tpu_torch import convert, icp_register
from iterativeclosestpoint_tpu_torch.models import icp as ticp
from iterativeclosestpoint_tpu_torch.ops import normals as tnormals
from iterativeclosestpoint_tpu_torch.ops import sweep_nn as tsn
from iterativeclosestpoint_tpu_torch.ops.se3 import se3_exp
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    build_grids,
    build_zgrids,
)

UP = np.array([0.0, 0.0, 1.0], np.float32)


def _reg_err(Ta, Tb, pts):
    pa = pts @ Ta[:3, :3].T + Ta[:3, 3]
    pb = pts @ Tb[:3, :3].T + Tb[:3, 3]
    return float(np.linalg.norm(pa - pb, axis=1).max())


def _geometry(tgt, R):
    tmin = tgt.min(axis=0)
    cell = max(float((tgt.max(axis=0) - tmin).max()) / R, 1e-9)
    return tmin.astype(np.float32), np.float32(cell)


def test_host_normals_equal_jax():
    tgt = make_cloud(20_000, seed=70, kind="terrain")
    R = auto_resolution_data(tgt)
    np.testing.assert_array_equal(
        tnormals.estimate_normals_cellpca(tgt, R),
        jnormals.estimate_normals_cellpca(tgt, R))


@pytest.mark.parametrize("n,seed,extent", [(20_000, 70, 50.0),
                                           (1_000_000, 7, 100.0)])
def test_device_normals_match_jax_by_angle(n, seed, extent):
    """The 20k cloud of the JAX package's test and the 1M headline
    target; run with ``-s`` to read the worst case."""
    tgt = make_cloud(n, seed=seed, kind="terrain", extent=extent)
    R = auto_resolution_data(tgt)
    org, cell = _geometry(tgt, R)
    # Lone points above the terrain, one per cell: cells under
    # min_points, whose rows fall back to +z.
    k = np.arange(R)
    lone = np.column_stack([org[0] + (k + 0.5) * cell,
                            org[1] + ((3 * k) % R + 0.5) * cell,
                            np.full(R, tgt[:, 2].max() + 1.5 * cell)])
    tgt = np.vstack([tgt, lone])
    assert np.array_equal(_geometry(tgt, R)[1], cell)
    j = np.asarray(jnormals.estimate_normals_cellpca_device(
        jnp.asarray(tgt, jnp.float32), jnp.asarray(org), jnp.asarray(cell),
        resolution=R))
    t = tnormals.estimate_normals_cellpca_device(
        torch.as_tensor(tgt, dtype=torch.float32), torch.as_tensor(org),
        torch.tensor(cell), resolution=R).numpy()
    fb_j, fb_t = np.all(j == UP, axis=1), np.all(t == UP, axis=1)
    np.testing.assert_array_equal(fb_t, fb_j)
    assert 0 < fb_t.sum() < len(tgt) // 10
    cos = np.abs(np.sum(j.astype(np.float64) * t, axis=1))
    print(f"R={R}: {int((cos < 0.9999).sum())} of {len(cos)} rows below "
          f"|cos| 0.9999, worst {np.degrees(np.arccos(cos.min())):.2f} deg")
    assert (cos >= 0.9999).mean() >= 0.999, np.sort(cos)[:10]
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("build", ["host", "device"])
def test_normals_of_a_flat_cloud_point_up(build):
    rng = np.random.default_rng(0)
    pts = np.zeros((5000, 3))
    pts[:, 0:2] = rng.uniform(-10, 10, (5000, 2))
    pts[:, 2] = 0.01 * rng.normal(size=5000)
    if build == "host":
        nrm = tnormals.estimate_normals_cellpca(pts, 16)
    else:
        org, cell = _geometry(pts, 16)
        nrm = tnormals.estimate_normals_cellpca_device(
            torch.as_tensor(pts, dtype=torch.float32), torch.as_tensor(org),
            torch.tensor(cell), resolution=16).numpy()
    assert np.abs(nrm[:, 2]).min() > 0.99


@pytest.mark.parametrize("theta", [0.0, 1e-8, 0.3])
def test_se3_exp_matches_jax(theta):
    rng = np.random.default_rng(5)
    axis = rng.normal(size=3)
    xi = np.concatenate([rng.normal(size=3), theta * axis
                         / np.linalg.norm(axis)])
    np.testing.assert_allclose(se3_exp(torch.as_tensor(xi)).numpy(),
                               np.asarray(jax_se3_exp(jnp.asarray(xi))),
                               rtol=0, atol=1e-15)


def test_plane_step_matches_jax():
    rng = np.random.default_rng(6)
    n = 5000
    src = rng.uniform(-20, 20, (n, 3))
    dst = src + rng.normal(0, 0.05, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    valid = rng.random(n) < 0.9
    ref = np.asarray(jax_plane(*(jnp.asarray(x) for x in
                                 (src, dst, nrm, valid)), lambda x: x))
    got = ticp._plane_global(*(torch.as_tensor(x) for x in
                               (src, dst, nrm, valid))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert np.abs(got - np.eye(4)).max() > 1e-4  # a real step


def test_grids_with_normals_bit_equal_jax():
    tgt = make_cloud(6000, seed=72, kind="terrain").astype(np.float32)
    org, cell = _geometry(tgt, 16)
    nrm = np.asarray(jnormals.estimate_normals_cellpca(tgt, 8), np.float32)
    cell3 = np.maximum((tgt.max(0) - tgt.min(0)) / 16, 1e-9).astype(
        np.float32)
    lv = dict(coarse_resolution=8, coarse_trange=4096)
    j = jpn._build_grids_dev(jnp.asarray(tgt), jnp.asarray(org),
                             jnp.asarray(cell), jnp.asarray(cell * 2),
                             jnp.asarray(nrm), resolution=16, trange=768,
                             **lv)
    jz = jpn._build_zgrids_dev(jnp.asarray(tgt), jnp.asarray(org),
                               jnp.asarray(cell3), jnp.asarray(cell * 2),
                               jnp.asarray(nrm), resolution=16, zrange=512,
                               **lv)
    as_t = lambda x: torch.as_tensor(x)  # noqa: E731
    t = build_grids(as_t(tgt), as_t(org), as_t(cell), as_t(cell * 2),
                    as_t(nrm), resolution=16, trange=768, **lv)
    tz = build_zgrids(as_t(tgt), as_t(org), as_t(cell3), as_t(cell * 2),
                      as_t(nrm), resolution=16, zrange=512, **lv)
    for jg, tg in zip(j + jz, t + tz):
        for f in jg._fields:
            np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                          np.asarray(getattr(jg, f)),
                                          err_msg=f)
        tail = tg.tgt_t[3:6, len(tgt):]
        assert torch.all(tail == 0) and torch.all(tg.tgt_t[6:] == 1e6)


def test_exact_chain_gathers_the_winners_normals(monkeypatch):
    """Queries ~1.2 fine cells off force coarse and brute repair; every
    row's normal must be its winner's (random per-point normals, so a
    stale one shows), equal to the JAX package's."""
    tgt = make_cloud(8000, seed=85)
    R = 32
    cell = float((tgt.max(0) - tgt.min(0)).max()) / R
    rng = np.random.default_rng(3)
    q = tgt + rng.uniform(-1.2 * cell, 1.2 * cell, tgt.shape)
    q = q[morton_order(q, R)].astype(np.float32)
    nrm = rng.normal(size=tgt.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    grids = []
    for r, tr in ((R, 2048), (R // 4, 8192)):
        jg = jpn.build_pallas_grid(tgt, r, trange=tr, normals=nrm)
        grids.append((jg, convert.grid_from_numpy(
            {f: np.asarray(getattr(jg, f)) for f in jg._fields}, "cpu")))
    kw = dict(resolution=R, coarse_resolution=R // 4, coarse_trange=8192,
              coarse_budget=16384, brute_passes=8, global_fallback=False)
    jm, jn, _ = jpn.nn_colsweep_exact(
        jnp.asarray(q), jnp.asarray(tgt, jnp.float32), grids[0][0],
        grids[1][0], jnp.asarray(nrm), **kw)
    brute_calls = []
    real_brute = tsn.nn_exact
    monkeypatch.setattr(tsn, "nn_exact", lambda *a: (
        brute_calls.append(1), real_brute(*a))[1])
    tm, tn, _ = tsn.nn_colsweep_exact(
        torch.as_tensor(q), torch.as_tensor(tgt, dtype=torch.float32),
        grids[0][1], grids[1][1], torch.as_tensor(nrm), **kw)
    assert brute_calls  # the brute tier ran
    tm, tn = tm.numpy(), tn.numpy()
    np.testing.assert_array_equal(tm, np.asarray(jm))
    np.testing.assert_array_equal(tn, np.asarray(jn))
    d0, idx = cKDTree(tgt.astype(np.float32)).query(tm)
    assert not d0.any()
    np.testing.assert_array_equal(tn, nrm[idx])


def test_f64_brute_plane_trajectory_matches_jax():
    src, tgt, T_true = make_registration_pair(n=20_000, seed=11,
                                              noise_sigma=0.02)
    kw = dict(nn_backend="bruteforce", estimator="plane", max_iterations=30,
              return_registered=False)
    ref = jax_icp(src, tgt, dtype=jnp.float64, **kw)
    res = icp_register(src, tgt, dtype=torch.float64, device="cpu", **kw)
    assert (res.iterations, res.stop_reason) == (ref.iterations,
                                                 ref.stop_reason)
    np.testing.assert_array_equal(res.history_valid, ref.history_valid)
    assert _reg_err(res.transform, ref.transform, src) <= 1e-9
    assert _reg_err(res.transform, T_true, src) < 0.05  # plane converges


def test_f32_pallas_plane_matches_jax():
    src, tgt, _ = make_registration_pair(n=6000, seed=12, noise_sigma=0.02)
    kw = dict(nn_backend="pallas", estimator="plane", max_iterations=25,
              return_registered=False)
    ref = jax_icp(src, tgt, dtype=jnp.float32, **kw)
    res = icp_register(src, tgt, device="cpu", **kw)
    assert res.nn_resolution == ref.nn_resolution
    assert (res.iterations, res.stop_reason) == (ref.iterations,
                                                 ref.stop_reason)
    assert _reg_err(res.transform, ref.transform, src) <= 1e-4


def test_plane_prepared_nn_must_carry_normals():
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
    )

    src, tgt, _ = make_registration_pair(n=2000, seed=13)
    prep = make_pallas_nn_device(tgt - tgt.mean(0), device="cpu")
    assert prep[1][2] is None and not prep[0].with_normals
    with pytest.raises(ValueError, match="with_normals"):
        icp_register(src, tgt, estimator="plane", prepared_nn=prep,
                     device="cpu", max_iterations=1)
