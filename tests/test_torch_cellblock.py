"""Port parity: the cell-blocked exact 1-NN backend (``ops/cellblock.py``)
against the JAX package on the CPU (``tests/test_cellblock.py``,
mirrored).

The port's search runs on the JAX-built grid (``convert.
cellgrid_from_numpy``), and its own build must equal the JAX build field
for field. Indices and certificates are equal. Each distance is within
1 ulp of the exact distance to its winner (computed in extended
precision), and so within 2 ulp of the JAX package's: XLA:CPU sums the
reference's d² with FMAs in another order (ROADMAP §3), which can round
the other way (3 of 8,000 rows on the f64 terrain here). ICP
with the backend: f64 transforms within 1e-9 of the JAX package's and of
the port's brute force; f32 within the 1e-4 m parity gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from scipy.spatial import cKDTree

from iterativeclosestpoint_tpu.models.icp import icp_register as jax_icp
from iterativeclosestpoint_tpu.ops import cellblock as jcb
from iterativeclosestpoint_tpu.utils.synth import (
    make_cloud,
    make_registration_pair,
)
from iterativeclosestpoint_tpu_torch import convert, icp_register


def _check_dist(dist, ref_dist, query, target, idx):
    """``dist`` within 1 ulp of the exact distance from each query to its
    winner ``target[idx]`` (rows with a winner; the others hold 1e9 in
    both packages), and within 2 ulp of ``ref_dist``."""
    np.testing.assert_array_max_ulp(dist, ref_dist, maxulp=2)
    found = dist < 1e8
    diff = (np.asarray(query, np.longdouble)[found]
            - np.asarray(target, np.longdouble)[idx[found]])
    exact = np.sqrt((diff * diff).sum(axis=1)).astype(dist.dtype)
    np.testing.assert_array_max_ulp(dist[found], exact, maxulp=1)
from iterativeclosestpoint_tpu_torch.ops import cellblock as tcb

_DT = {np.float32: torch.float32, np.float64: torch.float64}


def _grid(tgt, R, dt):
    """The JAX-built grid and its port copy."""
    g = jcb.build_cellgrid(tgt, R, dtype=dt)
    return g, convert.cellgrid_from_numpy(
        {k: np.asarray(getattr(g, k)) for k in g._fields}, "cpu")


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_build_cellgrid_matches_jax(dt):
    tgt = make_cloud(5000, seed=50)
    ref = jcb.build_cellgrid(tgt, 32, dtype=dt)
    got = tcb.build_cellgrid(tgt, 32, dtype=_DT[dt], device="cpu")
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("n_target, occupancy", [
    (0, 256), (1, 256), (1000, 256), (65_536, 256), (1_000_000, 256),
    (10_000_000, 256), (10**9, 256), (200_000, 64), (3_000_000, 1000)])
def test_auto_resolution_matches_jax(n_target, occupancy):
    ours = tcb.auto_resolution(n_target, occupancy)
    assert type(ours) is int
    assert ours == jcb.auto_resolution(n_target, occupancy)


def test_morton_matches_jax():
    cells = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                      [1, 1, 1]])
    codes = tcb.morton_encode(cells)
    assert codes[0] == 0
    assert sorted(codes[:4]) == list(codes[:4])  # unit steps are adjacent
    np.testing.assert_array_equal(codes, jcb.morton_encode(cells))
    pts = make_cloud(3000, seed=5)
    np.testing.assert_array_equal(tcb.morton_order(pts, 32),
                                  jcb.morton_order(pts, 32))


@pytest.mark.parametrize("kind,dt", [("terrain", np.float64),
                                     ("uniform", np.float64),
                                     ("sphere", np.float64),
                                     ("terrain", np.float32)])
def test_certified_results_match_jax_and_are_exact(kind, dt):
    """ICP-realistic density (query ≈ perturbed target): the JAX
    package's certificates and winners, and certified ⇒ exact."""
    tgt = make_cloud(8000, seed=50, kind=kind)
    rng = np.random.default_rng(0)
    q = tgt + rng.normal(0, 0.03, tgt.shape)
    R = jcb.auto_resolution_data(tgt)
    q = q[jcb.morton_order(q, R)].astype(dt)
    jg, tg = _grid(tgt, R, dt)
    ji, jd, jc = jcb.nn_cellblock(jnp.asarray(q), jg, resolution=R)
    ti, td, tc = tcb.nn_cellblock(torch.as_tensor(q), tg, resolution=R)
    cert = tc.numpy()
    np.testing.assert_array_equal(cert, np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _check_dist(td.numpy(), np.asarray(jd), q, tgt.astype(dt), ti.numpy())
    assert cert.mean() > 0.9, f"cert rate {cert.mean()}"
    d_ref, i_ref = cKDTree(tgt.astype(dt)).query(q)
    np.testing.assert_array_equal(ti.numpy()[cert], i_ref[cert])
    np.testing.assert_allclose(td.numpy()[cert], d_ref[cert],
                               atol=1e-9 if dt is np.float64 else 1e-5)


@pytest.mark.parametrize("n_q", [999, 4096, 5001])
def test_exact_variant_matches_jax(n_q):
    """Mixed near, far and off-grid queries through the budgeted brute
    passes: every result exact and the JAX package's."""
    tgt = make_cloud(6000, seed=51)
    rng = np.random.default_rng(1)
    q = np.vstack([
        tgt[rng.choice(6000, n_q - 200)]
        + rng.normal(0, 0.02, (n_q - 200, 3)),
        rng.uniform(-150, 150, (200, 3)),  # far outliers
    ])
    q = q[jcb.morton_order(q, 32)]
    jg, tg = _grid(tgt, 32, np.float64)
    kw = dict(resolution=32, brute_batch=256, brute_passes=4)
    ji, jd = jcb.nn_cellblock_exact(jnp.asarray(q), jnp.asarray(tgt), jg,
                                    **kw)
    ti, td = tcb.nn_cellblock_exact(torch.as_tensor(q),
                                    torch.as_tensor(tgt), tg, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _check_dist(td.numpy(), np.asarray(jd), q, tgt, ti.numpy())
    d_ref, i_ref = cKDTree(tgt).query(q)
    np.testing.assert_array_equal(ti.numpy(), i_ref)
    np.testing.assert_allclose(td.numpy(), d_ref, atol=1e-9)


def test_budget_overflow_falls_back_globally():
    """More uncertified queries than the repair budget: global brute."""
    tgt = make_cloud(2000, seed=52)
    rng = np.random.default_rng(2)
    q = rng.uniform(-300, 300, (2000, 3))  # all far, all uncertified
    q = q[jcb.morton_order(q, 16)]
    _, tg = _grid(tgt, 16, np.float64)
    ti, td = tcb.nn_cellblock_exact(
        torch.as_tensor(q), torch.as_tensor(tgt), tg, resolution=16,
        brute_batch=128, brute_passes=2)  # budget 256 < 2000
    d_ref, i_ref = cKDTree(tgt).query(q)
    np.testing.assert_array_equal(ti.numpy(), i_ref)
    np.testing.assert_allclose(td.numpy(), d_ref, atol=1e-9)


@pytest.mark.parametrize("n,seed,extra", [(3000, 20, {}),
                                          (2500, 54,
                                           {"outlier_frac": 0.1})])
def test_icp_with_cellblock_matches_jax(n, seed, extra):
    """f64: the JAX package's trajectory and the port's brute force
    within 1e-9; the registered cloud un-permuted to the source order."""
    src, tgt, _ = make_registration_pair(n=n, seed=seed, noise_sigma=0.01,
                                         **extra)
    ref = jax_icp(src, tgt, dtype=jnp.float64, nn_backend="cellblock")
    res = icp_register(src, tgt, dtype=torch.float64,
                       nn_backend="cellblock", device="cpu")
    brute = icp_register(src, tgt, dtype=torch.float64,
                         nn_backend="bruteforce", device="cpu")
    assert res.iterations == ref.iterations == brute.iterations
    assert res.nn_resolution == ref.nn_resolution
    np.testing.assert_allclose(res.transform, ref.transform, atol=1e-9)
    np.testing.assert_allclose(res.transform, brute.transform, atol=1e-9)
    np.testing.assert_allclose(res.source_registered,
                               brute.source_registered, atol=1e-9)
