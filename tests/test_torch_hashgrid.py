"""Port parity: the voxel-hash grid exact 1-NN backend
(``ops/hashgrid.py``) against the JAX package on the CPU
(``tests/test_hashgrid.py``, mirrored).

The port's search runs on the JAX-built grid (``convert.
hashgrid_from_numpy``), and its own build must equal the JAX build field
for field. Indices and certificates are equal. Each distance is within
1 ulp of the exact distance to its winner (computed in extended
precision), and so within 2 ulp of the JAX package's: XLA:CPU sums the
reference's d² with FMAs in another order (ROADMAP §3), which can round
the other way (3 of 8,000 rows on the f64 terrain here). ICP
with the backend: f64 transforms within 1e-9 of the JAX package's and of
the port's brute force.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from scipy.spatial import cKDTree

from iterativeclosestpoint_tpu.models.icp import icp_register as jax_icp
from iterativeclosestpoint_tpu.ops import hashgrid as jhg
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
from iterativeclosestpoint_tpu_torch.ops import hashgrid as thg


def _grid(tgt, R, dt, capacity=None):
    """The JAX-built grid, its port copy and the capacity."""
    g, K = jhg.build_hashgrid(tgt, resolution=R, capacity=capacity,
                              dtype=dt)
    return g, convert.hashgrid_from_numpy(
        {k: np.asarray(getattr(g, k)) for k in g._fields}, "cpu"), K


@pytest.mark.parametrize("dt,capacity", [(np.float32, None),
                                         (np.float64, None),
                                         (np.float32, 3)])
def test_build_hashgrid_matches_jax(dt, capacity):
    tgt = make_cloud(5000, seed=10)
    ref, K = jhg.build_hashgrid(tgt, resolution=32, capacity=capacity,
                                dtype=dt)
    got, K2 = thg.build_hashgrid(tgt, resolution=32, capacity=capacity,
                                 dtype={np.float32: torch.float32,
                                        np.float64: torch.float64}[dt],
                                 device="cpu")
    assert K2 == K
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("kind", ["terrain", "uniform", "sphere"])
def test_grid_matches_jax_and_is_exact_when_certified(kind):
    tgt = make_cloud(5000, seed=10, kind=kind)
    rng = np.random.default_rng(0)
    q = tgt[rng.choice(5000, 2000)] + rng.normal(0, 0.05, size=(2000, 3))
    jg, tg, K = _grid(tgt, 32, np.float64)
    ji, jd, jc = jhg.nn_hashgrid(jnp.asarray(q), jg, resolution=32,
                                 capacity=K)
    ti, td, tc = thg.nn_hashgrid(torch.as_tensor(q), tg, resolution=32,
                                 capacity=K)
    cert = tc.numpy()
    np.testing.assert_array_equal(cert, np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _check_dist(td.numpy(), np.asarray(jd), q, tgt, ti.numpy())
    assert cert.mean() > 0.99
    d_ref, i_ref = cKDTree(tgt).query(q)
    np.testing.assert_array_equal(ti.numpy()[cert], i_ref[cert])
    np.testing.assert_allclose(td.numpy()[cert], d_ref[cert], atol=1e-9)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_hybrid_matches_jax_and_is_exact(dt):
    """Near and far (off-grid) queries: the certificate fails somewhere
    and the brute-force fallback resolves every query exactly."""
    tgt = make_cloud(3000, seed=11)
    rng = np.random.default_rng(1)
    q = np.vstack([
        tgt[rng.choice(3000, 500)] + rng.normal(0, 0.02, (500, 3)),
        rng.uniform(-200, 200, (100, 3)),
    ]).astype(dt)
    tgt = tgt.astype(dt)
    jg, tg, K = _grid(tgt, 32, dt)
    ji, jd = jhg.nn_hybrid(jnp.asarray(q), jnp.asarray(tgt), jg,
                           resolution=32, capacity=K)
    ti, td = thg.nn_hybrid(torch.as_tensor(q), torch.as_tensor(tgt), tg,
                           resolution=32, capacity=K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _check_dist(td.numpy(), np.asarray(jd), q, tgt, ti.numpy())
    d_ref, i_ref = cKDTree(tgt).query(q)
    np.testing.assert_array_equal(ti.numpy(), i_ref)


def test_overflow_cells_handled():
    """A dense cluster past the cell capacity is still searched (through
    the overflow list)."""
    rng = np.random.default_rng(2)
    cluster = rng.normal(0, 0.01, size=(500, 3))  # all in ~one cell
    spread = rng.uniform(-10, 10, size=(500, 3))
    tgt = np.vstack([cluster, spread])
    grid, K = thg.build_hashgrid(tgt, resolution=16, capacity=4,
                                 dtype=torch.float64, device="cpu")
    assert K == 4 and grid.overflow_pts.shape[0] >= 496
    q = cluster + rng.normal(0, 0.001, size=cluster.shape)
    ti, td = thg.nn_hybrid(torch.as_tensor(q), torch.as_tensor(tgt), grid,
                           resolution=16, capacity=4)
    d_ref, i_ref = cKDTree(tgt).query(q)
    np.testing.assert_array_equal(ti.numpy(), i_ref)
    np.testing.assert_allclose(td.numpy(), d_ref, atol=1e-9)


def test_choose_capacity():
    counts = np.array([1, 5, 100, 3])
    assert thg.choose_capacity(counts, overflow_cap=0) == 100
    assert thg.choose_capacity(counts, overflow_cap=95) == 5
    assert thg.choose_capacity(counts, overflow_cap=10**9) == 1
    for cap in (0, 7, 95, 10**9):
        assert thg.choose_capacity(counts, cap) == jhg.choose_capacity(
            counts, cap)


@pytest.mark.parametrize("cell_capacity", [None, 2])
def test_icp_with_hashgrid_matches_jax(cell_capacity):
    """f64: the JAX package's trajectory and the port's brute force within
    1e-9, whatever ``cell_capacity`` sizes the cells to."""
    src, tgt, _ = make_registration_pair(n=3000, seed=20, noise_sigma=0.01)
    kw = dict(nn_backend="hashgrid", cell_capacity=cell_capacity)
    ref = jax_icp(src, tgt, dtype=jnp.float64, **kw)
    res = icp_register(src, tgt, dtype=torch.float64, device="cpu", **kw)
    brute = icp_register(src, tgt, dtype=torch.float64,
                         nn_backend="bruteforce", device="cpu")
    assert res.success and res.nn_resolution == 64
    assert res.iterations == ref.iterations == brute.iterations
    np.testing.assert_allclose(res.transform, ref.transform, atol=1e-9)
    np.testing.assert_allclose(res.transform, brute.transform, atol=1e-9)
