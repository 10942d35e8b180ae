"""Port parity: the grid estimators, the device grid build, the query
layout and the ``convert`` round trip against the JAX package.

All comparisons are exact: the estimators are numpy copies, and the grid
build and layout are integer bookkeeping over the same f32 cell
coordinates (one f32 subtract and divide per point, rounded alike)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.ops import cellblock as jcb
from iterativeclosestpoint_tpu.ops import pallas_nn as jpn
from iterativeclosestpoint_tpu.utils.synth import make_cloud
from iterativeclosestpoint_tpu_torch import convert
from iterativeclosestpoint_tpu_torch.ops import cellblock as tcb
from iterativeclosestpoint_tpu_torch.ops import sweep_params as tsp
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    build_grid,
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_nn import make_pallas_nn_device


def _cloud(kind):
    if kind == "volume":
        rng = np.random.default_rng(3)
        pts = rng.uniform(-20, 20, (20_000, 3))
        pts[:, 2] *= 0.5
        return pts.astype(np.float32)
    return make_cloud(20_000, seed=4, kind=kind, extent=50.0).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["terrain", "sphere", "volume"])
def test_estimators_match_jax(kind):
    pts = _cloud(kind)
    for kw in ({}, {"surface_boost_occupancy": 32, "return_base": True}):
        assert tcb.auto_resolution_data(pts, **kw) == \
            jcb.auto_resolution_data(pts, **kw)
    R = jcb.auto_resolution_data(pts)
    for r in (R, 2 * R):
        assert tcb.surface_boost_ok(pts, r) == jcb.surface_boost_ok(pts, r)
        assert tsp.auto_trange(pts, r) == jpn.auto_trange(pts, r)
        assert tsp.auto_coarse_trange(pts, r) == jpn.auto_coarse_trange(pts, r)
        assert tsp.auto_zrange(pts, r) == jpn.auto_zrange(pts, r)
    assert tsp.estimate_grid_params(pts) == jpn.estimate_grid_params(pts)
    assert tsp.estimate_grid_params(pts, 16) == jpn.estimate_grid_params(
        pts, 16)
    for slabs, tr in ((4, 768), (4, 1536), (6, 1024), (1, 768)):
        assert tsp.use_fused_sweep(slabs, tr) == jpn.use_fused_sweep(slabs, tr)


def _geometry(tgt, R):
    lo, hi = tgt.min(axis=0).astype(np.float64), tgt.max(axis=0)
    cell = max(float((hi - lo).max()) / R, 1e-9)
    return lo.astype(np.float32), np.float32(cell)


@pytest.mark.parametrize("R,trange", [(16, 2048), (64, 768)])
def test_device_grid_build_matches_jax(R, trange):
    tgt = make_cloud(9000, seed=91).astype(np.float32)
    tgt[100:140] = tgt[0:40]  # duplicates pin the stable in-cell order
    org, cell = _geometry(tgt, R)
    ref = jpn._build_grid_dev(jnp.asarray(tgt), jnp.asarray(org),
                              jnp.asarray(cell), resolution=R, trange=trange)
    ours = build_grid(torch.as_tensor(tgt), torch.as_tensor(org),
                      torch.tensor(cell), resolution=R, trange=trange)
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


@pytest.mark.parametrize("R", [8, 32])
def test_grouped_tile_order_matches_jax(R):
    tgt = make_cloud(12000, seed=92)
    rng = np.random.default_rng(5)
    q = (tgt + rng.normal(0, 0.05, tgt.shape)).astype(np.float32)
    org, cell = _geometry(tgt.astype(np.float32), R)
    rows_j, w_j = jpn.grouped_tile_order_device(
        jnp.asarray(q), jnp.asarray(org), jnp.asarray(cell), resolution=R)
    rows_t, w_t = grouped_tile_order_device(
        torch.as_tensor(q), torch.as_tensor(org), torch.tensor(cell),
        resolution=R)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    # The certificate invariant: every 128-row tile sits in one x-cell.
    xcell = np.clip(((q[rows_t.numpy()][:, 0] - org[0]) / cell).astype(int),
                    0, R - 1).reshape(-1, 128)
    assert (xcell.max(axis=1) == xcell.min(axis=1)).all()


def test_convert_round_trip_and_factory_grid():
    """A JAX device-built grid converts into the port's grid field for
    field, equals the port's own factory build, and converts back."""
    tgt = make_cloud(6000, seed=29).astype(np.float32)
    _, (j_fine, j_coarse, _), j_R = jpn.make_pallas_nn_device(tgt)
    fn, (t_fine, t_coarse, _), t_R = make_pallas_nn_device(tgt, device="cpu")
    assert t_R == j_R and fn.tile_q == 128 and fn.layout_group == "x"
    for jg, tg in ((j_fine, t_fine), (j_coarse, t_coarse)):
        d = {f: np.asarray(getattr(jg, f)) for f in jg._fields}
        g = convert.grid_from_numpy(d, "cpu")
        for f in jg._fields:
            assert torch.equal(getattr(g, f), getattr(tg, f)), f
        back = convert.grid_to_numpy(g)
        for f in jg._fields:
            np.testing.assert_array_equal(back[f], d[f])
    T, pe, ni = convert.carry_from_numpy(np.eye(4), 0.25, 2,
                                         dtype=torch.float32, device="cpu")
    assert T.dtype == torch.float32 and float(pe) == 0.25 and int(ni) == 2
