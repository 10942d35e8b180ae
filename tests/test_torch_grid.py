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
from iterativeclosestpoint_tpu_torch.runtime.timing import collect, stage


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


def _stack(layers, n, dz):
    return np.concatenate([
        make_cloud(n, seed=s, extent=100.0) + np.array([0.0, 0.0, dz * s])
        for s in range(layers)])


def _flat_cluster():
    rng = np.random.default_rng(7)
    spread = np.c_[rng.uniform(0, 100, (2000, 2)), np.zeros(2000)]
    dense = np.c_[rng.uniform(40, 41, (40_000, 2)), np.zeros(40_000)]
    return np.r_[spread, dense]


def _at_tmax():
    pts = make_cloud(30_000, seed=5, extent=100.0)
    pts[::3] = pts.max(axis=0)  # a third of the rows on the clip edge
    return pts


# name: (cloud, given resolution, sample cap or None, the branch it takes)
_FINE_CASES = {
    "terrain": (lambda: _cloud("terrain"), None, None, "z-column, boosted"),
    "sphere": (lambda: _cloud("sphere"), None, None, "z-column"),
    "volume": (lambda: _cloud("volume"), None, None, "z-column"),
    "zcol_refuses_boost": (lambda: _stack(8, 6000, 10.0), None, None,
                           "z-column wins its cost model"),
    "surface_boost": (lambda: make_cloud(50_000, seed=21, extent=100.0),
                      None, None, "R = 2 base"),
    "boost2_passes": (lambda: make_cloud(30_000, seed=21, extent=100.0),
                      None, None, "two-stage gate passes"),
    "boost2_refused": (lambda: _stack(4, 12_000, 3.0), None, None,
                       "two-stage gate refuses (d > 2.45)"),
    "given_pow2": (lambda: _cloud("terrain"), 64, None, "given R"),
    "given_other": (lambda: _cloud("terrain"), 100, None, "host path"),
    "strided": (lambda: make_cloud(50_001, seed=9), None, 10_000,
                "stride 5, 50,001 rows"),
    "at_tmax": (_at_tmax, None, None, "rows on the clip edge"),
    "flat_zcol": (_flat_cluster, None, None, "z extent 0, z-column"),
    "tiny": (lambda: _cloud("terrain") * 4e-9, None, None,
             "extent under 512e-9: host path"),
}


@pytest.mark.parametrize("case", list(_FINE_CASES))
def test_fine_grid_estimate_on_the_device_matches_host_and_jax(
        case, monkeypatch):
    """``estimate_fine_grid_device`` on CPU tensors: the same (grid_est,
    boost2_est) as the numpy calls (``estimate_fine_grid``), whose
    grid_est is the JAX package's ``estimate_grid_params``; one pass over
    the cloud and one read, one more of each on the z-column branch (and
    a second sample where the two sample caps give other strides)."""
    make, res, cap, _ = _FINE_CASES[case]
    pts = make().astype(np.float32)
    if cap is not None:
        monkeypatch.setattr(tsp, "_AUTO_TRANGE_SAMPLE_CAP", cap)
        monkeypatch.setattr(jpn, "_AUTO_TRANGE_SAMPLE_CAP", cap)
    host_path = case in ("given_other", "tiny")
    for plane in (False, True):
        want = tsp.estimate_fine_grid(pts, res, plane=plane)
        with collect(sync=False) as col:
            with stage("grid_est"):
                got = tsp.estimate_fine_grid_device(
                    torch.as_tensor(pts), res, plane=plane)
        assert got == want, (plane, got, want)
        assert want[0] == jpn.estimate_grid_params(pts, res)
        if not host_path:
            zcol = want[0][4] is not None
            meta = col.meta["grid_est"]
            assert meta["cloud_passes"] == 1 + zcol + (cap is not None)
            assert meta["est_reads"] == 1 + zcol
    assert tsp.estimate_fine_grid_device(
        torch.as_tensor(pts), res, plane=True, two_stage=False) == (
        tsp.estimate_fine_grid(pts, res, plane=True, two_stage=False))


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


@pytest.mark.parametrize("coords", ["query", "given"])
def test_grouped_tile_order_with_coords_matches_jax(coords):
    """``with_coords=True``: the layout's f32 coordinates beside its rows,
    of the query itself or of other coordinates (the same points at
    another pose), bit for bit the JAX package's."""
    R = 16
    tgt = make_cloud(6000, seed=93)
    rng = np.random.default_rng(6)
    q = (tgt + rng.normal(0, 0.05, tgt.shape)).astype(np.float32)
    raw = None if coords == "query" else (q - 3.5).astype(np.float64)
    org, cell = _geometry(tgt.astype(np.float32), R)
    rows_j, w_j, c_j = jpn.grouped_tile_order_device(
        jnp.asarray(q), jnp.asarray(org), jnp.asarray(cell), resolution=R,
        with_coords=True, coords=None if raw is None else jnp.asarray(raw))
    rows_t, w_t, c_t = grouped_tile_order_device(
        torch.as_tensor(q), torch.as_tensor(org), torch.tensor(cell),
        resolution=R, with_coords=True,
        coords=None if raw is None else torch.as_tensor(raw))
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert c_t.dtype == torch.float32
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    plain, _ = grouped_tile_order_device(
        torch.as_tensor(q), torch.as_tensor(org), torch.tensor(cell),
        resolution=R)
    assert torch.equal(rows_t, plain)


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
