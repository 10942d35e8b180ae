"""Port parity: the volume regime's z-column sweep against the JAX package.

The z-grid build, the (x, y)-group query layout, ``nn_colsweep_z`` (K1's
plain version at 12 masked slots, and K2's plain version in the slot-wise
form past 24576 lanes), the exact chain with ``fine="zcol"`` and one ICP
trajectory, each on the same inputs in both packages; the JAX Pallas
kernel runs in interpret mode on the CPU. Both sweeps read the SAME grid,
built by the JAX package and carried over by ``convert.zgrid_from_numpy``.

Tolerances and why:

* grid, layout, winners, certificates and tie flags: exact (integer
  bookkeeping over the same f32 cell coordinates; the certificate radii
  round the same operations in the same order);
* ``dist``: 1 ulp, XLA's CPU backend contracts the reference's d² sum into
  FMAs while the port rounds every operation on its own; on the repair
  chain's far rows each package is held within 1 ulp of the f64 distance
  to the common winner instead (the two may then sit 2 ulp apart);
* exact results against brute force: equal winners, distances within 1e-6
  (the JAX package's own zcol gate);
* the ICP trajectory: same iteration count, ``history_rmse`` within rtol
  1e-5 and transforms within 1e-5 (the two packages sum the f32
  statistics in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from scipy.spatial import cKDTree

from iterativeclosestpoint_tpu.models.icp import icp_register as jax_icp
from iterativeclosestpoint_tpu.ops import pallas_nn as jpn
from iterativeclosestpoint_tpu.ops.bruteforce import (
    nn_bruteforce as jax_brute,
)
from iterativeclosestpoint_tpu.utils.synth import (
    apply_transform_np,
    random_rigid_transform,
)
from iterativeclosestpoint_tpu_torch import convert, icp_register
from iterativeclosestpoint_tpu_torch.ops import sweep_nn as tsn
from iterativeclosestpoint_tpu_torch.ops.bruteforce import nn_bruteforce
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    ZPallasGrid,
    build_zgrid,
    build_zgrids,
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_params import auto_zrange


def _volume_pair(m=4000, n=1200, seed=9, extent=10.0):
    """A copy of the JAX package's zcol fixture (tests/test_pallas_nn.py):
    a uniform cube and noisy copies of some of its points."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, extent, (m, 3)).astype(np.float32)
    q = tgt[rng.choice(m, n, replace=False)] + rng.normal(
        0, 0.02, (n, 3)
    ).astype(np.float32)
    return q.astype(np.float32), tgt


def _flat_box(m, seed):
    """A 10:10:1 uniform box: per-axis cells differ by 10×."""
    pts = np.random.default_rng(seed).uniform(-5, 5, (m, 3))
    pts[:, 2] *= 0.1
    return pts.astype(np.float32)


def _geometry(tgt, R, cell):
    """f32 origin and cell size: scalar (the JAX tests' form) or per-axis
    (3,) (the factory's form)."""
    lo, hi = tgt.min(axis=0).astype(np.float64), tgt.max(axis=0)
    if cell == "aniso":
        c = np.maximum((hi - lo) / R, 1e-9).astype(np.float32)
    else:
        c = np.float32(max(float((hi - lo).max()) / R, 1e-9))
    return lo.astype(np.float32), c


def _zgrid_pair(tgt, R, zrange, cell="scalar"):
    org, c = _geometry(tgt, R, cell)
    jg = jpn._build_zgrid_dev(jnp.asarray(tgt), jnp.asarray(org),
                              jnp.asarray(c), resolution=R, zrange=zrange)
    d = {f: np.asarray(getattr(jg, f)) for f in jg._fields}
    return jg, convert.zgrid_from_numpy(d, "cpu"), org, c


@pytest.mark.parametrize("cell", ["scalar", "aniso"])
@pytest.mark.parametrize("R", [8, 16])
def test_build_zgrid_matches_jax(R, cell):
    tgt = _flat_box(7000, seed=21)
    tgt[200:260] = tgt[0:60]  # duplicates pin the stable in-cell order
    org, c = _geometry(tgt, R, cell)
    ref = jpn._build_zgrid_dev(jnp.asarray(tgt), jnp.asarray(org),
                               jnp.asarray(c), resolution=R, zrange=384)
    ours = build_zgrid(torch.as_tensor(tgt), torch.as_tensor(org),
                       torch.as_tensor(c), resolution=R, zrange=384)
    assert isinstance(ours, ZPallasGrid) and ours._fields == ref._fields
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert ours.cell_start.shape == (R**3 + 1,)
    assert ours.cell_start.dtype == torch.int32
    back = convert.zgrid_to_numpy(ours)
    for field in ref._fields:
        np.testing.assert_array_equal(back[field],
                                      np.asarray(getattr(ref, field)))


@pytest.mark.parametrize("R", [8, 16])
def test_xy_layout_matches_jax_with_anisotropic_cells(R):
    tgt = _flat_box(9000, seed=22)
    q = (tgt + np.random.default_rng(5).normal(0, 0.02, tgt.shape)).astype(
        np.float32)
    org, c = _geometry(tgt, R, "aniso")
    rows_j, w_j = jpn.grouped_tile_order_device(
        jnp.asarray(q), jnp.asarray(org), jnp.asarray(c), resolution=R,
        group="xy")
    rows_t, w_t = grouped_tile_order_device(
        torch.as_tensor(q), torch.as_tensor(org), torch.as_tensor(c),
        resolution=R, group="xy")
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    # The z-column sweep's invariant: every 128-row tile sits in one
    # (x, y) column.
    cxy = np.clip(((q[rows_t.numpy()][:, :2] - org[:2]) / c[:2]).astype(int),
                  0, R - 1)
    col = (cxy[:, 0] * R + cxy[:, 1]).reshape(-1, 128)
    assert (col.max(axis=1) == col.min(axis=1)).all()


# (zrange, cell): K1 at 12 × 384 = 4608 masked lanes; K2 slot-wise at
# 12 × 3072 = 36864 > 24576; K1 on per-axis cells.
ZCOL_CASES = {
    "K1_fused": (384, "scalar"),
    "K2_slotwise": (3072, "scalar"),
    "K1_fused_aniso": (384, "aniso"),
}


@pytest.mark.parametrize("case", list(ZCOL_CASES))
def test_nn_colsweep_z_matches_jax(case):
    zrange, cell = ZCOL_CASES[case]
    R = 8
    q, tgt = _volume_pair()
    jg, tg, org, c = _zgrid_pair(tgt, R, zrange, cell)
    rows, w = jpn.grouped_tile_order_device(
        jnp.asarray(q), jnp.asarray(org), jnp.asarray(c), resolution=R,
        group="xy")
    ql = q[np.asarray(rows)]
    jm, _, jd, jc, jt = jpn.nn_colsweep_z(
        jnp.asarray(ql), jg, resolution=R, zrange=zrange, return_tie=True)
    tm, _, td, tc, tt = tsn.nn_colsweep_z(
        torch.as_tensor(ql), tg, resolution=R, zrange=zrange,
        return_tie=True)
    jm, jd, jc, jt = (np.asarray(x) for x in (jm, jd, jc, jt))
    tm, td, tc, tt = (x.numpy() for x in (tm, td, tc, tt))
    assert not jt.any() and not tt.any()  # the fixture is tie-free
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_max_ulp(td, jd, maxulp=1)
    np.testing.assert_array_equal(tc, jc)
    real = np.asarray(w) > 0
    assert tc[real].mean() > 0.5
    bi, bd = nn_bruteforce(torch.as_tensor(ql), torch.as_tensor(tgt))
    sel = tc & real
    np.testing.assert_array_equal(tm[sel], tgt[bi.numpy()][sel])
    np.testing.assert_allclose(td[sel], bd.numpy()[sel], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("jitter", [0.0, 1.2])
def test_zcol_exact_chain_matches_jax_and_brute(jitter):
    """Mirror of the JAX package's ``test_zcol_exact_chain_repairs_
    everything``. With each query moved up to 1.2 fine cells after the
    layout was built (an aged layout), tiles outgrow their 12 slots and
    the coarse repair and the brute tiers carry real load."""
    q, tgt = _volume_pair(seed=10)
    R, zrange = 8, 384
    jg, tg, org, c = _zgrid_pair(tgt, R, zrange)
    cell_c = np.float32(max(float((tgt.max(0) - tgt.min(0)).max()) / 8,
                            1e-9))
    jc = jpn._build_grid_dev(jnp.asarray(tgt), jnp.asarray(org),
                             jnp.asarray(cell_c), resolution=8, trange=4096)
    tc = convert.grid_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in jc._fields}, "cpu")
    rows, w = jpn.grouped_tile_order_device(
        jnp.asarray(q), jnp.asarray(org), jnp.asarray(c), resolution=R,
        group="xy")
    ql = q[np.asarray(rows)]
    ql = ql + np.random.default_rng(3).uniform(
        -jitter * c, jitter * c, ql.shape).astype(np.float32)
    kw = dict(resolution=R, coarse_resolution=8, trange=zrange,
              coarse_trange=4096, fine="zcol")
    if jitter:
        _, _, _, cert = tsn.nn_colsweep_z(torch.as_tensor(ql), tg,
                                          resolution=R, zrange=zrange)
        assert not cert.numpy().all()  # the repair chain has work
    jm, _, jd = jpn.nn_colsweep_exact(jnp.asarray(ql), jnp.asarray(tgt), jg,
                                      jc, **kw)
    tm, _, td = tsn.nn_colsweep_exact(torch.as_tensor(ql),
                                      torch.as_tensor(tgt), tg, tc, **kw)
    tm, td = tm.numpy(), td.numpy()
    np.testing.assert_array_equal(tm, np.asarray(jm))
    # Repaired rows lie up to ~2 m from their winners, where the two
    # roundings of d² can land 1 ulp on either side of the exact distance.
    d64 = np.linalg.norm(ql.astype(np.float64) - tm.astype(np.float64),
                         axis=1).astype(np.float32)
    np.testing.assert_array_max_ulp(td, d64, maxulp=1)
    np.testing.assert_array_max_ulp(np.asarray(jd), d64, maxulp=1)
    bi, bd = jax_brute(jnp.asarray(ql), jnp.asarray(tgt))
    real = np.asarray(w) > 0
    np.testing.assert_allclose(td[real], np.asarray(bd)[real], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tm[real], tgt[np.asarray(bi)][real])


def test_zcol_registration_matches_jax():
    """Mirror of ``test_zcol_full_registration_matches_brute``: the JAX
    package forces its z-column kernel (``kernel="zcol"``); the port
    assembles the same ``prepared_nn`` from ``build_zgrids`` and
    ``_pallas_fn(fine="zcol")``."""
    rng = np.random.default_rng(11)
    tgt = rng.uniform(-5, 5, (3000, 3))
    T = random_rigid_transform(seed=2, max_yaw_deg=3.0,
                               max_pitch_roll_deg=1.0, max_txy=0.2,
                               max_tz=0.1)
    src = apply_transform_np(np.linalg.inv(T), tgt) + rng.normal(
        0, 0.01, tgt.shape)
    offset = (tgt.min(axis=0) + tgt.max(axis=0)) / 2.0
    tgtl = (tgt - offset).astype(np.float32)
    R = 8
    j_prep = jpn.make_pallas_nn_device(tgtl, resolution=R, kernel="zcol")
    assert j_prep[0].layout_group == "xy"

    lo, hi = tgtl.min(axis=0).astype(np.float64), tgtl.max(axis=0)
    zrange = auto_zrange(tgtl, R)
    coarse_trange = 16384  # the factory's cap when R is given
    t_tgt = torch.as_tensor(tgtl)
    grid, coarse = build_zgrids(
        t_tgt, torch.as_tensor(lo, dtype=torch.float32),
        torch.as_tensor(np.maximum((hi - lo) / R, 1e-9), dtype=torch.float32),
        torch.tensor(max(float((hi - lo).max()) / 8, 1e-9),
                     dtype=torch.float32),
        resolution=R, zrange=zrange, coarse_resolution=8,
        coarse_trange=coarse_trange)
    for jgrid, tgrid in ((j_prep[1][0], grid), (j_prep[1][1], coarse)):
        for f in jgrid._fields:
            np.testing.assert_array_equal(getattr(tgrid, f).numpy(),
                                          np.asarray(getattr(jgrid, f)))
    fn = tsn._pallas_fn(R, 8, zrange, coarse_trange, True, slabs=4,
                        fine="zcol")
    assert fn.layout_group == "xy"
    kw = dict(max_iterations=10, tolerance=1e-9)
    ref = jax_icp(src, tgt, dtype=jnp.float32, prepared_nn=j_prep, **kw)
    res = icp_register(src, tgt, prepared_nn=(fn, (grid, coarse, None), R),
                       device="cpu", **kw)
    assert res.iterations == ref.iterations
    assert res.stop_reason == ref.stop_reason
    np.testing.assert_allclose(res.history_rmse, ref.history_rmse,
                               rtol=1e-5)
    np.testing.assert_allclose(res.transform, ref.transform, atol=1e-5)
    # The same trajectory as exact brute force, as in the JAX package.
    brute = icp_register(src, tgt, nn_backend="bruteforce", device="cpu",
                         **kw)
    assert brute.iterations == res.iterations
    np.testing.assert_allclose(res.transform, brute.transform, atol=1e-5)


def test_zcol_certified_rows_match_kdtree_on_flat_box():
    """Per-axis cells on a 10:10:1 box: the certified rows of the port's
    z-column sweep are exact against a k-d tree (f64)."""
    tgt = _flat_box(20_000, seed=23)
    q = tgt[::2] + np.random.default_rng(6).normal(
        0, 0.01, (10_000, 3)).astype(np.float32)
    R, zrange = 8, 512
    org, c = _geometry(tgt, R, "aniso")
    grid = build_zgrid(torch.as_tensor(tgt), torch.as_tensor(org),
                       torch.as_tensor(c), resolution=R, zrange=zrange)
    rows, w = grouped_tile_order_device(
        torch.as_tensor(q), grid.origin, grid.cell_size, resolution=R,
        group="xy")
    ql = torch.as_tensor(q)[rows]
    m, _, d, cert = tsn.nn_colsweep_z(ql, grid, resolution=R, zrange=zrange)
    sel = (cert & (w > 0)).numpy()
    assert sel.mean() > 0.5
    d_ref, i_ref = cKDTree(tgt.astype(np.float64)).query(
        ql.numpy().astype(np.float64))
    np.testing.assert_array_equal(m.numpy()[sel], tgt[i_ref][sel])
    np.testing.assert_allclose(d.numpy()[sel], d_ref[sel], rtol=1e-6,
                               atol=1e-6)
