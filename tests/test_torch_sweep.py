"""Port parity: the slab sweep (K1 and K2 through their plain version),
K3's plain version ``nn_bruteforce`` and the exact repair chain against
the JAX package, whose Pallas kernel runs in interpret mode on the CPU.

Both sweeps read the SAME grid (built by the JAX package, carried over by
``convert.grid_from_numpy``). K3 is held against the JAX kernel's
first-tie form on the one-cell grid that the JAX package runs it on.
Tolerances and why:

* ``matched`` and ``certified`` must be equal on tie-free inputs;
* ``dist`` may differ by 1 ulp: XLA's CPU backend contracts the kernel's
  d² sum into FMAs, while the port rounds every operation on its own (as
  the TPU and the CUDA kernels do);
* on inputs with exact ties the port's tie rule (another row index at the
  winner's d², anywhere in the window) flags a superset of the JAX
  kernel's (equal d² inside the winning chunk);
* exact results are held against ``scipy.spatial.cKDTree`` at 1e-5 m
  plus 1e-6 relative (f32 coordinates of a cloud ~100 m across; far
  outliers sit ~250 m away).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from scipy.spatial import cKDTree

from iterativeclosestpoint_tpu.ops import pallas_nn as jpn
from iterativeclosestpoint_tpu.ops.cellblock import morton_order
from iterativeclosestpoint_tpu.utils.synth import make_cloud
from iterativeclosestpoint_tpu_torch import convert
from iterativeclosestpoint_tpu_torch.ops import sweep_nn as tsn
from iterativeclosestpoint_tpu_torch.ops.bruteforce import nn_bruteforce
from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import (
    colsweep,
    colsweep_plain,
)

# (fused, resolution, slabs, trange): K1 on a boosted-surface shape, K2 on
# a coarse-repair shape. K3 ("K3_first_tie") has its own runner below.
VARIANTS = {
    "K1_fused": (True, 32, 4, 768),
    "K2_slotwise": (False, 16, 4, 2048),
    "K3_first_tie": None,
}


def _grid_pair(tgt, R, trange):
    jg = jpn.build_pallas_grid(tgt, R, trange=trange)
    d = {f: np.asarray(getattr(jg, f)) for f in jg._fields}
    return jg, convert.grid_from_numpy(d, "cpu")


def _run_both(q, tgt, variant):
    """Lay ``q`` out in x-group tiles and sweep it in both packages."""
    fused, R, slabs, trange = VARIANTS[variant]
    jg, tg = _grid_pair(tgt, R, trange)
    rows, _ = jpn.grouped_tile_order(q, jg, R)
    q = q[rows]
    chunk = jpn.fused_sweep_chunk(slabs, trange) if fused else 2048
    jm, _, jd, jc, jt = jpn.nn_colsweep(
        jnp.asarray(q, jnp.float32), jg, resolution=R, slabs=slabs,
        trange=trange, fused=fused, chunk=chunk, return_tie=True)
    tm, _, td, tc, tt = tsn.nn_colsweep(
        torch.as_tensor(q, dtype=torch.float32), tg, resolution=R,
        slabs=slabs, trange=trange, fused=fused, return_tie=True)
    return q, ((np.asarray(jm), np.asarray(jd), np.asarray(jc),
                np.asarray(jt)), (tm.numpy(), td.numpy(), tc.numpy(),
                                  tt.numpy()))


def _queries(pts, seed, sigma):
    return pts + np.random.default_rng(seed).normal(0, sigma, pts.shape)


def _check_k3_against_jax(q, tgt):
    """K3's plain version against the JAX kernel's first-tie form on the
    one-cell grid (one slab spanning the whole target), as the JAX package
    runs its brute NN. Returns the port's distances."""
    trange = max(-(-len(tgt) // 128) * 128, 128)
    jg = jpn.build_pallas_grid(tgt, 1, trange=trange)
    jm, _, jd, _ = jpn.nn_colsweep(jnp.asarray(q, jnp.float32), jg,
                                   resolution=1, slabs=1, trange=trange,
                                   first_tie=True)
    t32 = tgt.astype(np.float32)
    idx, td = nn_bruteforce(torch.as_tensor(q, dtype=torch.float32),
                            torch.as_tensor(t32))
    # The target's points are distinct, so equal winner coordinates are
    # equal winner indices.
    jd0, j_idx = cKDTree(t32).query(np.asarray(jm))
    assert not jd0.any()
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    np.testing.assert_array_max_ulp(td.numpy(), np.asarray(jd), maxulp=1)
    return td.numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_colsweep_matches_jax_tie_free(variant):
    tgt = make_cloud(6000, seed=80)
    q = _queries(tgt[:3000], 0, 0.05)
    if variant == "K3_first_tie":
        td = _check_k3_against_jax(q, tgt)
        d_ref, _ = cKDTree(tgt).query(q)
        np.testing.assert_allclose(td, d_ref, rtol=0, atol=1e-5)
        return
    q, ((jm, jd, jc, jt), (tm, td, tc, tt)) = _run_both(q, tgt, variant)
    assert not jt.any() and not tt.any()  # the fixture is tie-free
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_max_ulp(td, jd, maxulp=1)
    np.testing.assert_array_equal(tc, jc)
    assert tc.mean() > 0.5
    d_ref, _ = cKDTree(tgt).query(q)
    np.testing.assert_allclose(td[tc], d_ref[tc], rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", ["K1_fused", "K2_slotwise"])
def test_tie_flags_superset_on_duplicates(variant):
    base = make_cloud(1500, seed=81)
    tgt = np.repeat(base, 2, axis=0)  # every point twice: exact d² ties
    q = _queries(base, 1, 0.03)
    _, ((jm, jd, jc, jt), (tm, td, tc, tt)) = _run_both(q, tgt, variant)
    assert jt.sum() > 100
    assert not (jt & ~tt).any()  # superset of the reference's tie flags
    assert not (tc & ~jc).any()  # so certification is at most as wide
    same = jc & tc
    np.testing.assert_array_equal(tm[same], jm[same])


def test_colsweep_rows_and_overlap_ties():
    """The tie rule counts another ROW at the winner's d²: K2's
    overlapping windows scan the winner twice without a tie, while a
    duplicated point in the window is one."""
    tgt_t = torch.full((8, 512 + 256), 1e6)
    pts = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    tgt_t[0:3, 0:3] = pts.T
    q = torch.zeros((128, 3))
    q[1] = torch.tensor([2.9, 0.0, 0.0])
    base = torch.zeros((1, 2), dtype=torch.int32)  # same window twice
    out = colsweep(base, q, tgt_t, slabs=2, trange=256, fused=False)
    assert out[0, 7, 0] == 1.0 and out[0, 0, 0] == 0.0  # unique, twice seen
    assert out[0, 7, 1] == 2.0 and out[0, 0, 1] == 3.0  # rows 1 and 2 tie
    assert torch.equal(out, colsweep_plain(base, q, tgt_t, slabs=2,
                                           trange=256, fused=False))


def _exact_check(q, tgt, m, d):
    d_ref, i_ref = cKDTree(tgt).query(q)
    np.testing.assert_allclose(d, d_ref, rtol=1e-6, atol=1e-5)
    # Winners may differ from the k-d tree only on f32 distance ties.
    off = np.any(m != tgt.astype(np.float32)[i_ref], axis=1)
    d_alt = np.linalg.norm(q - m, axis=1)
    np.testing.assert_allclose(d_alt[off], d_ref[off], rtol=1e-6, atol=1e-5)


def _exact_both(q, tgt, R, coarse=None, **kw):
    qj, tj = jnp.asarray(q, jnp.float32), jnp.asarray(tgt, jnp.float32)
    jg, tg = _grid_pair(tgt, R, kw.pop("trange", 2048))
    jc = tc = None
    if coarse is not None:
        Rc, ctr = coarse
        jc, tc = _grid_pair(tgt, Rc, ctr)
        kw.update(coarse_resolution=Rc, coarse_trange=ctr)
    jm, _, jd = jpn.nn_colsweep_exact(qj, tj, jg, jc, resolution=R, **kw)
    tm, _, td = tsn.nn_colsweep_exact(
        torch.as_tensor(q, dtype=torch.float32),
        torch.as_tensor(tgt, dtype=torch.float32), tg, tc, resolution=R,
        **kw)
    return np.asarray(jm), np.asarray(jd), tm.numpy(), td.numpy()


def test_exact_coarse_repair_plus_budgeted_brute():
    """Queries ~1.2 fine cells off: the fine pass leaves stragglers, the
    coarse level certifies most, budgeted brute mops up the rest."""
    tgt = make_cloud(8000, seed=85)
    R = 32
    cell = float((tgt.max(0) - tgt.min(0)).max()) / R
    rng = np.random.default_rng(3)
    q = tgt + rng.uniform(-1.2 * cell, 1.2 * cell, tgt.shape)
    q = q[morton_order(q, R)]
    _, tg = _grid_pair(tgt, R, 2048)
    _, _, _, cert_f = tsn.nn_colsweep(torch.as_tensor(q, dtype=torch.float32),
                                      tg, resolution=R)
    assert not cert_f.numpy().all()
    jm, jd, tm, td = _exact_both(
        q, tgt, R, coarse=(R // 4, 8192), coarse_budget=16384,
        brute_passes=8, global_fallback=False)
    _exact_check(q, tgt, tm, td)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_max_ulp(td, jd, maxulp=1)


def test_exact_budget_overflow_global_fallback_ragged_n():
    """More far outliers than the brute budget, and N not a tile
    multiple: the global fallback still returns exact 1-NN."""
    tgt = make_cloud(3000, seed=86)
    rng = np.random.default_rng(4)
    q = np.vstack([tgt[:1111] + rng.normal(0, 0.02, (1111, 3)),
                   rng.uniform(-200, 200, (997, 3))])
    q = q[morton_order(q, 16)]
    jm, jd, tm, td = _exact_both(q, tgt, 16, brute_batch=128,
                                 brute_passes=1, global_fallback=True)
    _exact_check(q, tgt, tm, td)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_max_ulp(td, jd, maxulp=1)


def test_exact_tie_decertifies_and_repairs():
    """Triplicated target points: every query ties, decertifies, and the
    brute stage returns the first-tie winner, as the reference does."""
    rng = np.random.default_rng(8)
    base = rng.normal(size=(40, 3))
    tgt = np.repeat(base, 3, axis=0)
    q = base + rng.normal(0, 0.05, base.shape)
    q = q[morton_order(q, 8)]
    _, tg = _grid_pair(tgt, 8, 2048)
    _, _, _, cert = tsn.nn_colsweep(torch.as_tensor(q, dtype=torch.float32),
                                    tg, resolution=8)
    assert not cert.numpy().any()
    jm, jd, tm, td = _exact_both(q, tgt, 8, brute_batch=512, brute_passes=4)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_max_ulp(td, jd, maxulp=1)
    _exact_check(q, tgt, tm, td)


@pytest.mark.parametrize("case", ["tiny_n", "collinear_x", "one_cell",
                                  "dup_points"])
def test_exact_degenerate_geometry(case):
    rng = np.random.default_rng
    if case == "tiny_n":
        q, tgt = rng(0).normal(size=(50, 3)), rng(1).normal(size=(70, 3))
    elif case == "collinear_x":
        q = np.c_[np.linspace(0, 100, 1500), np.zeros(1500), np.zeros(1500)]
        tgt = np.c_[np.linspace(0, 100, 1200), np.zeros(1200),
                    np.zeros(1200)]
    elif case == "one_cell":
        q = np.full((300, 3), 5.0) + rng(2).normal(0, 1e-6, (300, 3))
        tgt = np.full((400, 3), 5.0) + rng(3).normal(0, 1e-6, (400, 3))
    else:
        q = np.repeat(rng(4).normal(size=(10, 3)), 30, axis=0)
        tgt = np.repeat(rng(5).normal(size=(12, 3)), 25, axis=0)
    R = jpn.auto_resolution_data(tgt)
    jm, jd, tm, td = _exact_both(q, tgt, R)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)
    d_ref, _ = cKDTree(tgt).query(q)
    np.testing.assert_allclose(td, d_ref, rtol=0, atol=1e-4)
