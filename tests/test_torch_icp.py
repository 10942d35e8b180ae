"""Port parity: the ICP loop and multiscale driver against the f64 NumPy
oracle and the JAX package, on the CPU with the kernels' plain versions.

Tolerances and why:

* f64 brute-force trajectory against ``utils/oracle.py``: 1e-9, the
  repository's oracle gate (only summation order differs);
* f32 pallas runs against the JAX functions: same iteration count and stop
  code, and ``registration_error`` ≤ 1e-4 m (the f32 parity gate of
  PARITY.md). The two packages sum the f32 statistics and covariances in
  different orders, so poses agree to f32 roundoff of converged fits, not
  bit for bit. Fixtures are chosen to converge, where that holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.models.icp import icp_register as jax_icp
from iterativeclosestpoint_tpu.models.multiscale import (
    icp_register_multiscale as jax_multiscale,
)
from iterativeclosestpoint_tpu.utils.oracle import oracle_icp
from iterativeclosestpoint_tpu.utils.synth import (
    apply_transform_np,
    make_registration_pair,
)
from iterativeclosestpoint_tpu_torch import (
    convert,
    icp_register,
    icp_register_multiscale,
)
from iterativeclosestpoint_tpu_torch.models import icp as ticp

UTM = np.array([500_000.0, 4_000_000.0, 1_200.0])


def _reg_err(Ta, Tb, pts):
    pa = pts @ Ta[:3, :3].T + Ta[:3, 3]
    pb = pts @ Tb[:3, :3].T + Tb[:3, 3]
    return float(np.linalg.norm(pa - pb, axis=1).max())


@pytest.mark.parametrize("mode", ["gui", "cli"])
@pytest.mark.parametrize("seed", [0, 3])
def test_f64_brute_trajectory_matches_oracle(mode, seed):
    src, tgt, _ = make_registration_pair(n=2000, seed=seed, noise_sigma=0.02)
    res = icp_register(src, tgt, dtype=torch.float64, mode=mode,
                       max_iterations=30, center=False,
                       nn_backend="bruteforce", device="cpu")
    ref = oracle_icp(src, tgt, max_iterations=30, mode=mode)
    assert res.iterations == len(ref.history)
    assert res.message == ref.message
    for i, h in enumerate(ref.history):
        assert res.history_valid[i] == h.valid_points, f"iter {i}"
        np.testing.assert_allclose(res.history_rmse[i], h.rmse, rtol=1e-9)
        np.testing.assert_allclose(res.history_transform[i], h.transform,
                                   atol=1e-9)
    np.testing.assert_allclose(res.transform, ref.transform, atol=1e-9)
    np.testing.assert_allclose(res.source_registered, ref.source_registered,
                               atol=1e-8)


def test_f32_pallas_icp_matches_jax(one_torch_thread):
    """At one thread and at torch's own thread count. A reduction's order
    follows the thread count, so a fixture whose convergence test is a
    near miss stops one iteration apart on different counts; this one
    (its first |ΔRMSE| below the tolerance is ~7e-8, against 1e-6) stops
    where the JAX package does on every count."""
    src, tgt, _ = make_registration_pair(n=6000, seed=87, noise_sigma=0.01)
    kw = dict(nn_backend="pallas", max_iterations=30)
    ref = jax_icp(src, tgt, dtype=jnp.float32, **kw)
    for threads in sorted({1, one_torch_thread}):
        torch.set_num_threads(threads)
        try:
            res = icp_register(src, tgt, device="cpu", **kw)
        finally:
            torch.set_num_threads(1)
        assert res.nn_resolution == ref.nn_resolution
        assert (res.iterations, res.stop_reason) == (
            ref.iterations, ref.stop_reason), threads
        assert _reg_err(res.transform, ref.transform, src) <= 1e-4
        # The tile layout is undone on the registered cloud.
        np.testing.assert_allclose(res.source_registered,
                                   apply_transform_np(res.transform, src),
                                   atol=1e-3)


@pytest.mark.parametrize("offset", ["local", "utm"])
def test_f32_pallas_multiscale_matches_jax(offset):
    src, tgt, T_true = make_registration_pair(n=12000, seed=95,
                                              noise_sigma=0.01)
    off = UTM if offset == "utm" else np.zeros(3)
    kw = dict(nn_backend="pallas", max_iterations=30, coarse_max_points=2000,
              return_registered=False)
    ref = jax_multiscale(src + off, tgt + off, dtype=jnp.float32, **kw)
    res = icp_register_multiscale(src + off, tgt + off, device="cpu", **kw)
    assert [s for s, _ in res.levels] == [s for s, _ in ref.levels]
    for (_, a), (_, b) in zip(res.levels, ref.levels):
        assert (a.iterations, a.stop_reason) == (b.iterations, b.stop_reason)
    assert _reg_err(res.transform, ref.transform, src + off) <= 1e-4
    T_utm = T_true.copy()
    T_utm[:3, 3] = T_true[:3, 3] + off - T_true[:3, :3] @ off
    assert _reg_err(res.transform, T_utm, src + off) < 1e-3


def test_loop_step_from_jax_carry():
    """One iteration from a mid-run carry taken over from the JAX package
    lands on the JAX package's next pose (f64, brute force)."""
    from iterativeclosestpoint_tpu.models.icp import _brute_adapter, _icp_core

    src, tgt, _ = make_registration_pair(n=1500, seed=4, noise_sigma=0.02)
    first = jax_icp(src, tgt, dtype=jnp.float64, max_iterations=3,
                    tolerance=0.0, center=False)
    carry = (first.carry_transform_local, first.carry_prev_error,
             first.carry_no_improve)
    jout = _icp_core(jnp.asarray(src), jnp.asarray(tgt), (),
                     tuple(jnp.asarray(c) for c in carry), nn_fn=_brute_adapter,
                     max_iterations=1, tolerance=0.0, sigma_multiplier=3.0,
                     widen_first=False)
    s, t = (torch.as_tensor(x, dtype=torch.float64) for x in (src, tgt))
    out = ticp.icp_core(
        s, torch.ones(len(src), dtype=torch.float64), t, (),
        nn_fn=ticp._brute_adapter, max_iterations=1, tolerance=0.0,
        sigma_multiplier=3.0, widen_first=False,
        carry=convert.carry_from_numpy(*carry, dtype=torch.float64,
                                       device="cpu"))
    np.testing.assert_allclose(out["T_cum"].numpy(), np.asarray(jout["T_cum"]),
                               atol=1e-12)
    np.testing.assert_allclose(out["h_rmse"].numpy(),
                               np.asarray(jout["h_rmse"]), rtol=1e-12)


@pytest.mark.parametrize("option,item", [
    # cell_capacity reaches only the hashgrid backend (the JAX rule).
    (dict(nn_backend="hashgrid", cell_capacity=16), "runs"),
    (dict(nn_backend="hashgrid"), "runs"),
    # The JAX package's rule: plane mode needs normals, which only the
    # brute-force and pallas backends carry.
    (dict(estimator="plane", nn_backend="cellblock"), "plane"),
    (dict(nn_backend="cellblock"), "runs"),
])
def test_unported_options_raise(option, item):
    """The test and reference backends run (f32, point mode) and follow
    the JAX package's trajectory: same iterations, stop code and grid
    resolution, transforms within 1e-4 m. Plane mode with them raises."""
    src, tgt, _ = make_registration_pair(n=300, seed=1, noise_sigma=0.01)
    if item == "plane":
        with pytest.raises(ValueError, match=item):
            icp_register(src, tgt, device="cpu", max_iterations=1, **option)
        return
    res = icp_register(src, tgt, device="cpu", **option)
    ref = jax_icp(src, tgt, dtype=jnp.float32, **option)
    assert (res.iterations, res.stop_reason, res.nn_resolution) == (
        ref.iterations, ref.stop_reason, ref.nn_resolution)
    assert _reg_err(res.transform, ref.transform, src) <= 1e-4
    np.testing.assert_allclose(res.source_registered,
                               ref.source_registered, atol=1e-4)


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_cell_capacity_ignored_off_hashgrid(backend):
    """The session passes cell_capacity (default 10) on every run; off
    the hashgrid backend it changes nothing, bit for bit."""
    src, tgt, _ = make_registration_pair(n=2000, seed=5, noise_sigma=0.01)
    kw = dict(nn_backend=backend, max_iterations=6, device="cpu")
    a = icp_register(src, tgt, cell_capacity=10, **kw)
    b = icp_register(src, tgt, **kw)
    assert a.iterations == b.iterations and a.nn_resolution == b.nn_resolution
    for f in ("transform", "history_rmse", "history_transform",
              "source_registered"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def _ms_pair():
    return make_registration_pair(n=6000, seed=95, noise_sigma=0.01)[:2]


_MS_KW = dict(nn_backend="pallas", max_iterations=10, coarse_max_points=1500,
              return_registered=False)


@pytest.mark.parametrize("option", [
    dict(coarse_nn_backend="auto"), dict(coarse_nn_backend="bruteforce"),
    dict(overlap_device_prep=True), dict(overlap_device_prep=False),
])
def test_multiscale_options_change_nothing(option):
    """``coarse_nn_backend`` "auto" picks brute force at the coarse
    level's size, so "bruteforce" is the same run; ``overlap_device_prep``
    is the JAX package's TPU upload ordering and changes nothing here."""
    src, tgt = _ms_pair()
    a = icp_register_multiscale(src, tgt, device="cpu", **option, **_MS_KW)
    b = icp_register_multiscale(src, tgt, device="cpu", **_MS_KW)
    assert [(s, r.iterations) for s, r in a.levels] == [
        (s, r.iterations) for s, r in b.levels]
    for (_, x), (_, y) in zip(a.levels, b.levels):
        np.testing.assert_array_equal(x.transform, y.transform)
        np.testing.assert_array_equal(x.history_rmse, y.history_rmse)


def test_coarse_pallas_matches_jax():
    """``coarse_nn_backend="pallas"`` reaches the coarse level: its grid
    matches the JAX package's choice, level by level."""
    src, tgt = _ms_pair()
    kw = dict(_MS_KW, coarse_nn_backend="pallas")
    ref = jax_multiscale(src, tgt, dtype=jnp.float32, **kw)
    res = icp_register_multiscale(src, tgt, device="cpu", **kw)
    for (s, a), (t, b) in zip(res.levels, ref.levels):
        assert (s, a.iterations, a.stop_reason, a.nn_resolution) == (
            t, b.iterations, b.stop_reason, b.nn_resolution)
    assert res.levels[0][1].nn_resolution is not None  # a grid, not brute
    assert _reg_err(res.transform, ref.transform, src) <= 1e-4


@pytest.mark.parametrize("backend,exc,item", [
    ("hashgrid", None, None),
    ("cellblock", None, None),
    ("kdtree", ValueError, "coarse_nn_backend"),
])
def test_coarse_backend_raises_before_any_level(monkeypatch, backend, exc,
                                                item):
    """An unknown coarse backend raises before any level runs; the test
    and reference backends run the coarse level as the JAX package does
    (same grid resolution, iterations and stop codes level by level)."""
    from iterativeclosestpoint_tpu_torch.models import multiscale

    src, tgt = _ms_pair()
    if exc is None:
        kw = dict(_MS_KW, coarse_nn_backend=backend, max_iterations=3)
        res = icp_register_multiscale(src, tgt, device="cpu", **kw)
        ref = jax_multiscale(src, tgt, dtype=jnp.float32, **kw)
        assert res.levels[0][1].nn_resolution is not None
        for (s, a), (t, b) in zip(res.levels, ref.levels):
            assert (s, a.iterations, a.stop_reason, a.nn_resolution) == (
                t, b.iterations, b.stop_reason, b.nn_resolution)
        assert _reg_err(res.transform, ref.transform, src) <= 1e-4
        return

    def no_level(*a, **k):
        raise AssertionError("a level ran before the option was checked")

    monkeypatch.setattr(multiscale, "icp_register", no_level)
    with pytest.raises(exc, match=item):
        icp_register_multiscale(src, tgt, device="cpu",
                                coarse_nn_backend=backend, **_MS_KW)


def _volume_box():
    """The 50k 10:10:1 box of the JAX package's regime test."""
    rng = np.random.default_rng(0)
    vol = rng.uniform(-50, 50, (50_000, 3)).astype(np.float32)
    vol[:, 2] *= 0.2
    return vol


def test_unported_multiscale_and_regime_raise():
    """The multi-device options run (a 2-rank CPU mesh, data-parallel
    and partitioned, within 1e-9 m of the single-device run in f64); an
    unknown ``fine_path`` raises. The kernel-regime gate no longer
    raises: on a volume cloud both factories pick the z-column sweep with
    the same (R, zrange) and the same anisotropic z-grid, and a terrain
    cloud of the same size still gets the slab sweep."""
    from iterativeclosestpoint_tpu.ops.pallas_nn import (
        make_pallas_nn_device as jax_make,
    )
    from iterativeclosestpoint_tpu.utils.synth import make_cloud
    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import ZPallasGrid
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
    )

    from iterativeclosestpoint_tpu_torch.parallel import make_mesh

    # A noisy pair: on a noise-free one the run ends at ~1e-14 RMSE,
    # where the 1.1x divergence stop fires on last-bit differences of the
    # rank sums (the JAX tests note the same).
    src, tgt, _ = make_registration_pair(n=400, seed=1, noise_sigma=0.02)
    kw = dict(device="cpu", dtype=torch.float64, strides=(4, 1),
              max_iterations=10)
    one = icp_register_multiscale(src, tgt, **kw)
    mesh = make_mesh(devices=["cpu"] * 2)
    for fp in ("auto", "partitioned"):
        two = icp_register_multiscale(src, tgt, mesh=mesh, fine_path=fp,
                                      **kw)
        assert two.final.iterations == one.final.iterations
        assert _reg_err(two.transform, one.transform, src) < 1e-9
    with pytest.raises(ValueError, match="fine_path"):
        icp_register_multiscale(src, tgt, mesh=mesh, fine_path="ring", **kw)
    vol = _volume_box()
    j_fn, (j_grid, j_coarse, _), j_R = jax_make(vol)
    t_fn, (t_grid, t_coarse, _), t_R = make_pallas_nn_device(vol, device="cpu")
    assert j_fn.layout_group == t_fn.layout_group == "xy"
    assert isinstance(t_grid, ZPallasGrid) and t_grid.cell_size.shape == (3,)
    zr = t_grid.tgt_t.shape[1] - len(vol)
    assert (t_R, zr) == (j_R, j_grid.tgt_t.shape[1] - len(vol)) == (8, 1024)
    for jg, tg in ((j_grid, t_grid), (j_coarse, t_coarse)):
        for f in jg._fields:
            np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                          np.asarray(getattr(jg, f)),
                                          err_msg=f)
    ter = make_cloud(50_000, seed=1, kind="terrain", extent=50.0)
    ter = (ter - ter.mean(0)).astype(np.float32)
    assert jax_make(ter)[0].layout_group == "x"
    assert make_pallas_nn_device(ter, device="cpu")[0].layout_group == "x"


def test_zcol_exact_chain_on_volume_box_matches_kdtree():
    """The factory's z-column nn_fn on the 50k box, plain kernels on the
    CPU: every real row's distance equals a k-d tree's (f64) to 1e-6 m
    plus 1e-6 relative, f32 coordinates of a box 100 m across."""
    from scipy.spatial import cKDTree

    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
        grouped_tile_order_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
    )

    vol = _volume_box()
    fn, state, R = make_pallas_nn_device(vol, device="cpu")
    q = torch.as_tensor(vol + np.random.default_rng(1).normal(
        0, 0.05, vol.shape).astype(np.float32))
    rows, w = grouped_tile_order_device(q, state[0].origin,
                                        state[0].cell_size, resolution=R,
                                        group=fn.layout_group)
    t = torch.as_tensor(vol)
    _, d = fn(q[rows], t, state)
    real = (w > 0).numpy()
    assert real.sum() == len(vol)
    qh = q[rows].numpy()[real].astype(np.float64)
    d_ref, _ = cKDTree(vol.astype(np.float64)).query(qh)
    np.testing.assert_allclose(d.numpy()[real], d_ref, rtol=1e-6, atol=1e-6)
