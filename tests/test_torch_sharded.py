"""Port parity: data-parallel ICP (``parallel/sharded.py``) on CPU mesh
ranks, against the port's single-device path, the f64 NumPy oracle and
the JAX package's ``icp_register_sharded`` on as many virtual devices
(mirrors ``tests/test_sharded.py``).

Tolerances and why:

* f64 sharded against single device, and against the JAX package on the
  same mesh size: the JAX test's own (history rmse rtol 1e-12, transforms
  atol 1e-12, registered cloud atol 1e-10): only the order of the rank
  sums differs;
* f64 against the oracle: 1e-9, the repository's oracle gate;
* robust (tukey): the median is the exact global order statistic on both
  paths, so the JAX test's 1e-4 is tightened to the f64 1e-12;
* a 1-rank mesh and ``icp_register`` run the same operations on the same
  rows: bit for bit, f32;
* f32 multiscale over 4 ranks: same iterations and stop code, 1e-4 m
  registration error (the f32 gate of PARITY.md);
* collective payload: exact byte counts per iteration and rank (84 B in
  point mode, 188 B in plane mode, the JAX package's HLO count; 212 B
  with tukey's 31 bisection counts), each under 1 KB.

About 60 s alone on one worker (the JAX side's 8-device compiles take
most of it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.parallel.mesh import make_mesh as jax_mesh
from iterativeclosestpoint_tpu.parallel.sharded import (
    icp_register_sharded as jax_sharded,
)
from iterativeclosestpoint_tpu.utils.oracle import oracle_icp
from iterativeclosestpoint_tpu.utils.synth import (
    apply_transform_np,
    make_registration_pair,
)
from iterativeclosestpoint_tpu_torch import (
    icp_register,
    icp_register_multiscale,
)
from iterativeclosestpoint_tpu_torch.models.icp import (
    _brute_adapter,
    _brute_plane_adapter,
)
from iterativeclosestpoint_tpu_torch.ops.normals import (
    estimate_normals_cellpca,
)
from iterativeclosestpoint_tpu_torch.parallel import (
    icp_register_sharded,
    make_mesh,
)
from iterativeclosestpoint_tpu_torch.parallel.sharded import run_loop

F64 = torch.float64


def _mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _reg_err(Ta, Tb, pts):
    return float(np.abs(apply_transform_np(Ta, pts)
                        - apply_transform_np(Tb, pts)).max())


def _same_run(a, b, rtol=1e-12, atol=1e-12):
    assert a.iterations == b.iterations
    assert a.message == b.message
    np.testing.assert_array_equal(a.history_valid, b.history_valid)
    np.testing.assert_allclose(a.history_rmse, b.history_rmse, rtol=rtol)
    np.testing.assert_allclose(a.transform, b.transform, atol=atol)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matches_single_device(n_dev):
    """f64 sharded = single device and = the JAX package's sharded run on
    as many devices, at the JAX test's tolerances."""
    src, tgt, _ = make_registration_pair(n=2001, seed=30, noise_sigma=0.02)
    res_1 = icp_register(src, tgt, dtype=F64, max_iterations=20,
                         device="cpu")
    res_n = icp_register_sharded(src, tgt, mesh=_mesh(n_dev), dtype=F64,
                                 max_iterations=20)
    res_j = jax_sharded(src, tgt, mesh=jax_mesh(n_devices=n_dev),
                        dtype=jnp.float64, max_iterations=20)
    for ref in (res_1, res_j):
        _same_run(res_n, ref)
        np.testing.assert_allclose(res_n.source_registered,
                                   ref.source_registered, atol=1e-10)


def test_sharded_matches_oracle():
    src, tgt, _ = make_registration_pair(n=1000, seed=31)
    res = icp_register_sharded(src, tgt, mesh=_mesh(8), dtype=F64,
                               max_iterations=25, center=False)
    ref = oracle_icp(src, tgt, max_iterations=25)
    assert res.iterations == len(ref.history)
    for i, h in enumerate(ref.history):
        assert res.history_valid[i] == h.valid_points
        np.testing.assert_allclose(res.history_rmse[i], h.rmse, rtol=1e-9,
                                   atol=1e-12)
    np.testing.assert_allclose(res.transform, ref.transform, atol=1e-9)


def test_sharded_hashgrid_backend():
    src, tgt, _ = make_registration_pair(n=1500, seed=32, noise_sigma=0.01)
    res_g = icp_register_sharded(src, tgt, mesh=_mesh(4), dtype=F64,
                                 nn_backend="hashgrid")
    res_b = icp_register(src, tgt, dtype=F64, nn_backend="bruteforce",
                         device="cpu")
    assert res_g.iterations == res_b.iterations
    np.testing.assert_allclose(res_g.transform, res_b.transform, atol=1e-9)


def test_sharded_plane_matches_single_device():
    src, tgt, _ = make_registration_pair(n=2001, seed=33, noise_sigma=0.01,
                                         kind="terrain")
    kw = dict(dtype=F64, max_iterations=15, estimator="plane")
    res_1 = icp_register(src, tgt, device="cpu", **kw)
    res_n = icp_register_sharded(src, tgt, mesh=_mesh(4), **kw)
    _same_run(res_n, res_1)


def test_sharded_robust_matches_single_device():
    """tukey under the mesh: the exact global median makes the sharded
    trajectory the single-device one to f64 roundoff."""
    src, tgt, _ = make_registration_pair(n=2000, seed=34, noise_sigma=0.01,
                                         outlier_frac=0.1)
    kw = dict(dtype=F64, max_iterations=15, robust="tukey")
    res_1 = icp_register(src, tgt, device="cpu", **kw)
    res_n = icp_register_sharded(src, tgt, mesh=_mesh(4), **kw)
    _same_run(res_n, res_1)


def test_sharded_segmented_trajectory_identical():
    src, tgt, _ = make_registration_pair(n=1501, seed=35, noise_sigma=0.02)
    kw = dict(mesh=_mesh(4), dtype=F64, max_iterations=12, tolerance=1e-9)
    one = icp_register_sharded(src, tgt, **kw)
    seen = []
    seg = icp_register_sharded(src, tgt, segment_iterations=5,
                               progress_callback=seen.append, **kw)
    assert seg.iterations == one.iterations
    assert len(seen) == one.iterations
    np.testing.assert_array_equal(seg.history_rmse, one.history_rmse)
    np.testing.assert_array_equal(seg.history_transform,
                                  one.history_transform)
    np.testing.assert_array_equal(seg.source_registered,
                                  one.source_registered)


def test_sharded_resume_bit_identical():
    src, tgt, _ = make_registration_pair(n=1501, seed=36, noise_sigma=0.02)
    kw = dict(mesh=_mesh(4), dtype=F64, tolerance=1e-9)
    full = icp_register_sharded(src, tgt, max_iterations=12, **kw)
    first = icp_register_sharded(src, tgt, max_iterations=5, **kw)
    resumed = icp_register_sharded(
        src, tgt, max_iterations=7,
        resume_carry={
            "transform": first.transform,
            "transform_local": first.carry_transform_local,
            "offset": first.center_offset,
            "prev_error": first.carry_prev_error,
            "no_improve": first.carry_no_improve,
        }, **kw)
    np.testing.assert_array_equal(
        np.concatenate([first.history_rmse, resumed.history_rmse]),
        full.history_rmse)
    np.testing.assert_array_equal(
        np.concatenate([first.history_transform, resumed.history_transform]),
        full.history_transform)
    np.testing.assert_array_equal(resumed.source_registered,
                                  full.source_registered)


@pytest.mark.parametrize("estimator,robust,per_iter", [
    ("point", "none", 84), ("plane", "none", 188), ("point", "tukey", 212),
])
def test_collective_payload_under_1kb(estimator, robust, per_iter):
    """Bytes each rank contributes to collectives per f32 iteration: the
    JAX package's HLO payload (84 B point: 5 statistics + 4 Kabsch
    moments; 188 B plane: the 6×6 system), plus tukey's median bisection
    (a count and 31 int32 rounds, which the HLO holds once inside a
    loop)."""
    mesh = _mesh(8)
    n, m, iters = 1024, 512, 5
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    tgt_np = rng.normal(size=(m, 3)).astype(np.float32)
    tgt = torch.as_tensor(tgt_np)
    if estimator == "plane":
        nn_fn = _brute_plane_adapter
        state = torch.as_tensor(estimate_normals_cellpca(tgt_np, 8),
                                dtype=torch.float32)
    else:
        nn_fn, state = _brute_adapter, ()
    per = n // 8
    out = run_loop(
        mesh, [src[r * per:(r + 1) * per] for r in range(8)],
        [torch.ones(per) for _ in range(8)], [tgt] * 8, [state] * 8,
        nn_fns=nn_fn, carry=None, max_iterations=iters, widen_first=True,
        return_registered=False, tolerance=0.0, sigma_multiplier=3.0,
        estimator=estimator, robust=robust)
    ran = int(out["recorded"])
    assert out["stop"] == 4 and ran == iters
    for st in mesh.stats:
        assert st["bytes_sent"] == per_iter * iters
        assert st["bytes_sent"] / iters < 1024


def test_one_rank_mesh_bit_equal_icp_register():
    """A 1-rank mesh runs exactly the single-device operations: pallas
    backend, f32, directly and through the multiscale entry point."""
    src, tgt, _ = make_registration_pair(n=6000, seed=37, noise_sigma=0.02,
                                         kind="terrain")
    kw = dict(max_iterations=6, tolerance=0.0, nn_backend="pallas")
    one = icp_register(src, tgt, device="cpu", **kw)
    mesh = _mesh(1)
    got = icp_register_sharded(src, tgt, mesh=mesh, **kw)
    np.testing.assert_array_equal(got.transform, one.transform)
    np.testing.assert_array_equal(got.history_rmse, one.history_rmse)
    np.testing.assert_array_equal(got.source_registered,
                                  one.source_registered)
    mkw = dict(coarse_max_points=1500, coarse_iterations=8, **kw)
    ms1 = icp_register_multiscale(src, tgt, device="cpu", **mkw)
    msn = icp_register_multiscale(src, tgt, device="cpu", mesh=mesh, **mkw)
    assert msn.final.iterations == ms1.final.iterations
    np.testing.assert_array_equal(msn.transform, ms1.transform)
    np.testing.assert_array_equal(msn.final.history_transform,
                                  ms1.final.history_transform)
    np.testing.assert_array_equal(msn.final.source_registered,
                                  ms1.final.source_registered)


def test_multiscale_four_ranks_f32():
    """The multiscale fine level over 4 ranks in f32: the single-device
    iterations and stop code, 1e-4 m registration error."""
    src, tgt, _ = make_registration_pair(n=6000, seed=38, noise_sigma=0.02,
                                         kind="terrain")
    kw = dict(coarse_max_points=1500, coarse_iterations=8, max_iterations=8,
              tolerance=0.0, nn_backend="pallas", device="cpu")
    one = icp_register_multiscale(src, tgt, **kw)
    four = icp_register_multiscale(src, tgt, mesh=_mesh(4), **kw)
    assert four.final.iterations == one.final.iterations
    assert four.final.stop_reason == one.final.stop_reason
    assert _reg_err(four.transform, one.transform, src) < 1e-4


@pytest.mark.parametrize("extra, match", [
    (dict(prepared_nn=object()), "prepared_nn/device_data"),
    (dict(device_data=object()), "prepared_nn/device_data"),
    (dict(initial_transform=np.eye(4)), "initial_transform"),
])
def test_source_global_input_checks(extra, match):
    """The JAX package's checks on ``source_global`` (sharded.py:185-195),
    raised by both packages on the same call."""
    _, tgt, _ = make_registration_pair(n=200, seed=1)
    with pytest.raises(ValueError, match=match):
        icp_register_sharded(None, tgt, mesh=_mesh(2),
                             source_global=([None] * 2, [None] * 2, 0),
                             **extra)
    with pytest.raises(ValueError, match=match):
        jax_sharded(None, tgt, mesh=jax_mesh(2),
                    source_global=(None, None, 0), **extra)
