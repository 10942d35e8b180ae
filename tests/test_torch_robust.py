"""Port parity: robust (M-estimator) weights against the JAX package, on
the CPU.

The scale of the weights is the exact masked median, found by bisection
on the float bit pattern; it must equal the JAX package's bit for bit
(the same integer arithmetic) and the sorted order statistic. Whole f64
trajectories on a contaminated pair stay within 1e-9 m of the JAX
package's (the oracle gate; only summation order differs), with equal
iteration counts and stop codes, and ``robust="none"`` is bit-identical to
leaving it out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.models import icp as jicp
from iterativeclosestpoint_tpu.utils.synth import (
    apply_transform_np,
    make_cloud,
    random_rigid_transform,
)
from iterativeclosestpoint_tpu_torch import icp_register
from iterativeclosestpoint_tpu_torch.models import icp as ticp

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64,
                                                      torch.float64)}


def _values(case, np_dtype):
    rng = np.random.default_rng(9)
    n = 4099
    if case == "ties":  # few distinct values, many repeats, zeros
        vals = rng.integers(0, 7, n).astype(np_dtype) * np_dtype(0.25)
    else:
        vals = rng.exponential(0.3, n).astype(np_dtype)
    valid = rng.random(n) < (0.0 if case == "empty" else 0.7)
    return vals, valid


@pytest.mark.parametrize("case", ["spread", "ties", "empty"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_masked_kth_and_median_match_jax_bitwise(case, dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    vals, valid = _values(case, np_dtype)
    jv, jm = jnp.asarray(vals), jnp.asarray(valid)
    tv, tm = torch.as_tensor(vals, dtype=t_dtype), torch.as_tensor(valid)
    ident = lambda x: x  # noqa: E731
    cnt = int(valid.sum())
    ks = [0, cnt // 3, max(cnt - 1, 0)]
    for k in ks:
        got = ticp._global_masked_kth(tv, tm, torch.tensor(k)).numpy()
        ref = np.asarray(jicp._global_masked_kth(jv, jm, jnp.asarray(k),
                                                 ident))
        assert got.dtype == ref.dtype == np_dtype
        assert got.tobytes() == ref.tobytes(), (k, got, ref)
        if cnt:
            assert got == np.sort(vals[valid])[k]
    w = np.where(valid, 1.0, 0.0).astype(np_dtype)
    med = ticp._global_masked_median(tv, torch.as_tensor(w)).numpy()
    ref = np.asarray(jicp._global_masked_median(jv, jnp.asarray(w), ident))
    assert med.tobytes() == ref.tobytes()
    if cnt:
        assert med == np.sort(vals[valid])[(cnt - 1) // 2]
    else:
        assert not med > 0  # the weights fall back to the plain mask


def _contaminated_pair(n=6000, frac=0.2, shift=0.25, seed=3):
    """The JAX package's robust fixture: ``frac`` of the source biased by
    +shift in x, inside the 3σ gate."""
    rng = np.random.default_rng(seed)
    tgt = make_cloud(n, seed=7)
    T = random_rigid_transform(seed=5, max_yaw_deg=3.0,
                               max_pitch_roll_deg=1.5, max_txy=0.5,
                               max_tz=0.3)
    src = apply_transform_np(np.linalg.inv(T), tgt)
    src += rng.normal(0, 0.01, src.shape)
    k = int(n * frac)
    src[rng.choice(n, k, replace=False), 0] += shift
    return src, tgt, T


def _reg_err(Ta, Tb, pts):
    pa = pts @ Ta[:3, :3].T + Ta[:3, 3]
    pb = pts @ Tb[:3, :3].T + Tb[:3, 3]
    return float(np.linalg.norm(pa - pb, axis=1).max())


@pytest.mark.parametrize("robust,factor", [("huber", 0.3), ("tukey", 0.05)])
def test_f64_robust_trajectory_matches_jax(robust, factor):
    src, tgt, T_true = _contaminated_pair()
    kw = dict(nn_backend="bruteforce", max_iterations=60, tolerance=1e-9,
              return_registered=False)
    ref = jicp.icp_register(src, tgt, dtype=jnp.float64, robust=robust,
                            **kw)
    res = icp_register(src, tgt, dtype=torch.float64, robust=robust,
                       device="cpu", **kw)
    assert (res.iterations, res.stop_reason) == (ref.iterations,
                                                 ref.stop_reason)
    np.testing.assert_array_equal(res.history_valid, ref.history_valid)
    assert _reg_err(res.transform, ref.transform, src) <= 1e-9
    # And the weights do their job: the biased 20% pulls plain Kabsch.
    plain = icp_register(src, tgt, dtype=torch.float64, device="cpu", **kw)
    assert (_reg_err(res.transform, T_true, src)
            < factor * _reg_err(plain.transform, T_true, src))


def test_robust_none_is_bit_identical_to_omitting_it():
    src, tgt, _ = _contaminated_pair(n=2000)
    kw = dict(nn_backend="bruteforce", max_iterations=10, tolerance=1e-9,
              return_registered=False, device="cpu")
    a = icp_register(src, tgt, **kw)
    b = icp_register(src, tgt, robust="none", **kw)
    np.testing.assert_array_equal(a.transform, b.transform)
    np.testing.assert_array_equal(a.history_rmse, b.history_rmse)


def test_robust_validation():
    src = make_cloud(100, seed=1)
    with pytest.raises(ValueError, match="robust"):
        icp_register(src, src, robust="cauchy", device="cpu")
