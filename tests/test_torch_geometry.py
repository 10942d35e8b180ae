"""Port parity: SE(3) apply, registration error and Kabsch against the JAX
package and the f64 NumPy oracle.

Everything runs in f64 on the CPU; tolerance 1e-12 (both sides are f64
closed forms of a few hundred terms, so only summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.ops.kabsch import (
    kabsch_masked as jax_kabsch_masked,
    rigid_from_covariance as jax_rigid_from_covariance,
)
from iterativeclosestpoint_tpu.ops.se3 import (
    apply_transform as jax_apply_transform,
    registration_error as jax_registration_error,
)
from iterativeclosestpoint_tpu.utils.oracle import best_fit_transform
from iterativeclosestpoint_tpu.utils.synth import (
    apply_transform_np,
    make_cloud,
    random_rigid_transform,
)
from iterativeclosestpoint_tpu_torch.ops import kabsch as tk
from iterativeclosestpoint_tpu_torch.ops import se3 as tse3

TOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_transform_matches_jax(seed):
    pts = make_cloud(500, seed=seed)
    T = random_rigid_transform(seed=seed)
    ours = tse3.apply_transform(_t(T), _t(pts)).numpy()
    ref = np.asarray(jax_apply_transform(jnp.asarray(T), jnp.asarray(pts)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(ours, apply_transform_np(T, pts), rtol=0,
                               atol=TOL)


def test_registration_error_matches_jax():
    pts = make_cloud(400, seed=3) + np.array([5e5, 4e6, 1200.0])
    Ta, Tb = random_rigid_transform(seed=4), random_rigid_transform(seed=5)
    ours = float(tse3.registration_error(_t(Ta), _t(Tb), _t(pts)))
    ref = float(jax_registration_error(jnp.asarray(Ta), jnp.asarray(Tb),
                                        jnp.asarray(pts)))
    # UTM-scale lever arms (~4e6 m): relative f64 tolerance.
    assert abs(ours - ref) <= TOL * max(abs(ref), 1.0) * 1e3


def _pair(case, seed):
    rng = np.random.default_rng(seed)
    if case == "reflection":
        # Planar degenerate cloud mapped through a mirror: the fit must
        # flip V's third column and stay a proper rotation.
        src = rng.normal(size=(100, 3))
        src[:, 2] = 0.0
        dst = src.copy()
        dst[:, 0] *= -1
    elif case == "generic":
        src = rng.normal(size=(200, 3))
        dst = rng.normal(size=(200, 3))  # unrelated clouds: generic H
    else:
        src = make_cloud(400, seed=seed)
        dst = (apply_transform_np(random_rigid_transform(seed=seed + 1), src)
               + rng.normal(0, 0.01, size=src.shape))
    return src, dst


@pytest.mark.parametrize("case", ["rigid", "generic", "reflection"])
def test_rigid_from_covariance_matches_jax_and_oracle(case):
    src, dst = _pair(case, 7)
    c_s, c_d = src.mean(0), dst.mean(0)
    H = (src - c_s).T @ (dst - c_d)
    ours = tk.rigid_from_covariance(_t(H), _t(c_s), _t(c_d)).numpy()
    ref = np.asarray(jax_rigid_from_covariance(
        jnp.asarray(H), jnp.asarray(c_s), jnp.asarray(c_d)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    if case != "reflection":
        # The oracle's GUI-form fix agrees wherever the singular values
        # are distinct (the reflection case has a zero one: any sign of
        # that column is a valid SVD, so only properness is pinned).
        np.testing.assert_allclose(ours, best_fit_transform(src, dst),
                                   rtol=0, atol=1e-9)
    assert np.linalg.det(ours[:3, :3]) > 0


@pytest.mark.parametrize("case", ["rigid", "generic", "reflection"])
def test_kabsch_masked_matches_jax_and_oracle(case):
    src, dst = _pair(case, 11)
    mask = np.random.default_rng(12).uniform(size=len(src)) > 0.3
    ours = tk.kabsch_masked(_t(src), _t(dst), _t(mask.astype(np.float64)))
    ours = ours.numpy()
    ref = np.asarray(jax_kabsch_masked(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask, jnp.float64),
        accum_dtype=jnp.float64))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    if case != "reflection":
        np.testing.assert_allclose(
            ours, best_fit_transform(src[mask], dst[mask]), rtol=0,
            atol=1e-9)
    assert np.linalg.det(ours[:3, :3]) > 0
