"""Port parity: SE(3) apply, registration error and Kabsch against the JAX
package and the f64 NumPy oracle.

Everything runs on the CPU; tolerance 1e-12 in f64 (both sides are f64
closed forms of a few hundred terms, so only summation order differs) and
1e-6 in f32, times the value's scale where it exceeds 1 (a few ulp: the
two libraries' sin, cos, arccos and 3×3 SVD may round differently)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.ops import se3 as jse3
from iterativeclosestpoint_tpu.ops.kabsch import (
    kabsch as jax_kabsch,
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
from iterativeclosestpoint_tpu_torch.ops import se3 as tse3

# ``ops.kabsch`` is the exported function (as in the JAX package), so the
# module comes from the import system.
tk = importlib.import_module("iterativeclosestpoint_tpu_torch.ops.kabsch")

TOL = 1e-12
TOL_BY_DTYPE = {"float32": 1e-6, "float64": 1e-12}


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


_EULER = [(7.5, -3.25, 2.0, 1.5, -2.25, 0.75), (-170.0, 45.0, -60.0, 0.0, 0.0,
                                               0.0)]


def _se3_case(fn, dtype, k):
    """(port value, JAX value) of the ``se3`` function ``fn`` on case k."""
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    Ta, Tb = (random_rigid_transform(seed=k + s, max_yaw_deg=60.0)
              for s in (20, 21))
    if fn == "identity_transform":
        return tse3.identity_transform(td), jse3.identity_transform(jd)
    if fn == "se3_from_euler":
        return (tse3.se3_from_euler(*_EULER[k], dtype=td),
                jse3.se3_from_euler(*_EULER[k], dtype=jd))
    if fn == "transform_error":
        return (tse3.transform_error(torch.as_tensor(Ta, dtype=td),
                                     torch.as_tensor(Tb, dtype=td)),
                jse3.transform_error(jnp.asarray(Ta, jd), jnp.asarray(Tb, jd)))
    return (getattr(tse3, fn)(torch.as_tensor(Ta, dtype=td)),
            getattr(jse3, fn)(jnp.asarray(Ta, jd)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("fn", ["identity_transform", "rotation_angle_deg",
                                "translation_norm", "se3_from_euler",
                                "transform_error"])
def test_se3_functions_match_jax(fn, k, dtype):
    ours, ref = _se3_case(fn, dtype, k)
    ref = np.asarray(ref)
    assert ours.dtype == getattr(torch, dtype)
    assert tuple(ours.shape) == ref.shape
    # Relative to the value's scale: an angle of 26.67° in f32 has an ulp
    # of 1.9e-6, and the two libraries' arccos may round it apart.
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=TOL_BY_DTYPE[dtype] * scale)


def test_exports_are_the_jax_functions_counterparts():
    """``ops``'s exports: identity is the identity, the Euler angles of a
    transform come back through the angle and the norm."""
    from iterativeclosestpoint_tpu_torch import ops

    T = ops.se3_from_euler(0.0, 0.0, 30.0, 3.0, 4.0, 0.0,
                           dtype=torch.float64)
    assert float(ops.rotation_angle_deg(T)) == pytest.approx(30.0, abs=1e-12)
    assert float(ops.translation_norm(T)) == pytest.approx(5.0, abs=1e-12)
    assert torch.equal(ops.compose(T, ops.identity_transform(torch.float64)),
                       T)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["rigid", "generic"])
def test_kabsch_matches_jax(case, dtype):
    """The unmasked fit in the input dtype (the JAX default accumulation
    dtype), on unit-scale clouds so 1e-6 is a few f32 ulp."""
    rng = np.random.default_rng(31)
    src = rng.normal(size=(300, 3))
    dst = (apply_transform_np(random_rigid_transform(seed=32), src)
           + rng.normal(0, 0.01, size=src.shape)) if case == "rigid" \
        else rng.normal(size=(300, 3))
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    ours = tk.kabsch(torch.as_tensor(src, dtype=td),
                     torch.as_tensor(dst, dtype=td))
    ref = np.asarray(jax_kabsch(jnp.asarray(src, jd), jnp.asarray(dst, jd)))
    assert ours.dtype == td
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=TOL_BY_DTYPE[dtype])
    if dtype == "float64":
        np.testing.assert_allclose(ours.numpy(), best_fit_transform(src, dst),
                                   rtol=0, atol=1e-9)
