"""The port's f64 oracle (``utils/oracle.py``) against the JAX package's.

Both are the same numpy and scipy code, so every field of every result,
history entries included, must be equal bit for bit: on a converging
terrain pair and on a small pair that diverges (RMSE past 1.1× the
previous iteration's), in gui and cli mode, and ``best_fit_transform`` on
the same inputs. The port's copy imports no JAX (``test_torch_isolation``).
"""

import dataclasses

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.utils import oracle as jax_oracle
from iterativeclosestpoint_tpu.utils.synth import make_registration_pair
from iterativeclosestpoint_tpu_torch.utils import oracle as port_oracle


def _diverging_pair(seed=74):
    """A 22-point source against a 9-point target, rotated and shifted so
    far that the 3σ inlier set grows and the RMSE jumps past 1.1× the
    previous iteration's at iteration 5 (found by a search over seeds)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 25))
    tgt = rng.normal(size=(n, 3)) * rng.uniform(0.2, 5, size=3)
    m = int(rng.integers(6, 25))
    if rng.uniform() < 0.5:
        src = tgt[rng.integers(0, n, m)] + rng.normal(size=(m, 3)) * \
            rng.uniform(0, 2)
        a = rng.uniform(-1, 1) * np.pi
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]])
        src = src @ R.T + rng.normal(size=3) * rng.uniform(0, 5)
    else:
        src = rng.normal(size=(m, 3)) * rng.uniform(0.2, 5, size=3) + \
            rng.normal(size=3)
    return src, tgt


def _fixture(case):
    if case == "converging":
        src, tgt, _ = make_registration_pair(n=3000, seed=0,
                                             noise_sigma=0.02)
        return src, tgt
    return _diverging_pair()


def _assert_same(a, b, where):
    """Equal bit for bit: arrays by value and dtype, floats by identity of
    their bits (NaN-safe), everything else by ==."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=where)
    elif isinstance(a, float):
        assert isinstance(b, float), where
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), where
    else:
        assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize("mode", ["gui", "cli"])
@pytest.mark.parametrize("case, message", [("converging", "converged"),
                                           ("diverging", "diverged")])
def test_oracle_icp_bit_equal_to_jax_package(case, message, mode):
    src, tgt = _fixture(case)
    ours = port_oracle.oracle_icp(src, tgt, max_iterations=50, mode=mode)
    ref = jax_oracle.oracle_icp(src, tgt, max_iterations=50, mode=mode)
    assert ours.message == message
    assert ours.iterations >= 2
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        if f.name == "history":
            continue
        _assert_same(getattr(ours, f.name), getattr(ref, f.name), f.name)
    assert len(ours.history) == len(ref.history)
    for i, (h, r) in enumerate(zip(ours.history, ref.history)):
        assert type(h).__name__ == type(r).__name__ == "OracleIteration"
        for f in dataclasses.fields(r):
            _assert_same(getattr(h, f.name), getattr(r, f.name),
                         f"history[{i}].{f.name}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_fit_transform_bit_equal_to_jax_package(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(200, 3)) * 10.0
    b = a @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(size=3)
    if seed == 2:
        b[:, 0] *= -1  # a mirror: the reflection fix runs
    ours = port_oracle.best_fit_transform(a, b)
    _assert_same(ours, jax_oracle.best_fit_transform(a, b), "T")
    assert np.linalg.det(ours[:3, :3]) > 0
