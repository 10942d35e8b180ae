"""Port parity: ``nn_backend="pallas"`` at f64 through the brute tiers.

The sweep casts its queries to f32 and returns the query's dtype; the
queries it cannot certify go to the repair chain's brute stages, which
the JAX package runs with its dtype-generic ``nn_bruteforce`` at both
dtypes. The port's stages call ``nn_exact``: K3 at f32, the plain
``nn_bruteforce`` at f64. On the 4,000-point pair below (seed 5, noise
0.02) the brute tier fires in most iterations (9 brute calls in 10
point iterations, 17 in 10 plane iterations on the CPU).

Tolerances: point mode 1e-12 on every recorded transform (the matched
rows are the same target rows, only summation order differs); plane mode
1e-8 on the final transform, since the port's device normals are exact
fixed-point sums and the JAX package's are not (ROADMAP §3: its early
iterations differ by ~1e-6 and converge onto the same pose). Both with
the same iterations and stop code. About 40 s alone on one worker.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.models.icp import icp_register as jax_icp
from iterativeclosestpoint_tpu.utils.synth import make_registration_pair
from iterativeclosestpoint_tpu_torch import icp_register
from iterativeclosestpoint_tpu_torch.ops import sweep_nn


@pytest.mark.parametrize("estimator,atol", [("point", 1e-12),
                                            ("plane", 1e-8)])
def test_f64_pallas_brute_tier_matches_jax(monkeypatch, estimator, atol):
    src, tgt, _ = make_registration_pair(n=4000, seed=5, noise_sigma=0.02)
    calls = []
    exact = sweep_nn.nn_exact

    def counted(query, target):
        idx, dist = exact(query, target)
        calls.append((query.dtype, dist.dtype))
        return idx, dist

    monkeypatch.setattr(sweep_nn, "nn_exact", counted)
    kw = dict(nn_backend="pallas", estimator=estimator, max_iterations=10)
    ref = jax_icp(src, tgt, dtype=jnp.float64, **kw)
    res = icp_register(src, tgt, dtype=torch.float64, device="cpu", **kw)
    assert calls  # the brute tier fired
    assert set(calls) == {(torch.float64, torch.float64)}
    assert (res.iterations, res.stop_reason, res.message) == (
        ref.iterations, ref.stop_reason, ref.message)
    np.testing.assert_array_equal(res.history_valid, ref.history_valid)
    np.testing.assert_allclose(res.transform, ref.transform, atol=atol)
    if estimator == "point":
        np.testing.assert_allclose(res.history_transform,
                                   ref.history_transform, atol=atol)


def test_f64_pallas_multiscale_runs_the_brute_tier(monkeypatch):
    """Through ``icp_register_multiscale`` (one f64 level at this size,
    its grids built on the host path): the same iterations and stop code
    as the JAX package's, within the point tolerance."""
    from iterativeclosestpoint_tpu.models.multiscale import (
        icp_register_multiscale as jax_multiscale,
    )
    from iterativeclosestpoint_tpu_torch import icp_register_multiscale

    src, tgt, _ = make_registration_pair(n=4000, seed=5, noise_sigma=0.02)
    calls = []
    exact = sweep_nn.nn_exact
    monkeypatch.setattr(sweep_nn, "nn_exact",
                        lambda q, t: calls.append(q.dtype) or exact(q, t))
    kw = dict(nn_backend="pallas", max_iterations=10)
    ref = jax_multiscale(src, tgt, dtype=jnp.float64, **kw).final
    res = icp_register_multiscale(src, tgt, dtype=torch.float64,
                                  device="cpu", **kw).final
    assert calls and set(calls) == {torch.float64}
    assert (res.iterations, res.stop_reason) == (ref.iterations,
                                                 ref.stop_reason)
    np.testing.assert_allclose(res.transform, ref.transform, atol=1e-12)


def test_f64_pallas_partitioned_matches_jax():
    """The partitioned target's pallas local search at f64 (2 ranks): its
    repair chain runs the same brute stages, and the JAX package runs
    this configuration, so the port no longer refuses it."""
    from iterativeclosestpoint_tpu.parallel import partition as jpart
    from iterativeclosestpoint_tpu.parallel.mesh import make_mesh as jmesh
    from iterativeclosestpoint_tpu_torch.parallel import make_mesh
    from iterativeclosestpoint_tpu_torch.parallel import partition as tpart

    src, tgt, _ = make_registration_pair(n=2000, seed=132, noise_sigma=0.01,
                                         kind="terrain")
    kw = dict(max_iterations=8, tolerance=1e-9, local_search="pallas",
              grid_resolution=16)
    ref = jpart.icp_register_partitioned(
        src, tgt, mesh=jmesh(n_devices=2), dtype=jnp.float64, **kw)
    res = tpart.icp_register_partitioned(
        src, tgt, mesh=make_mesh(devices=["cpu"] * 2), dtype=torch.float64,
        **kw)
    assert (res.iterations, res.stop_reason) == (ref.iterations,
                                                 ref.stop_reason)
    assert res.nn_resolution == 16
    np.testing.assert_allclose(res.transform, ref.transform, atol=1e-12)
