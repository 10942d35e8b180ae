"""Port parity: brute-force NN (the plain version of the K3 kernel) against
the JAX package's ``nn_bruteforce``.

Indices must be identical, ties included, which pins the first-minimum
order. Distances may differ by 1 ulp in f32: XLA's CPU backend fuses the
jitted ``sum(diff * diff)`` into a chain of FMAs, while the port rounds
every operation on its own (as the TPU and the CUDA kernels do). In f64
the tolerance is 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from _k3_planted import planted
from scipy.spatial import cKDTree

from iterativeclosestpoint_tpu.ops.bruteforce import (
    nn_bruteforce as jax_nn_bruteforce,
)
from iterativeclosestpoint_tpu.ops.pallas_nn import make_pallas_brute
from iterativeclosestpoint_tpu.utils.synth import make_cloud
from iterativeclosestpoint_tpu_torch.ops.bruteforce import nn_bruteforce
from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import (
    brute_splits,
    nn_brute,
)

H100_SMS = 132  # the split layout K3 takes on an H100


def _clouds(case):
    rng = np.random.default_rng(21)
    if case == "duplicates":
        # Repeated target rows force exact d² ties; the first row wins.
        t = np.repeat(make_cloud(300, seed=5), 3, axis=0)
        q = t[::7] + rng.normal(0, 0.05, t[::7].shape)
    elif case == "lattice":
        # Queries exactly between lattice points tie at equal distances.
        g = np.arange(8.0)
        t = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        q = t[:200] + 0.5
    else:
        t = make_cloud(3000, seed=6)
        q = t[:1500] + rng.normal(0, 0.05, (1500, 3))
    return q, t


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["random", "duplicates", "lattice"])
def test_nn_bruteforce_matches_jax(case, dtype):
    q, t = _clouds(case)
    jd = getattr(jnp, dtype)
    ji, jdist = jax_nn_bruteforce(jnp.asarray(q, jd), jnp.asarray(t, jd),
                                  query_chunk=512, target_tile=1024)
    td = getattr(torch, dtype)
    ti, tdist = nn_bruteforce(torch.as_tensor(q, dtype=td),
                              torch.as_tensor(t, dtype=td),
                              query_chunk=256, target_tile=700)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if dtype == "float32":
        np.testing.assert_array_max_ulp(tdist.numpy(), np.asarray(jdist),
                                        maxulp=1)
    else:
        np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), rtol=0,
                                   atol=1e-12)


def test_k3_wrapper_on_cpu_is_plain_version():
    """On CPU tensors the K3 wrapper returns its plain version's answer,
    which is exact against a k-d tree."""
    q, t = _clouds("random")
    qt = torch.as_tensor(q, dtype=torch.float32)
    tt = torch.as_tensor(t, dtype=torch.float32)
    i1, d1 = nn_brute(qt, tt)
    i2, d2 = nn_bruteforce(qt, tt)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    d_ref, _ = cKDTree(t.astype(np.float32)).query(q.astype(np.float32))
    np.testing.assert_allclose(d1.numpy(), d_ref, rtol=0, atol=1e-5)


def test_k3_plain_matches_pallas_brute():
    """K3's plain version (the K3 wrapper on CPU tensors) against the TPU
    kernel it replaces, ``make_pallas_brute`` (the one-cell
    ``_colsweep_kernel(first_tie=True)``) run in interpret mode, on exact
    d² ties planted across the H100 split layout's seams: the same winner
    coordinates, the lower row winning every tie, and distances within
    1 ulp (XLA:CPU contracts the reference's d² into FMAs)."""
    n, m = 900, 2000
    q, tgt, rows = planted(n, m, brute_splits(n, m, H100_SMS), seed=31)
    fn, grid = make_pallas_brute(tgt)
    m_k, d_k = fn(jnp.asarray(q), None, grid)
    idx, dist = nn_brute(torch.as_tensor(q), torch.as_tensor(tgt))
    assert len(rows) >= 8
    np.testing.assert_array_equal(idx[:len(rows)].numpy(), rows)
    np.testing.assert_array_equal(tgt[idx.numpy()], np.asarray(m_k))
    np.testing.assert_array_max_ulp(dist.numpy(), np.asarray(d_k), maxulp=1)


@pytest.mark.parametrize("n, m, want", [
    (29_412, 29_412, 4), (512, 1_000_000, 99), (4096, 1_000_000, 33),
    (512, 200_000, 99), (900, 2000, 1), (300, 5, 1),
])
def test_brute_splits_rule(n, m, want):
    """K3's split count on an H100's 132 SMs at the main paths' shapes (the
    picks its device-time sweep over split counts confirms) and at small
    targets: each split at least one staged pass of 1024 rows, or one."""
    s = brute_splits(n, m, H100_SMS)
    assert s == want
    assert s == 1 or m // s >= 1024
