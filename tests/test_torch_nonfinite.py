"""Port parity: non-finite input stops the run, as in the JAX package.

A NaN (or inf) coordinate poisons the statistics and the covariance. The
JAX package stops with ``NUMERICAL_ERROR`` (6) before it records anything
and returns ``success=False`` (``tests/test_icp_pairwise.py``'s
``test_nonfinite_input_stops_with_numerical_error``); its SVD of a
non-finite H returns NaN where ``torch.linalg.svd`` would raise, and the
port's ``rigid_from_covariance`` returns NaN there too. Every case runs
the JAX function and the port's on the same numpy input, and the outcome
must be the same: stop code, iterations, ``success`` and message, or the
same exception where the JAX package itself raises (a NaN *target* row
breaks the grid estimators of the pallas and cellblock backends with an
``IndexError`` in both packages).

About 60 s alone on one worker (the JAX side's compiles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_register_scans import _overlapping_strip_scans

from iterativeclosestpoint_tpu.models import posegraph as jpg
from iterativeclosestpoint_tpu.models.icp import NUMERICAL_ERROR
from iterativeclosestpoint_tpu.models.icp import icp_register as jax_icp
from iterativeclosestpoint_tpu.models.multiscale import (
    icp_register_multiscale as jax_multiscale,
)
from iterativeclosestpoint_tpu.ops.kabsch import kabsch as jax_kabsch
from iterativeclosestpoint_tpu.parallel.mesh import make_mesh as jax_mesh
from iterativeclosestpoint_tpu.parallel.sharded import (
    icp_register_sharded as jax_sharded,
)
from iterativeclosestpoint_tpu.utils.synth import make_registration_pair
from iterativeclosestpoint_tpu_torch import (
    icp_register,
    icp_register_multiscale,
)
from iterativeclosestpoint_tpu_torch.models import posegraph as tpg
from iterativeclosestpoint_tpu_torch.ops.kabsch import kabsch
from iterativeclosestpoint_tpu_torch.parallel import (
    icp_register_sharded,
    make_mesh,
)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64)}
STOPPED = (NUMERICAL_ERROR, 0, False)


def _poisoned(row=13, col=1, value=np.nan, where="source"):
    """The JAX test's pair (n=1000, seed 8) with one non-finite
    coordinate in the source or the target."""
    src, tgt, _ = make_registration_pair(n=1000, seed=8)
    src, tgt = src.copy(), tgt.copy()
    (src if where == "source" else tgt)[row, col] = value
    return src, tgt


def _outcome(fn, *args, **kw):
    """(stop code, iterations, success, message) of a run, or the type of
    the exception it raised."""
    try:
        r = fn(*args, **kw)
    except Exception as e:  # the JAX package's own raise is the reference
        return type(e)
    r = getattr(r, "final", r)
    return r.stop_reason, r.iterations, r.success, r.message


@pytest.mark.parametrize("robust", ["none", "huber"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("backend",
                         ["bruteforce", "pallas", "cellblock", "hashgrid"])
def test_nan_source_stops_with_numerical_error(backend, dtype, robust):
    src, tgt = _poisoned()
    jd, td = DTYPES[dtype]
    kw = dict(nn_backend=backend, robust=robust, max_iterations=10)
    ref = _outcome(jax_icp, src, tgt, dtype=jd, **kw)
    out = _outcome(icp_register, src, tgt, dtype=td, device="cpu", **kw)
    assert out == ref
    assert out[:3] == STOPPED
    assert "numerical error" in out[3]


@pytest.mark.parametrize("backend,raises", [
    ("bruteforce", None), ("pallas", IndexError), ("cellblock", IndexError),
    ("hashgrid", None)])
def test_nan_target_row_matches_jax(backend, raises):
    """Stop code 6 where the JAX package stops; the same IndexError where
    it raises (its grid estimators index by the NaN row's cell)."""
    src, tgt = _poisoned(where="target")
    kw = dict(nn_backend=backend, max_iterations=10)
    ref = _outcome(jax_icp, src, tgt, dtype=jnp.float32, **kw)
    out = _outcome(icp_register, src, tgt, dtype=torch.float32,
                   device="cpu", **kw)
    assert out == ref
    if raises:
        assert out is raises
    else:
        assert out[:3] == STOPPED


@pytest.mark.parametrize("value", [np.inf, -np.inf])
def test_inf_source_stops_with_numerical_error(value):
    src, tgt = _poisoned(value=value)
    kw = dict(nn_backend="pallas", max_iterations=10)
    ref = _outcome(jax_icp, src, tgt, dtype=jnp.float64, **kw)
    out = _outcome(icp_register, src, tgt, dtype=torch.float64,
                   device="cpu", **kw)
    assert out == ref and out[:3] == STOPPED


def test_multiscale_stops_with_numerical_error():
    src, tgt = _poisoned()
    kw = dict(nn_backend="pallas", max_iterations=10)
    ref = _outcome(jax_multiscale, src, tgt, dtype=jnp.float32, **kw)
    out = _outcome(icp_register_multiscale, src, tgt, dtype=torch.float32,
                   device="cpu", **kw)
    assert out == ref and out[:3] == STOPPED


@pytest.mark.parametrize("value", [np.nan, np.inf])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_public_kabsch_returns_nan_transform(dtype, value):
    """A NaN rotation and translation above the homogeneous row
    [0, 0, 0, 1], where the JAX package's ``kabsch`` has them."""
    src, tgt = _poisoned(value=value)
    jd, td = DTYPES[dtype]
    ref = np.asarray(jax_kabsch(jnp.asarray(src, jd), jnp.asarray(tgt, jd)))
    out = kabsch(torch.as_tensor(src, dtype=td),
                 torch.as_tensor(tgt, dtype=td))
    assert out.dtype == td
    out = out.numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert np.isnan(out[:3]).all()
    np.testing.assert_array_equal(out[3], [0, 0, 0, 1])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_dp_mesh_stops_with_numerical_error(dtype):
    """Two ranks: the NaN row lies on rank 0, and the rank-summed
    covariance stops both ranks at once."""
    src, tgt = _poisoned()
    jd, td = DTYPES[dtype]
    ref = _outcome(jax_sharded, src, tgt, mesh=jax_mesh(n_devices=2),
                   dtype=jd, max_iterations=10)
    out = _outcome(icp_register_sharded, src, tgt,
                   mesh=make_mesh(devices=["cpu"] * 2), dtype=td,
                   max_iterations=10)
    assert out == ref and out[:3] == STOPPED


@pytest.mark.parametrize("scan,crop,stopped", [
    (0, True, [0]),       # the target of edge (0, 1)
    (1, False, [0, 1]),   # the source of (0, 1) and the target of (1, 2)
])
def test_register_scans_edge_stops_with_numerical_error(scan, crop,
                                                        stopped):
    """A NaN in one strip stops each edge that reads it with code 6 (edge
    (i, j) registers scan j onto scan i), and the scans those edges would
    join surface as disconnected, as in the JAX package. A cropped source
    loses its NaN row (it fails the bbox test), so the source case runs
    uncropped."""
    scans = [s.copy() for s in _overlapping_strip_scans(k=3, n=900)]
    scans[scan][np.argsort(scans[scan][:, 0])[len(scans[scan]) // 2],
                2] = np.nan
    kw = dict(max_iterations=10, tolerance=0.0, crop_to_overlap=crop)
    ref = jpg.register_scans(scans, **kw)
    out = tpg.register_scans(scans, device="cpu", **kw)
    got = [(e.stop_reason, e.iterations, e.success, e.message)
           for e in out.edge_results]
    assert got == [(e.stop_reason, e.iterations, e.success, e.message)
                   for e in ref.edge_results]
    assert [k for k, g in enumerate(got) if g[:3] == STOPPED] == stopped
    assert out.disconnected == ref.disconnected != []
