"""Port parity: host I/O (LAS, the native library, downsampling) against
the JAX package on the same inputs. Mirrors ``test_las_io.py``,
``test_downsample.py`` and ``test_native.py``.

Everything here is host code, so the bar is equality: the port's LAS
bytes are the JAX package's bytes, and every decoder, downsampler and
native baseline returns identical arrays. The native baselines skip where
no toolchain builds the port's ``native/libicpnative_torch.so``, as
``test_native.py`` does for the JAX package's ``libicpnative.so``.

The tests that call both packages' native entry points take the
``both_native_loaded`` fixture. Under ``pytest -n`` every worker collects
every module, and ``test_native.py`` makes the JAX package's loader build
its library at collection, in place and without a lock, in each worker at
once; a loader that lost that race keeps its failure for the whole
process. No test starts before every worker has collected, so by then the
file is whole, and the fixture has the JAX loader try it once more.
"""

import dataclasses
import importlib

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.io import las as jlas
from iterativeclosestpoint_tpu.ops import downsample as jds
from iterativeclosestpoint_tpu.runtime import native as jnative
from iterativeclosestpoint_tpu.utils.synth import (
    make_cloud,
    make_registration_pair,
)
from iterativeclosestpoint_tpu_torch.io import las as tlas
from iterativeclosestpoint_tpu_torch.ops import downsample as tds
from iterativeclosestpoint_tpu_torch.runtime import native as tnative

UTM = np.array([500_000.0, 4_000_000.0, 1_200.0])
needs_native = pytest.mark.skipif(
    not tnative.native_available(), reason="native toolchain unavailable")


@pytest.fixture(scope="module")
def both_native_loaded():
    """The port's library loaded, then the JAX package's: reloaded once if
    its loader kept a failure from the build race at collection. A library
    that still does not load fails the test."""
    if not tnative.native_available():
        pytest.fail("the port's native library does not load: "
                    + tnative.native_failure())
    if jnative._load_failed:
        importlib.reload(jnative)
    assert jnative.native_available(), (
        "the JAX package's native library does not load")


def _same_header(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("case", ["default", "georef", "rebase", "golden"])
def test_write_las_bytes_identical(tmp_path, case):
    pts = make_cloud(3000, seed=5) + (UTM if case != "default" else 0.0)
    kw = {"default": {}, "georef": dict(scale=(0.001, 0.001, 0.001),
                                        offset=tuple(UTM)),
          "rebase": dict(rebase=True),
          "golden": dict(scale=(0.01, 0.01, 0.01), offset=(1.0, -3.0, 3.0))
          }[case]
    if case == "golden":
        pts = np.array([[1.25, -2.5, 3.75], [4.0, 5.0, 6.0]])
    ha = tlas.write_las(tmp_path / "t.las", pts, **kw)
    hb = jlas.write_las(tmp_path / "j.las", pts, **kw)
    assert (tmp_path / "t.las").read_bytes() == (tmp_path / "j.las").read_bytes()
    assert _same_header(ha, hb)
    assert _same_header(tlas.read_header(tmp_path / "j.las"),
                        jlas.read_header(tmp_path / "t.las"))


def _las_file(tmp_path, n=2500, record_length=20):
    """A LAS file written by the JAX package; ``record_length`` 28 pads
    each record as point format 1 does."""
    pts = make_cloud(n, seed=4) + UTM
    p = tmp_path / "in.las"
    jlas.write_las(p, pts, scale=(0.001, 0.001, 0.001), offset=tuple(UTM))
    if record_length != 20:
        raw = bytearray(p.read_bytes())
        pad = b"\x00" * (record_length - 20)
        recs = [raw[227 + i * 20: 227 + (i + 1) * 20] + pad for i in range(n)]
        raw[105:107] = record_length.to_bytes(2, "little")
        p.write_bytes(bytes(raw[:227]) + b"".join(recs))
    return p


@pytest.mark.parametrize("record_length", [20, 28])
@pytest.mark.parametrize("read", [
    dict(), dict(max_points=700), dict(stride=50), dict(stride=7,
                                                        max_points=900)])
def test_read_las_equal(tmp_path, record_length, read):
    p = _las_file(tmp_path, record_length=record_length)
    a, ha = tlas.read_las(p, engine="numpy", **read)
    b, hb = jlas.read_las(p, engine="numpy", **read)
    assert _same_header(ha, hb)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("span", [(0, 2500, 1), (300, 1900, 1),
                                  (123, 2400, 7), (2000, 9999, 3)])
def test_read_las_range_equal(tmp_path, span):
    p = _las_file(tmp_path)
    a, _ = tlas.read_las_range(p, *span)
    b, _ = jlas.read_las_range(p, *span)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch,stride", [(700, 1), (1000, 3), (5000, 1)])
def test_read_las_batches_equal(tmp_path, batch, stride):
    p = _las_file(tmp_path)
    a = list(tlas.read_las_batches(p, batch_size=batch, stride=stride))
    b = list(jlas.read_las_batches(p, batch_size=batch, stride=stride))
    assert [len(x) for x in a] == [len(x) for x in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_signature_validation(tmp_path):
    p = tmp_path / "bad.las"
    p.write_bytes(b"NOPE" + b"\x00" * 300)
    with pytest.raises(ValueError, match="LASF"):
        tlas.read_header(p)


@needs_native
def test_native_decoder_equal(tmp_path, both_native_loaded):
    """The native decoder gives the same array through both packages (one
    library), and agrees with the numpy decoder up to the FMA rounding
    ``test_las_io.py`` allows."""
    p = _las_file(tmp_path, n=3000)
    a, _ = tlas.read_las(p, engine="native")
    b, _ = jlas.read_las(p, engine="native")
    np.testing.assert_array_equal(a, b)
    c, _ = tlas.read_las(p, engine="numpy")
    np.testing.assert_allclose(a, c, atol=1e-9)


@pytest.mark.parametrize("fn,arg", [
    ("downsample_stride", 300), ("downsample_stride", 20_000),
    ("downsample_voxel", 5.0), ("downsample_voxel", 2.0),
    ("downsample_voxel_stride", 4.0), ("downsample_voxel_stride", 1.5),
])
def test_downsample_equal(fn, arg):
    pts = make_cloud(10_000, seed=2)
    np.testing.assert_array_equal(getattr(tds, fn)(pts, arg),
                                  getattr(jds, fn)(pts, arg))


@needs_native
def test_native_octree_nn_equal(both_native_loaded):
    tgt = make_cloud(4000, seed=40)
    q = make_cloud(1000, seed=41)
    np.testing.assert_array_equal(tnative.octree_nn_baseline(tgt, q),
                                  jnative.octree_nn_baseline(tgt, q))


@needs_native
@pytest.mark.parametrize("mode", ["gui", "cli"])
def test_native_octree_icp_equal(mode, both_native_loaded):
    src, tgt, _ = make_registration_pair(n=1500, seed=42, noise_sigma=0.02)
    a = tnative.octree_icp_baseline(src, tgt, max_iterations=25, mode=mode,
                                    return_registered=True)
    b = jnative.octree_icp_baseline(src, tgt, max_iterations=25, mode=mode,
                                    return_registered=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
