"""The port's LAS reader and writer (``io/las.py``) against the plain
LAS 1.2 reader and writer of the benchmark (``portbench/reference/
las_ref.py``, numpy from the ASPRS layout alone), and the spans and
counters they record under ``timing.collect()``.

The registered cloud's span (``<level>/registered``) is entered only
where a call asks for the registered cloud, so the library's calls
without it keep the spans they had.
"""

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu_torch import icp_register_multiscale
from iterativeclosestpoint_tpu_torch.io.las import (
    read_header,
    read_las,
    write_las,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import collect
from iterativeclosestpoint_tpu_torch.utils.synth import make_registration_pair
from portbench.reference import las_ref

UTM = np.array([512_345.0, 5_400_000.0, 250.0])


def _cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-100, 100, (n, 3)) * [1, 1, 0.1] + UTM


@pytest.mark.parametrize("point_format", [0, 1, 3])
def test_the_port_reads_what_the_plain_writer_wrote(tmp_path, point_format):
    xyz = _cloud()
    path = tmp_path / "a.las"
    offset = tuple(np.floor(xyz.min(axis=0)))
    las_ref.write(path, xyz, scale=(0.001, 0.001, 0.001), offset=offset,
                  point_format=point_format,
                  gps_time=np.arange(len(xyz)) * 1e-5)
    want = las_ref.read(path)
    h = want["header"]
    for engine in ("numpy", "auto"):
        pts, hdr = read_las(path, engine=engine)
        assert pts.dtype == np.float64
        assert np.array_equal(pts, want["xyz"])
        assert hdr == read_header(path)
        assert (hdr.point_count, hdr.point_record_length, hdr.point_format,
                hdr.offset_to_data, hdr.version) == (
            h["number_of_point_records"], h["point_data_record_length"],
            h["point_data_format"], h["offset_to_point_data"],
            (h["version_major"], h["version_minor"]))
        assert list(hdr.scale) == h["scale"]
        assert list(hdr.offset) == h["offset"]
        assert hdr.bounds_min == (h["min_x"], h["min_y"], h["min_z"])
        assert hdr.bounds_max == (h["max_x"], h["max_y"], h["max_z"])
    # Every fourth record, as the console program's decode stride takes.
    pts, _ = read_las(path, stride=4)
    assert np.array_equal(pts, want["xyz"][::4])


def test_the_plain_reader_reads_what_the_port_wrote(tmp_path):
    xyz = _cloud(seed=1)
    path = tmp_path / "b.las"
    hdr = write_las(path, xyz, scale=(0.001, 0.001, 0.001),
                    offset=(512_000.0, 5_399_000.0, 200.0))
    got = las_ref.read(path)
    h = got["header"]
    assert (h["point_data_format"], h["point_data_record_length"],
            h["number_of_point_records"]) == (0, 20, len(xyz))
    assert h["scale"] == list(hdr.scale) and h["offset"] == list(hdr.offset)
    assert np.array_equal(got["ints"], las_ref.quantise(
        xyz, hdr.scale, hdr.offset))
    assert np.array_equal(got["xyz"], read_las(path)[0])


def test_the_las_spans_count_the_files_bytes_and_points(tmp_path):
    xyz = _cloud(seed=2)
    src = tmp_path / "src.las"
    las_ref.write(src, xyz, scale=(0.001,) * 3,
                  offset=tuple(np.floor(xyz.min(axis=0))))
    out = tmp_path / "out.las"
    with collect(sync=True) as col:
        pts, hdr = read_las(src)
        write_las(out, pts, scale=hdr.scale, offset=hdr.offset)
        read_las(out)
    names = {"las/read/file", "las/read/decode", "las/write/encode",
             "las/write/file"}
    assert names <= set(col.stages)
    meta = col.meta
    size_in, size_out = src.stat().st_size, out.stat().st_size
    assert meta["las/read/file"]["las_bytes"] == size_in + size_out
    assert meta["las/read/file"]["calls"] == 2
    assert meta["las/write/file"]["las_bytes"] == size_out
    assert meta["las/read/decode"]["las_points"] == 2 * len(xyz)
    assert meta["las/read/decode"]["numpy_decodes"] == 2
    assert meta["las/write/encode"]["las_points"] == len(xyz)
    assert all(col.stages[k] > 0 for k in names)
    # Without a collector nothing is recorded, and the file is the same.
    again = tmp_path / "again.las"
    write_las(again, pts, scale=hdr.scale, offset=hdr.offset)
    assert again.read_bytes() == out.read_bytes()


@pytest.mark.parametrize("nn_backend", ["auto", "pallas"])
def test_the_registered_cloud_has_a_span_of_its_own(nn_backend):
    src, tgt, _ = make_registration_pair(3000, seed=5, noise_sigma=0.01)
    src, tgt = src + UTM, tgt + UTM
    kw = dict(max_iterations=3, coarse_max_points=1000, coarse_iterations=3,
              nn_backend=nn_backend, device="cpu")
    with collect() as col:
        res = icp_register_multiscale(src, tgt, return_registered=False,
                                      **kw)
    assert res.final.source_registered is None
    assert not [k for k in col.stages if k.endswith("registered")]
    with collect() as col:
        res = icp_register_multiscale(src, tgt, **kw)
    assert col.meta["fine/registered"]["calls"] == 1
    T = res.final.transform
    reg = res.final.source_registered
    # The device's f32 rows moved by the f32 pose, in the caller's order.
    assert np.abs(reg - (src @ T[:3, :3].T + T[:3, 3])).max() < 1e-4
