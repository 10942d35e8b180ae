"""A plain LAS 1.2 reader and writer, from the ASPRS specification.

numpy only: nothing of the program, of JAX or of the JAX package is
imported, so a file the program reads or writes is held against this
module's reading of the format, not against the program's own.

The public header block (LAS 1.2, 227 bytes) is one packed record of the
specification's fields in their order; a point record is the fields of
its point data format (0: 20 bytes; 1: 28, with GPS time; 2: 26, with
RGB; 3: 34, with both). A coordinate is ``X * x_scale + x_offset`` on
the record's signed 32-bit integer, and a writer stores
``round((x - x_offset) / x_scale)``.
"""

from __future__ import annotations

import numpy as np

HEADER = np.dtype([
    ("signature", "S4"), ("file_source_id", "<u2"),
    ("global_encoding", "<u2"), ("guid_1", "<u4"), ("guid_2", "<u2"),
    ("guid_3", "<u2"), ("guid_4", "S8"), ("version_major", "u1"),
    ("version_minor", "u1"), ("system_identifier", "S32"),
    ("generating_software", "S32"), ("creation_day", "<u2"),
    ("creation_year", "<u2"), ("header_size", "<u2"),
    ("offset_to_point_data", "<u4"), ("number_of_vlrs", "<u4"),
    ("point_data_format", "u1"), ("point_data_record_length", "<u2"),
    ("number_of_point_records", "<u4"),
    ("number_of_points_by_return", "<u4", (5,)),
    ("scale", "<f8", (3,)), ("offset", "<f8", (3,)),
    ("max_x", "<f8"), ("min_x", "<f8"), ("max_y", "<f8"), ("min_y", "<f8"),
    ("max_z", "<f8"), ("min_z", "<f8"),
])
assert HEADER.itemsize == 227

_BASE = [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
         ("return_byte", "u1"), ("classification", "u1"),
         ("scan_angle_rank", "i1"), ("user_data", "u1"),
         ("point_source_id", "<u2")]
_GPS = [("gps_time", "<f8")]
_RGB = [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
POINT = {0: np.dtype(_BASE), 1: np.dtype(_BASE + _GPS),
         2: np.dtype(_BASE + _RGB), 3: np.dtype(_BASE + _GPS + _RGB)}


def _header(raw: bytes, path) -> dict:
    if len(raw) < HEADER.itemsize:
        raise ValueError(f"{path}: shorter than a LAS 1.2 header")
    h = np.frombuffer(raw, HEADER, 1)[0]
    if h["signature"] != b"LASF":
        raise ValueError(f"{path}: no LASF signature")
    return {name: (h[name].tolist() if h[name].ndim else h[name].item())
            for name in HEADER.names}


def read_header(path) -> dict:
    """The header's fields, by the specification's names."""
    with open(path, "rb") as f:
        return _header(f.read(HEADER.itemsize), path)


def read(path) -> dict:
    """The file's header (a dict of the header's fields) under
    ``header``, its records' integer coordinates ``ints`` (n, 3) int32
    and their world coordinates ``xyz`` (n, 3) float64."""
    with open(path, "rb") as f:
        raw = f.read()
    header = _header(raw, path)
    fmt = header["point_data_format"]
    rec = np.dtype({"names": list(POINT[fmt].names),
                    "formats": [POINT[fmt].fields[k][0]
                                for k in POINT[fmt].names],
                    "offsets": [POINT[fmt].fields[k][1]
                                for k in POINT[fmt].names],
                    "itemsize": header["point_data_record_length"]})
    n = header["number_of_point_records"]
    start = header["offset_to_point_data"]
    if start + n * rec.itemsize > len(raw):
        raise ValueError(f"{path}: {n} records do not fit the file")
    records = np.frombuffer(raw, rec, n, start)
    ints = np.stack([records["X"], records["Y"], records["Z"]], axis=1)
    xyz = ints * np.asarray(header["scale"]) + np.asarray(header["offset"])
    return {"header": header, "ints": ints, "xyz": xyz}


def quantise(xyz, scale, offset) -> np.ndarray:
    """The integers a writer stores for world coordinates ``xyz``."""
    q = np.round((np.asarray(xyz, np.float64) - np.asarray(offset))
                 / np.asarray(scale))
    if np.abs(q).max(initial=0) > 2**31 - 1:
        raise ValueError("coordinates out of the 32-bit range at this scale")
    return q.astype(np.int32)


def write(path, xyz, *, scale, offset, point_format: int = 1,
          gps_time=None) -> int:
    """Write world coordinates ``xyz`` (n, 3) as a LAS 1.2 file of the
    given point data format, every record a single return (return 1 of
    1) of class 2 (ground); returns the bytes written."""
    xyz = np.asarray(xyz, np.float64)
    n = len(xyz)
    ints = quantise(xyz, scale, offset)
    rec = np.zeros(n, POINT[point_format])
    rec["X"], rec["Y"], rec["Z"] = ints[:, 0], ints[:, 1], ints[:, 2]
    rec["return_byte"] = 0b001_001  # return 1 of 1
    rec["classification"] = 2
    if gps_time is not None and "gps_time" in rec.dtype.names:
        rec["gps_time"] = gps_time
    stored = ints * np.asarray(scale, np.float64) + np.asarray(offset)
    h = np.zeros((), HEADER)
    h["signature"] = b"LASF"
    h["version_major"], h["version_minor"] = 1, 2
    h["generating_software"] = b"portbench las_ref"
    h["header_size"] = HEADER.itemsize
    h["offset_to_point_data"] = HEADER.itemsize
    h["point_data_format"] = point_format
    h["point_data_record_length"] = POINT[point_format].itemsize
    h["number_of_point_records"] = n
    h["number_of_points_by_return"] = (n, 0, 0, 0, 0)
    h["scale"], h["offset"] = scale, offset
    lo, hi = stored.min(axis=0), stored.max(axis=0)
    h["min_x"], h["min_y"], h["min_z"] = lo
    h["max_x"], h["max_y"], h["max_z"] = hi
    with open(path, "wb") as f:
        f.write(h.tobytes())
        f.write(rec.tobytes())
    return h.nbytes + rec.nbytes
