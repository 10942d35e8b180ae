"""LAS 1.2 binary reader/writer, numpy-vectorized.

The port's own copy of the JAX package's ``io/las.py`` (host code, no
device work): the same header layout, decoders and writer, so a file
written by either package is byte-identical and reads back the same in
both.

Equivalent of the reference's ``LASIO``
(``PointCloudRegistration/core/lasio.cpp:7-300``) and the CLI twin
(``icp_registration.cpp:248-378,698-815``): a 227-byte LAS 1.2 header with
fields at fixed offsets (data-offset@96, point-format@104, record-len@105,
count@107, scale@131/139/147, offset@155/163/171, bounds@179-226), point
records decoded as ``int32·scale + offset``.

Where the C++ reader loops over 10k-point batches into a 1 MB stream
buffer, this reader decodes all records in one strided numpy view — the
idiomatic equivalent for an I/O-bound path (SURVEY.md §2 native-code
note). A native C++ decoder is available through runtime/native.py for
very large files.

Writer policy follows the reference *CLI* (icp_registration.cpp:766-773,
author-marked as the fix): the caller's scale/offset are preserved so the
georeference survives a round-trip; the GUI's re-basing-to-min behavior
(lasio.cpp:167-174) is available as ``rebase=True``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from iterativeclosestpoint_tpu_torch.utils.hostmath import bbox

HEADER_SIZE = 227  # LAS 1.2 standard header (lasio.cpp:21)
SIGNATURE = b"LASF"
DEFAULT_SCALE = (0.001, 0.001, 0.001)  # GUI writer's fixed scale (lasio.cpp:167)


@dataclasses.dataclass
class LASHeader:
    """The header fields the engine uses (lasio.cpp:38-48)."""

    point_count: int
    point_record_length: int
    offset_to_data: int
    scale: Tuple[float, float, float]
    offset: Tuple[float, float, float]
    point_format: int = 0
    version: Tuple[int, int] = (1, 2)
    bounds_min: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    bounds_max: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def _parse_header(raw: bytes) -> LASHeader:
    if len(raw) < HEADER_SIZE:
        raise ValueError("file too short for a LAS 1.2 header")
    if raw[:4] != SIGNATURE:
        raise ValueError("not a valid LAS file (missing LASF signature)")

    u32 = lambda off: int(np.frombuffer(raw, "<u4", 1, off)[0])
    u16 = lambda off: int(np.frombuffer(raw, "<u2", 1, off)[0])
    f64 = lambda off: float(np.frombuffer(raw, "<f8", 1, off)[0])

    return LASHeader(
        point_count=u32(107),
        point_record_length=u16(105),
        offset_to_data=u32(96),
        scale=(f64(131), f64(139), f64(147)),
        offset=(f64(155), f64(163), f64(171)),
        point_format=raw[104],
        version=(raw[24], raw[25]),
        bounds_max=(f64(179), f64(195), f64(211)),
        bounds_min=(f64(187), f64(203), f64(219)),
    )


def read_header(path: str | Path) -> LASHeader:
    with open(path, "rb") as f:
        return _parse_header(f.read(HEADER_SIZE))


def read_las(
    path: str | Path,
    max_points: int = 0,
    stride: int = 1,
    engine: str = "auto",
) -> Tuple[np.ndarray, LASHeader]:
    """Read a LAS 1.2 file into an (N, 3) float64 array.

    Args:
      path: LAS file path.
      max_points: cap on points read (0 = all) — the reference reader's
        ``maxPoints`` (lasio.cpp:60-63).
      stride: keep every stride-th point — the CLI's 1/50 downsample
        (icp_registration.cpp:857) done at decode time, for free.
      engine: "numpy" (strided structured view), "native" (C++ decoder,
        runtime/native.py), or "auto" (native for very large full reads
        when the toolchain built it, numpy otherwise).

    Returns:
      (points (N,3) float64 world coordinates, header).
    """
    path = Path(path)
    raw = np.fromfile(path, dtype=np.uint8)
    hdr = _parse_header(raw[:HEADER_SIZE].tobytes())

    n = hdr.point_count
    if max_points > 0:
        n = min(n, max_points)
    L = hdr.point_record_length
    start = hdr.offset_to_data
    avail = (len(raw) - start) // L
    n = min(n, avail)

    if engine != "numpy" and stride == 1:
        use_native = engine == "native" or (engine == "auto" and n > 20_000_000)
        if use_native:
            try:
                from iterativeclosestpoint_tpu_torch.runtime.native import (
                    las_decode_native,
                    native_available,
                )

                if native_available():
                    pts = las_decode_native(
                        raw[start : start + n * L], n, L,
                        np.asarray(hdr.scale), np.asarray(hdr.offset),
                    )
                    return pts, hdr
                if engine == "native":
                    raise RuntimeError("native decoder unavailable")
            except ImportError:
                if engine == "native":
                    raise

    # One strided structured view decodes every record at once.
    rec = np.dtype(
        {"names": ["x", "y", "z"], "formats": ["<i4", "<i4", "<i4"],
         "offsets": [0, 4, 8], "itemsize": L}
    )
    pts_i = np.frombuffer(raw.data, dtype=rec, count=n, offset=start)
    if stride > 1:
        pts_i = pts_i[::stride]

    scale = np.asarray(hdr.scale)
    offset = np.asarray(hdr.offset)
    pts = np.empty((len(pts_i), 3), np.float64)
    pts[:, 0] = pts_i["x"]
    pts[:, 1] = pts_i["y"]
    pts[:, 2] = pts_i["z"]
    pts *= scale
    pts += offset
    return pts, hdr


def read_las_range(
    path: str | Path,
    start: int,
    stop: int,
    step: int = 1,
    header: Optional[LASHeader] = None,
) -> Tuple[np.ndarray, LASHeader]:
    """Decode file rows [start, stop) (every ``step``-th) of a LAS file.

    The byte-range form of the reference's batch reader
    (lasio.cpp:212-300): seeks straight to ``offset_to_data + start·L``
    and decodes only that slice, so a process ingesting its shard of a
    sharded array never materializes the full cloud (per-host sharded
    ingest, SURVEY.md C5; see parallel/ingest.py).
    """
    path = Path(path)
    hdr = header or read_header(path)
    L = hdr.point_record_length
    start = max(0, min(start, hdr.point_count))
    stop = max(start, min(stop, hdr.point_count))
    n = stop - start
    with open(path, "rb") as f:
        f.seek(hdr.offset_to_data + start * L)
        buf = f.read(n * L)
    got = len(buf) // L
    rec = np.dtype(
        {"names": ["x", "y", "z"], "formats": ["<i4", "<i4", "<i4"],
         "offsets": [0, 4, 8], "itemsize": L}
    )
    pts_i = np.frombuffer(buf, dtype=rec, count=got)
    if step > 1:
        pts_i = pts_i[::step]
    pts = np.empty((len(pts_i), 3), np.float64)
    pts[:, 0] = pts_i["x"]
    pts[:, 1] = pts_i["y"]
    pts[:, 2] = pts_i["z"]
    pts *= np.asarray(hdr.scale)
    pts += np.asarray(hdr.offset)
    return pts, hdr


def read_las_batches(
    path: str | Path,
    batch_size: int = 1_000_000,
    stride: int = 1,
) -> Iterator[np.ndarray]:
    """Stream a LAS file in decoded batches (readLASBatch analog,
    lasio.cpp:212-300) — for sharded per-host ingest of files larger than
    memory."""
    path = Path(path)
    hdr = read_header(path)
    L = hdr.point_record_length
    scale = np.asarray(hdr.scale)
    offset = np.asarray(hdr.offset)
    rec = np.dtype(
        {"names": ["x", "y", "z"], "formats": ["<i4", "<i4", "<i4"],
         "offsets": [0, 4, 8], "itemsize": L}
    )
    with open(path, "rb") as f:
        f.seek(hdr.offset_to_data)
        remaining = hdr.point_count
        while remaining > 0:
            take = min(batch_size, remaining)
            buf = f.read(take * L)
            if len(buf) < L:
                break
            got = len(buf) // L
            pts_i = np.frombuffer(buf, dtype=rec, count=got)
            if stride > 1:
                pts_i = pts_i[::stride]
            pts = np.empty((len(pts_i), 3), np.float64)
            pts[:, 0] = pts_i["x"]
            pts[:, 1] = pts_i["y"]
            pts[:, 2] = pts_i["z"]
            pts *= scale
            pts += offset
            yield pts
            remaining -= got


def write_las(
    path: str | Path,
    points: np.ndarray,
    scale: Optional[Tuple[float, float, float]] = None,
    offset: Optional[Tuple[float, float, float]] = None,
    rebase: bool = False,
) -> LASHeader:
    """Write an (N, 3) array as LAS 1.2 point-format-0 (20-byte records).

    Default policy preserves the given scale/offset (the CLI behavior,
    icp_registration.cpp:766-773). ``rebase=True`` reproduces the GUI
    writer instead: offset re-based to the cloud minimum with fixed 0.001
    scale (lasio.cpp:167-174) — documented as georeference-lossy.
    """
    points = np.asarray(points, np.float64)
    if points.size == 0:
        raise ValueError("empty cloud, nothing to write")

    pmin, pmax = bbox(points)
    if rebase or offset is None:
        offset = tuple(pmin)
    if rebase or scale is None:
        scale = DEFAULT_SCALE

    n = len(points)
    header = np.zeros(HEADER_SIZE, np.uint8)
    header[0:4] = np.frombuffer(SIGNATURE, np.uint8)
    header[24] = 1  # version major
    header[25] = 2  # version minor
    header[94:96] = np.frombuffer(np.uint16(HEADER_SIZE).tobytes(), np.uint8)
    header[96:100] = np.frombuffer(np.uint32(HEADER_SIZE).tobytes(), np.uint8)
    header[104] = 0  # point format 0
    header[105:107] = np.frombuffer(np.uint16(20).tobytes(), np.uint8)
    header[107:111] = np.frombuffer(np.uint32(n).tobytes(), np.uint8)

    def put_f64(off, v):
        header[off : off + 8] = np.frombuffer(np.float64(v).tobytes(), np.uint8)

    for i, off in enumerate((131, 139, 147)):
        put_f64(off, scale[i])
    for i, off in enumerate((155, 163, 171)):
        put_f64(off, offset[i])
    # Bounds block: max/min interleaved per axis (lasio.cpp:177-182).
    for i, (off_max, off_min) in enumerate(((179, 187), (195, 203), (211, 219))):
        put_f64(off_max, pmax[i])
        put_f64(off_min, pmin[i])

    ints = np.ascontiguousarray(
        np.round((points - np.asarray(offset)) / np.asarray(scale)), "<i4"
    )
    records = np.zeros((n, 20), np.uint8)  # point-format-0: 20-byte records
    records[:, 0:12] = ints.view(np.uint8).reshape(n, 12)

    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(records.tobytes())

    return LASHeader(
        point_count=n,
        point_record_length=20,
        offset_to_data=HEADER_SIZE,
        scale=tuple(scale),
        offset=tuple(offset),
        bounds_min=tuple(pmin),
        bounds_max=tuple(pmax),
    )
