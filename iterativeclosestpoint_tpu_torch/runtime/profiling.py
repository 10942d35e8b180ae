"""Kernel reports against the card's issue floor, and a profiler trace.

Counterpart of the JAX package's ``runtime/profiling.py``. The JAX
package normalises its kernels by the v5e's data-sheet peaks; the port's
sweeps are held to the **issue floor** of the card they run on instead:

    floor = pairs × 9 / (SMs × 128 × max SM clock)

Each query–candidate pair costs 9 f32 instructions (3 sub, 3 mul, 2 add,
1 compare; the d² contract forbids FMA), and an SM issues 128 f32
instructions per clock. The SM count comes from torch and the clock from
``nvidia-smi``, so the floor follows the card (132 SMs at 1,980 MHz on an
H100 SXM). The statistics-and-moments stage streams its inputs once and
is held to the card's HBM bandwidth instead (``covariance_kernel_report``).

Each report also carries the JAX package's roofline: its ``flops`` and
``bytes_hbm`` against two peaks of the card, ``CardSpec``'s f32 rate
outside the tensor cores (the H100 SXM data sheet's 67 TFLOP/s) and its
HBM rate (``card_spec`` reads it from torch, else the data sheet's 3.35
TB/s), as achieved rates, the shares ``sol_compute``, ``sol_memory`` and
``sol`` (the larger), and the least time the same work could take,
``bound_s``. The f32 rate counts an FMA as two operations, which the d²
contract forbids, so a sweep's bound is about half its issue floor.
``trace`` wraps ``torch.profiler`` and writes a Chrome trace, with the
program's stage spans as a track of their own where a collector is given.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

OPS_PER_PAIR = 9            # 3 sub, 3 mul, 2 add, 1 compare
ISSUE_PER_SM_CLOCK = 128    # f32 instructions an SM issues per clock
H100_SXM_HBM_BYTES_PER_S = 3.35e12  # the data sheet's HBM3 rate
H100_SXM_F32_OPS_PER_S = 67e12      # the data sheet's f32 rate, no tensor cores
H100_SXM_SHEET = "H100 SXM data sheet"


@dataclasses.dataclass
class CardSpec:
    """What the issue floor and the roofline need to know of a card."""

    name: str
    sms: int
    max_sm_clock_hz: float
    hbm_bytes_per_s: float = H100_SXM_HBM_BYTES_PER_S
    hbm_source: str = H100_SXM_SHEET
    f32_ops_per_s: float = H100_SXM_F32_OPS_PER_S
    f32_source: str = H100_SXM_SHEET

    @property
    def issue_rate(self) -> float:
        """f32 instructions per second at the maximum SM clock."""
        return self.sms * ISSUE_PER_SM_CLOCK * self.max_sm_clock_hz


def _hbm_rate(props):
    """(bytes/s, source) of a card's memory: double data rate × bus width
    × memory clock where torch reports both, else the H100 SXM data
    sheet's 3.35 TB/s."""
    clock_khz = getattr(props, "memory_clock_rate", 0)
    bus_bits = getattr(props, "memory_bus_width", 0)
    if clock_khz > 0 and bus_bits > 0:
        return (2.0 * bus_bits / 8 * clock_khz * 1e3,
                f"torch: {bus_bits}-bit bus at {clock_khz / 1e3:.0f} MHz")
    return H100_SXM_HBM_BYTES_PER_S, H100_SXM_SHEET


def card_spec(device=None) -> CardSpec:
    """The spec of a CUDA card (default: the current one): its name and
    SM count from torch, its maximum SM clock from ``nvidia-smi``, its
    HBM rate from torch's memory clock and bus width (``_hbm_rate``)."""
    from iterativeclosestpoint_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"card_spec needs a CUDA device, got {dev}")
    index = (dev.index if dev.index is not None
             else torch.cuda.current_device())
    props = torch.cuda.get_device_properties(index)
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0]
    return CardSpec(props.name, props.multi_processor_count,
                    float(out) * 1e6, *_hbm_rate(props))


class _Roofline:
    """The JAX package's roofline over ``flops`` and ``bytes_hbm`` in
    ``elapsed_s``, against ``card``'s f32 and HBM rates."""

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.elapsed_s / 1e12

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_hbm / self.elapsed_s / 1e9

    @property
    def sol_compute(self) -> float:
        return self.flops / self.elapsed_s / self.card.f32_ops_per_s

    @property
    def sol_memory(self) -> float:
        return self.bytes_hbm / self.elapsed_s / self.card.hbm_bytes_per_s

    @property
    def sol(self) -> float:
        """Utilization against the binding resource (roofline)."""
        return max(self.sol_compute, self.sol_memory)

    def _times(self) -> tuple:
        """(operations over the f32 rate, bytes over the HBM rate), s."""
        return (self.flops / self.card.f32_ops_per_s,
                self.bytes_hbm / self.card.hbm_bytes_per_s)

    @property
    def bound_s(self) -> float:
        """The least time the work could take on the card: the larger of
        its operations over the f32 rate and its bytes over the HBM
        rate."""
        return max(self._times())

    @property
    def bound_by(self) -> str:
        t_ops, t_bytes = self._times()
        return "operations" if t_ops >= t_bytes else "bytes"

    def roofline(self) -> str:
        """The roofline part of the JAX package's ``KernelReport.line``."""
        return (
            f"{self.achieved_tflops:.2f} TFLOP/s ({self.sol_compute:.0%} "
            f"f32), {self.achieved_gbps:.0f} GB/s ({self.sol_memory:.0%} "
            f"HBM) -> SoL {self.sol:.0%}, bound {self.bound_s * 1e3:.4f} ms "
            f"({self.bound_by})"
        )


@dataclasses.dataclass
class KernelReport(_Roofline):
    """A sweep launch: ``pairs`` against the issue floor, and ``flops``
    and ``bytes_hbm`` against the roofline (0 where not given)."""

    name: str
    elapsed_s: float
    pairs: float
    card: CardSpec
    flops: float = 0.0
    bytes_hbm: float = 0.0

    @property
    def floor_s(self) -> float:
        return self.pairs * OPS_PER_PAIR / self.card.issue_rate

    @property
    def share(self) -> float:
        """Share of the issue floor reached (1.0 = at the floor)."""
        return self.floor_s / self.elapsed_s

    @property
    def pairs_per_s(self) -> float:
        return self.pairs / self.elapsed_s

    def line(self) -> str:
        head = (
            f"{self.name}: {self.elapsed_s * 1e3:.4f} ms, "
            f"{self.pairs:.4e} pairs ({self.pairs_per_s:.4e}/s), issue "
            f"floor {self.floor_s * 1e3:.4f} ms on {self.card.name} -> "
            f"{self.share:.3f} of the floor"
        )
        if self.flops or self.bytes_hbm:
            head += "; " + self.roofline()
        return head


def nn_kernel_report(
    n_queries: int, tile_q: int, slabs: int, trange: int, elapsed_s: float,
    card: Optional[CardSpec] = None, name: str = "nn-slab-sweep",
) -> KernelReport:
    """Report of a sweep launch (K1/K2, ops/sweep_kernels.py) over every
    lane it may scan: per tile ``slabs`` windows of ``trange`` rows for
    each of its ``tile_q`` queries. The z-column sweep passes slabs = 12
    (its z-window slots) and trange = zrange, with name="nn-zcol".

    The roofline takes the port's kernel model: ``OPS_PER_PAIR`` (9) f32
    operations a pair, and per tile the bytes its kernel reads and writes,
    each lane's staged target row (xyz, 12 B), the queries (12 B each),
    the slot table (8 B a slot: base and mask) and the (8, tile_q) f32
    output. Like the JAX package's model, this counts every lane, also
    those past a window's live rows, so where windows are not full the
    floor and the bound overstate the work and the shares overstate what
    the kernel reaches (a 1M K1 launch alone reads ~2.2 "of the floor").
    Nothing should gate on them until live pairs are counted."""
    tiles = -(-n_queries // tile_q)
    pairs = float(tiles * tile_q * slabs * trange)
    nbytes = tiles * (slabs * trange * 12 + tile_q * 12 + slabs * 8
                      + 8 * tile_q * 4)
    return KernelReport(name, elapsed_s, pairs, card or card_spec(),
                        flops=pairs * OPS_PER_PAIR, bytes_hbm=float(nbytes))


@dataclasses.dataclass
class StreamReport(_Roofline):
    """A stage that streams its inputs once, held to the larger of its
    bytes over the card's HBM rate and its operations over the issue
    rate."""

    name: str
    elapsed_s: float
    n_points: int
    bytes_per_point: float
    ops_per_point: float
    card: CardSpec

    @property
    def bytes_hbm(self) -> float:
        return self.n_points * self.bytes_per_point

    @property
    def flops(self) -> float:
        return self.n_points * self.ops_per_point

    @property
    def floor_s(self) -> float:
        return max(self.bytes_hbm / self.card.hbm_bytes_per_s,
                   self.flops / self.card.issue_rate)

    @property
    def share(self) -> float:
        """Share of the floor reached (1.0 = at the floor)."""
        return self.floor_s / self.elapsed_s

    def line(self) -> str:
        return (
            f"{self.name}: {self.elapsed_s * 1e3:.4f} ms, {self.n_points} "
            f"points x {self.bytes_per_point:.0f} B = "
            f"{self.achieved_gbps:.1f} GB/s, {self.sol_memory:.4f} of "
            f"{self.card.hbm_bytes_per_s / 1e12:.3f} TB/s HBM "
            f"({self.card.hbm_source}); floor {self.floor_s * 1e3:.4f} ms on "
            f"{self.card.name} -> {self.share:.3f} of the floor"
        )


def covariance_kernel_report(
    n_points: int, elapsed_s: float, card: Optional[CardSpec] = None,
) -> StreamReport:
    """Report of the rejection-and-moments stage (hot loop B,
    icpengine.cpp:263-337 in one pass: ``models/icp.py::
    iteration_statistics`` and ``ops/kabsch.py::kabsch_masked``'s sums):
    one streaming read of (src, matched, dist, weight) ≈ 28 B a point and
    ~30 operations a point (mask, 5 masked sums, the 9-term outer
    product), the JAX package's model of the same stage, as its
    ``bytes_hbm`` and ``flops``."""
    return StreamReport("reject+moments", elapsed_s, n_points, 28.0, 30.0,
                        card or card_spec())


MARK = "icp-torch.mark"
STAGE_TRACK = "icp-torch stages"
STAGE_TID = 2**31 - 1  # the stage track's thread id, no system thread's


def _mark() -> int:
    """A marker range on the profiler's clock; returns the
    ``perf_counter_ns`` time of its middle."""
    a = time.perf_counter_ns()
    with torch.profiler.record_function(MARK):
        pass
    return (a + time.perf_counter_ns()) // 2


def add_stage_track(path, intervals, t_mark_ns: int) -> None:
    """Append the spans ``intervals`` (``timing.Interval``, on
    ``perf_counter_ns``) to the Chrome trace at ``path`` as their own
    track, "icp-torch stages", on the trace's clock: the last ``MARK``
    event in the trace started at ``t_mark_ns``. A span still open has
    no interval yet and is left out."""
    path = Path(path)
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    mark = [e for e in events if e.get("name") == MARK][-1]
    off_us = mark["ts"] - t_mark_ns / 1e3
    pid = mark["pid"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": STAGE_TID, "args": {"name": STAGE_TRACK}})
    for iv in intervals:
        if iv is None:
            continue
        parent = intervals[iv.parent] if iv.parent is not None else None
        events.append({
            "ph": "X", "cat": "icp_stage", "name": iv.name, "pid": pid,
            "tid": STAGE_TID, "ts": iv.start_ns / 1e3 + off_us,
            "dur": (iv.end_ns - iv.start_ns) / 1e3,
            "args": {"parent": parent.name if parent else None,
                     "call": iv.call},
        })
    path.write_text(json.dumps(doc))


@contextlib.contextmanager
def trace(log_dir: Optional[str], spans=None):
    """``torch.profiler`` over the block (CPU, and the card where CUDA is
    available); writes ``<log_dir>/trace.json`` (Chrome trace format:
    chrome://tracing or Perfetto). ``spans``: a ``timing.StageCollector``
    whose spans are added to the trace as their own track
    (``add_stage_track``)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        _mark()  # the first record_function of a process sets itself up
        t_mark = _mark()
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    if spans is not None:
        add_stage_track(out / "trace.json", spans.intervals, t_mark)
