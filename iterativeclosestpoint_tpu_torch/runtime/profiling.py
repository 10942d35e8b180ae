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
``trace`` wraps ``torch.profiler`` and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
from pathlib import Path
from typing import Optional

import torch

OPS_PER_PAIR = 9            # 3 sub, 3 mul, 2 add, 1 compare
ISSUE_PER_SM_CLOCK = 128    # f32 instructions an SM issues per clock
H100_SXM_HBM_BYTES_PER_S = 3.35e12  # the data sheet's HBM3 rate


@dataclasses.dataclass
class CardSpec:
    """What the issue floor needs to know of a card."""

    name: str
    sms: int
    max_sm_clock_hz: float
    hbm_bytes_per_s: float = H100_SXM_HBM_BYTES_PER_S
    hbm_source: str = "H100 SXM data sheet"

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
    return H100_SXM_HBM_BYTES_PER_S, "H100 SXM data sheet"


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


@dataclasses.dataclass
class KernelReport:
    name: str
    elapsed_s: float
    pairs: float
    card: CardSpec

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
        return (
            f"{self.name}: {self.elapsed_s * 1e3:.4f} ms, "
            f"{self.pairs:.4e} pairs ({self.pairs_per_s:.4e}/s), issue "
            f"floor {self.floor_s * 1e3:.4f} ms on {self.card.name} -> "
            f"{self.share:.3f} of the floor"
        )


def nn_kernel_report(
    n_queries: int, tile_q: int, slabs: int, trange: int, elapsed_s: float,
    card: Optional[CardSpec] = None, name: str = "nn-slab-sweep",
) -> KernelReport:
    """Issue-floor report of a sweep launch (K1/K2, ops/sweep_kernels.py)
    over every lane it may scan: per tile ``slabs`` windows of ``trange``
    rows for each of its ``tile_q`` queries. The z-column sweep passes
    slabs = 12 (its z-window slots) and trange = zrange, with
    name="nn-zcol". Lanes past a window's live rows count too, so where
    windows are not full the share overstates what the kernel reaches."""
    tiles = -(-n_queries // tile_q)
    pairs = float(tiles * tile_q * slabs * trange)
    return KernelReport(name, elapsed_s, pairs, card or card_spec())


@dataclasses.dataclass
class StreamReport:
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
    def bytes(self) -> float:
        return self.n_points * self.bytes_per_point

    @property
    def floor_s(self) -> float:
        return max(self.bytes / self.card.hbm_bytes_per_s,
                   self.n_points * self.ops_per_point / self.card.issue_rate)

    @property
    def share(self) -> float:
        """Share of the floor reached (1.0 = at the floor)."""
        return self.floor_s / self.elapsed_s

    def line(self) -> str:
        rate = self.bytes / self.elapsed_s
        return (
            f"{self.name}: {self.elapsed_s * 1e3:.4f} ms, {self.n_points} "
            f"points x {self.bytes_per_point:.0f} B = {rate / 1e9:.1f} GB/s,"
            f" {rate / self.card.hbm_bytes_per_s:.4f} of "
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
    product), the JAX package's model of the same stage."""
    return StreamReport("reject+moments", elapsed_s, n_points, 28.0, 30.0,
                        card or card_spec())


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (CPU, and the card where CUDA is
    available); writes ``<log_dir>/trace.json`` (Chrome trace format:
    chrome://tracing or Perfetto)."""
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
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
