"""Kernel reports against the card's issue floor, and a profiler trace.

Counterpart of the JAX package's ``runtime/profiling.py``. The JAX
package normalises its kernels by the v5e's data-sheet peaks; the port's
sweeps are held to the **issue floor** of the card they run on instead:

    floor = pairs × 9 / (SMs × 128 × max SM clock)

Each query–candidate pair costs 9 f32 instructions (3 sub, 3 mul, 2 add,
1 compare; the d² contract forbids FMA), and an SM issues 128 f32
instructions per clock. The SM count comes from torch and the clock from
``nvidia-smi``, so the floor follows the card (132 SMs at 1,980 MHz on an
H100 SXM). ``trace`` wraps ``torch.profiler`` and writes a Chrome trace.
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


@dataclasses.dataclass
class CardSpec:
    """What the issue floor needs to know of a card."""

    name: str
    sms: int
    max_sm_clock_hz: float

    @property
    def issue_rate(self) -> float:
        """f32 instructions per second at the maximum SM clock."""
        return self.sms * ISSUE_PER_SM_CLOCK * self.max_sm_clock_hz


def card_spec(device=None) -> CardSpec:
    """The spec of a CUDA card (default: the current one): its name and
    SM count from torch, its maximum SM clock from ``nvidia-smi``."""
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
                    float(out) * 1e6)


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
