"""Stage-attribution timing for the registration pipeline.

A contextvar carries the active collector, and every ``stage(...)`` block
is a no-op when no collector is active (zero overhead on the normal path).
Under a collector with ``sync=True`` a stage ends with
``torch.cuda.synchronize()`` once its outputs live on the card, so the
wall time it records includes the device work it queued. Synced
attribution serializes stages that would otherwise overlap; its total is
an upper bound on the unsynced run.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch

_active: contextvars.ContextVar = contextvars.ContextVar(
    "icp_torch_stage_collector", default=None
)


class StageCollector:
    """Accumulates (stage name -> seconds, metadata)."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.stages: dict = {}  # name -> seconds (accumulated)
        self.meta: dict = {}  # name -> dict
        self._prefix: list = []

    def add(self, name: str, dt: float, **meta):
        self.stages[name] = self.stages.get(name, 0.0) + dt
        if meta:
            m = self.meta.setdefault(name, {})
            for k, v in meta.items():
                m[k] = m.get(k, 0) + v if isinstance(v, (int, float)) else v

    def qualified(self, name: str) -> str:
        return "/".join(self._prefix + [name])

    def lines(self):
        """Human-readable per-stage lines, insertion order."""
        out = []
        for name, dt in self.stages.items():
            extra = ""
            m = self.meta.get(name, {})
            if "bytes" in m:
                mb = m["bytes"] / 1e6
                extra = f" ({mb:.1f} MB, {mb / max(dt, 1e-9):.0f} MB/s)"
            out.append(f"{name}: {dt * 1e3:.3f} ms{extra}")
        return out


def _on_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(v) for v in x)
    return False


def _drain(arrays) -> None:
    """Wait for the card when any tensor in ``arrays`` lives there (no-op
    for host-only structures)."""
    if _on_cuda(arrays):
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage(name: str, **meta):
    """Time a pipeline stage. Yields ``done(outputs)`` — call it with the
    stage's device outputs to sync before the clock stops (only when a
    collector with sync=True is active; otherwise a no-op)."""
    col = _active.get()
    if col is None:
        yield lambda *_: None
        return
    qname = col.qualified(name)
    t0 = time.perf_counter()
    yield (_drain if col.sync else (lambda *_: None))
    col.add(qname, time.perf_counter() - t0, **meta)


@contextlib.contextmanager
def scope(name: str):
    """Prefix inner stage names (e.g. coarse/ vs fine/) and record the
    scope's own total under ``name``."""
    col = _active.get()
    if col is None:
        yield
        return
    qname = col.qualified(name)
    col._prefix.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        col._prefix.pop()
        col.add(qname, time.perf_counter() - t0)


@contextlib.contextmanager
def collect(sync: bool = True):
    """Activate stage collection for the dynamic extent of the block."""
    col = StageCollector(sync=sync)
    tok = _active.set(col)
    try:
        yield col
    finally:
        _active.reset(tok)


def active() -> "StageCollector | None":
    """The collector of the enclosing ``collect`` block, or None."""
    return _active.get()
