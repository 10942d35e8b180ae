"""Stage-attribution timing for the registration pipeline.

A contextvar carries the active collector, and every ``stage(...)``,
``scope(...)``, ``call(...)`` block and ``count(...)`` call is a no-op
when no collector is active: one ``_active.get()`` and a shared empty
context manager, no allocation, no device work. Under a collector with
``sync=True`` a stage ends with ``torch.cuda.synchronize()`` once its
outputs live on the card (where the stage calls ``done``), so the wall
time it records includes the device work it queued. Synced attribution
serializes stages that would otherwise overlap; its total is an upper
bound on the unsynced run.

Every stage and scope is a span. The collector sums its seconds by
qualified name (``stages``), counts its entries (``meta[name]["calls"]``)
and keeps its interval (``intervals``: name, start and end on
``time.perf_counter_ns``, the enclosing span's index and the id of the
registration call it ran in). ``count(key, n)`` adds to the innermost
open span's ``meta``. The open-span stack and the call id live in
contextvars, like the collector, so threads that run in their own
contexts never see each other's spans.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import time
from typing import NamedTuple, Optional

import torch

_active: contextvars.ContextVar = contextvars.ContextVar(
    "icp_torch_stage_collector", default=None
)
# (collector, interval index, qualified name) of the innermost open span.
_open: contextvars.ContextVar = contextvars.ContextVar(
    "icp_torch_open_span", default=None
)
# (collector, id) of the registration call the block runs in.
_call: contextvars.ContextVar = contextvars.ContextVar(
    "icp_torch_call", default=None
)


class Interval(NamedTuple):
    """One span as it ran: qualified name, start and end ns on
    ``time.perf_counter_ns``, the index in ``intervals`` of the span that
    enclosed it (None at the top) and its registration call's id (None
    outside any)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: Optional[int]


class StageCollector:
    """Accumulates (stage name -> seconds, metadata) and each span's
    interval."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.stages: dict = {}  # name -> seconds (accumulated)
        self.meta: dict = {}  # name -> dict
        self.intervals: list = []  # Interval per span, in opening order
        self._prefix: list = []
        self._calls = 0

    def add(self, name: str, dt: float, **meta):
        self.stages[name] = self.stages.get(name, 0.0) + dt
        if meta:
            m = self.meta.setdefault(name, {})
            for k, v in meta.items():
                m[k] = m.get(k, 0) + v if isinstance(v, (int, float)) else v

    def qualified(self, name: str) -> str:
        return "/".join(self._prefix + [name])

    def _bump(self, name: str, key: str, n) -> None:
        m = self.meta.setdefault(name, {})
        m[key] = m.get(key, 0) + n

    def _enter(self, qname: str):
        """Open a span: count the entry, reserve its interval's slot and
        make it the innermost open span. Returns what ``_exit`` needs."""
        self._bump(qname, "calls", 1)
        outer = _open.get()
        parent = outer[1] if outer is not None and outer[0] is self else None
        call = _call.get()
        idx = len(self.intervals)
        self.intervals.append(None)
        tok = _open.set((self, idx, qname))
        return (qname, idx, parent,
                call[1] if call is not None and call[0] is self else None,
                tok, time.perf_counter_ns())

    def _exit(self, state) -> float:
        """Close the span ``_enter`` opened; returns its seconds."""
        t1 = time.perf_counter_ns()
        qname, idx, parent, call, tok, t0 = state
        _open.reset(tok)
        self.intervals[idx] = Interval(qname, t0, t1, parent, call)
        return (t1 - t0) / 1e9

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

    def summary(self) -> dict:
        """Each span's seconds, calls and counters, by qualified name."""
        return {name: {"seconds": dt, **self.meta.get(name, {})}
                for name, dt in self.stages.items()}


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


def _no_drain(*_) -> None:
    return None


class _Off:
    """The context manager of every block while no collector is active."""

    __slots__ = ()

    def __enter__(self):
        return _no_drain

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def stage(name: str, **meta):
    """Time a pipeline stage. Yields ``done(outputs)`` — call it with the
    stage's device outputs to sync before the clock stops (only when a
    collector with sync=True is active; otherwise a no-op)."""
    col = _active.get()
    if col is None:
        return _OFF
    return _stage(col, name, meta)


@contextlib.contextmanager
def _stage(col: StageCollector, name: str, meta: dict):
    qname = col.qualified(name)
    state = col._enter(qname)
    try:
        yield (_drain if col.sync else _no_drain)
    finally:
        dt = col._exit(state)
    col.add(qname, dt, **meta)


def scope(name: str):
    """Prefix inner stage names (e.g. coarse/ vs fine/) and record the
    scope's own total under ``name``."""
    col = _active.get()
    if col is None:
        return _OFF
    return _scope(col, name)


@contextlib.contextmanager
def _scope(col: StageCollector, name: str):
    qname = col.qualified(name)
    state = col._enter(qname)
    col._prefix.append(name)
    try:
        yield
    finally:
        col._prefix.pop()
        col.add(qname, col._exit(state))


def count(key: str, n=1) -> None:
    """Add ``n`` to ``key`` in the innermost open span's ``meta`` (nothing
    without a collector or outside every span)."""
    col = _active.get()
    if col is None:
        return
    sp = _open.get()
    if sp is not None and sp[0] is col:
        col._bump(sp[2], key, n)


def call():
    """Mark the block as one registration call: every span inside shares
    the id of the outermost such block (``Interval.call``)."""
    col = _active.get()
    if col is None:
        return _OFF
    c = _call.get()
    if c is not None and c[0] is col:
        return _OFF
    return _new_call(col)


@contextlib.contextmanager
def _new_call(col: StageCollector):
    tok = _call.set((col, col._calls))
    col._calls += 1
    try:
        yield
    finally:
        _call.reset(tok)


def registration_call(fn):
    """Decorator: run ``fn`` as one registration call (``call``)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with call():
            return fn(*args, **kwargs)

    return wrapper


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
