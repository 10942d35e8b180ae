"""Reading a ``torch.profiler`` trace of the traced window.

The device operations (kernels, copies, sets) are intervals on the
profiler's clock. The host's spans are taken on ``time.perf_counter``; a
marker operation launched on an idle card at a known ``perf_counter``
time puts both on one clock, to within its launch latency (microseconds).
From them: the seconds in which some operation ran on the device (the
union of the intervals), the operations that took most time by name, and
the idle gaps labelled by the innermost host span they fall in.
"""

from __future__ import annotations

import collections
import contextlib
import time

MARK = "portbench.mark"
NAME_CHARS = 100  # kernel names are long template signatures


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """``ops``: (name, start_ns, end_ns) of each device operation;
    ``window``: (start_ns, end_ns) of the traced window; ``spans``: (name,
    start_ns, end_ns) of the host's spans; all on one clock."""

    def __init__(self, ops, window, spans=()):
        a, b = window
        self.window = (a, b)
        self.ops = [(n, max(s, a), min(e, b)) for n, s, e in ops
                    if e > a and s < b]
        self.spans = list(spans)
        self.busy = _merge([(s, e) for _, s, e in self.ops])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def seconds_of(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        tot = collections.Counter()
        for n, s, e in self.ops:
            tot[n[:NAME_CHARS]] += (e - s) / 1e9
        return [[n, t] for n, t in tot.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle seconds summed by the innermost host span at each gap's
        middle ("host outside any stage" where none holds it)."""
        edges = [self.window[0]]
        for s, e in self.busy:
            edges += [s, e]
        edges.append(self.window[1])
        tot = collections.Counter()
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inside = [(e - s, n) for n, s, e in self.spans if s <= mid <= e]
            label = min(inside)[1] if inside else "host outside any stage"
            tot[label] += (b - a) / 1e9
        return [[n, t] for n, t in tot.most_common(k)]


def clock_offset(ops, t_mark_ns: int) -> int:
    """The profiler's clock less ``perf_counter``'s, from the marker: the
    first device operation of the trace, launched on an idle card at
    ``perf_counter`` time ``t_mark_ns``."""
    if not ops:
        raise RuntimeError("the profiler recorded no device operation")
    return min(s for _, s, _ in ops) - t_mark_ns


@contextlib.contextmanager
def profiled():
    """``torch.profiler`` over the block, the card's activity only (no host
    operators, shapes or stacks, which slow the host). Yields a dict that
    holds, after the block, the device operations and the offset from
    ``perf_counter`` nanoseconds to the profiler's clock; without a card,
    no operations and no profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {"ops": [], "offset_ns": 0}
    if not torch.cuda.is_available():
        yield out
        return
    mark = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_mark = time.perf_counter_ns()
        mark.fill_(0.0)  # the marker: the card is idle until it runs
        torch.cuda.synchronize()
        yield out
    events = prof.profiler.kineto_results.events()
    out["ops"] = [(e.name(), e.start_ns(), e.end_ns()) for e in events
                  if e.device_type() != torch.autograd.DeviceType.CPU]
    out["offset_ns"] = clock_offset(out["ops"], t_mark)
