"""The metric arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """All the work of the window over all its time."""
    return work / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between the
    closest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

