"""How far the profiler stretches the registrations that the device
metrics are read over: 100 (the median wall of the profiled registrations
/ the median wall of as many run next with neither profiler nor spans -
1), in percent. ``device_idle_share`` counts the stretch as idle."""

import statistics


def read(ctx):
    prof = [r["seconds"] for r in ctx["profiled"]]
    plain = [r["seconds"] for r in ctx.get("unprofiled", [])]
    if not prof or not plain or ctx["trace"] is None:
        return None
    return 100.0 * (statistics.median(prof) / statistics.median(plain) - 1.0)
