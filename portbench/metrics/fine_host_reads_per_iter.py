"""Host reads per fine iteration: the spans ``fine/read/*`` that the
profiled registrations entered, over their fine iterations. A count, so
the profiler does not change it."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    reads = sum(1 for name, _, _ in tr.spans if name.startswith("fine/read/"))
    iters = sum(r["levels"][-1]["iterations"] for r in ctx["profiled"])
    if not reads or not iters:
        return None
    return reads / iters
