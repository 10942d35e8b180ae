"""Host waits at the fine loop's reads per iteration: the synced seconds
of the spans ``fine/read/*`` over the fine iterations run. They are the
repair chain's gate reads (``ops/sweep_nn.py::nn_colsweep_exact``), the
loop's stop code (``models/icp.py::icp_core``) and every other call the
card reports as synchronising; none of these spans syncs itself, so a
read waits for the device work queued before it."""


def read(ctx):
    waits = [s for k, s in ctx["stages"].items() if k.startswith("fine/read/")]
    if not ctx["fine_iterations"] or not waits:
        return None
    return sum(waits) / ctx["fine_iterations"] * 1e3
