"""The sweeps' window arithmetic per fine iteration
(``ops/sweep_nn.py::sweep_window`` and ``zcol_window``, the repair
chain's coarse windows included): the synced span ``fine/nn/window``
over the fine iterations run."""


def read(ctx):
    if not ctx["fine_iterations"] or "fine/nn/window" not in ctx["stages"]:
        return None
    return ctx["stages"]["fine/nn/window"] / ctx["fine_iterations"] * 1e3
