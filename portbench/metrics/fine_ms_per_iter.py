"""Fine loop per iteration (``models/icp.py::icp_core``,
``models/multiscale.py::_run_fine``), from the synced stage
``fine/loop`` over the fine iterations run."""


def read(ctx):
    if not ctx["fine_iterations"] or "fine/loop" not in ctx["stages"]:
        return None
    return ctx["stages"]["fine/loop"] / ctx["fine_iterations"] * 1e3
