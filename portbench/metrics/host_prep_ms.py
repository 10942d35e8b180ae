"""Host prep per registration: the fine level's centring and f32 cast,
upload and grid estimate (``models/multiscale.py::_prepare_fine``,
``ops/sweep_params.py``), from the synced stages."""

STAGES = ("host_prep", "upload", "grid_est")


def read(ctx):
    if not ctx["synced"] or not all(s in ctx["stages"] for s in STAGES):
        return None
    return sum(ctx["stages"][s] for s in STAGES) / ctx["synced"] * 1e3
