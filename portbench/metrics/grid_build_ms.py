"""Grid build per registration (``ops/sweep_grid.py``, with
``ops/normals.py`` inside in plane mode), from the synced stage
``grid_build``."""


def read(ctx):
    if not ctx["synced"] or "grid_build" not in ctx["stages"]:
        return None
    return ctx["stages"]["grid_build"] / ctx["synced"] * 1e3
