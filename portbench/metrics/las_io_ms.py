"""LAS I/O a call of ``icp-torch run``: the session's synced stages
``load_source`` + ``load_target`` (the two files read and decoded),
``write_las`` (the registered cloud encoded and written) and ``report``
(the transform report and its ``.json``), ``runtime/session.py``, in ms
a call."""

STAGES = ("load_source", "load_target", "write_las", "report")


def read(ctx):
    if not ctx["synced"] or not all(s in ctx["stages"] for s in STAGES):
        return None
    return sum(ctx["stages"][s] for s in STAGES) / ctx["synced"] * 1e3
