"""LAS bytes read and written over the seconds of the ``las/*`` spans
(``io/las.py``: ``las/read/file``, ``las/read/decode``,
``las/write/encode``, ``las/write/file``) of the synced calls, in MB/s:
the counters ``las_bytes`` of the file spans over the four spans' synced
seconds. A program without those spans gives nothing to read."""


def read(ctx):
    names = [k for k in ctx["stages"] if k.startswith("las/")]
    seconds = sum(ctx["stages"][k] for k in names)
    nbytes = sum(ctx["meta"].get(k, {}).get("las_bytes", 0) for k in names)
    if seconds <= 0 or not nbytes:
        return None
    return nbytes / seconds / 1e6
