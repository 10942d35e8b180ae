"""The card's idle share over the profiled window: 100 (1 - the union of
the device operations' intervals / the window)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
