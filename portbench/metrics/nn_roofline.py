"""The nearest-neighbour kernels' share of their roofline, bound by bytes.

An exact 1-NN search has no operation count that does not depend on how
it is done, so the least time is that of its bytes: at every iteration of
every level, each query read once (12 B) and each target row read once
(12 B; 24 B with its normal on the plane fine level), and each query's
index and distance written once (8 B; 20 B with the returned normal). The
level sizes come from the configuration and the frozen subsampling rule,
the iterations from what each profiled registration ran. Over the H100's
published 3.35 TB/s (``peaks.py``), divided by the device time of the
kernels found by name in the trace (K1 ``colsweep_fused_kernel``, K2
``colsweep_kernel`` and its merge, K3 ``brute_nn_kernel``), in percent.
"""

from portbench.peaks import H100_HBM_BYTES_PER_S
from portbench.reference.icp_ref import level_strides

KERNELS = ("colsweep", "brute_nn")


def nn_bytes(settings, levels_run) -> float:
    """Least bytes of the searches of one registration; ``levels_run`` is
    [(stride, iterations)] as it ran."""
    n = settings["n_points"]
    strides = level_strides(n, settings["coarse_max_points"])
    total = 0.0
    for li, (stride, iters) in enumerate(levels_run):
        rows = -(-n // strides[li])
        plane = li == len(strides) - 1 and settings["estimator"] == "plane"
        total += iters * rows * (12 + (24 if plane else 12)
                                 + (20 if plane else 8))
    return total


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    kernel_s = tr.seconds_of(lambda name: any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    nbytes = sum(nn_bytes(ctx["settings"],
                          [(lv["stride"], lv["iterations"])
                           for lv in r["levels"]])
                 for r in ctx["profiled"])
    return 100.0 * nbytes / H100_HBM_BYTES_PER_S / kernel_s
