"""Readings that the limits of ``correct`` are set from.

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3]

For each seed: the cell's pool, each pair registered once by the program
through the cell's own entry and settings, then ``check.compare`` over
those registrations: the program's readings (the lower ones) and, for the
control seeds, the bfloat16 control's at the same poses (the upper ones).
One JSON line per seed and side on stdout. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.run import ENTRIES, ROOT, cache_dirs, load_cell, log


def readings(root, workload: str, seeds, control_seeds, device="cuda"):
    """Yields (seed, side, readings) for each seed and side."""
    from portbench import check, synth

    spec = load_cell(root, workload)
    settings, traffic = spec["settings"], spec["traffic"]
    register = ENTRIES[traffic["entry"]](settings, device)
    for seed in seeds:
        pool = synth.make_pool(settings["n_points"], seed, traffic)
        regs = [{"index": i, "pair": i, "levels": register(pair)}
                for i, pair in enumerate(pool)]
        yield seed, "program", check.compare(pool, regs, settings,
                                             traffic["check"], seed)
        if seed in control_seeds:
            yield seed, "control", check.compare(
                pool, regs, settings, traffic["check"], seed, control=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    for seed, side, r in readings(ROOT, args.workload, args.seeds,
                                  set(args.control_seeds), args.device):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side, **r}), flush=True)
        log(f"{side} seed {seed}: {r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
