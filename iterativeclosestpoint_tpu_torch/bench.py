"""The port's benchmark, ``icp-torch bench``: ICP points/s on one card
against the faithful C++ octree baseline on its host.

The counterpart of the JAX package's root ``bench.py``, with its
workloads, environment variables and output. The workload is the
reference's own scenario: register a LiDAR-scale synthetic pair perturbed
by a known SE(3) inside the reference's test envelope
(test_icp.cpp:211-215) for a fixed 20 fine iterations (the CLI's
configuration, icp_registration.cpp:901). Throughput = source points ×
iterations / wall seconds. The baseline is the -O3 native octree ICP
(``native/icp_native.cpp`` through ``runtime/native.py``), host code timed
on the card machine's own CPU, so ``vs_baseline`` depends on that host.

Sections, in order, each logging to stderr:

1. the card (name and ``nvidia-smi`` power limit) and the host CPU;
2. ``runtime/smoke.py::kernel_smoke`` (``BENCH_SMOKE``, default 1);
3. the headline: the 1M terrain pair (``BENCH_N``, seed 7) through
   ``icp_register_multiscale`` (coarse level ≤ 30,000 points, 15 coarse
   and ``BENCH_ITERS`` fine iterations at tolerance 0), one warm-up and
   ``BENCH_REPS`` timed runs, the best reported;
4. standalone reports at the registered pose: one fine sweep (K1) on the
   pipeline's own grid and query layout against the card's issue floor,
   and the statistics-and-moments stage against its HBM rate;
5. the stage breakdown of a synced run (the second of two);
6. the volume row (``BENCH_VOLUME``, ``BENCH_VOLUME_N``, deadline
   ``BENCH_VOLUME_DEADLINE_S``): the uniform box, its fine-loop rate and
   the z-column sweep's standalone report;
7. the plane row (``BENCH_PLANE``, deadline ``BENCH_PLANE_DEADLINE_S``):
   the headline with ``estimator="plane"``;
8. the native baseline (``BENCH_BASELINE``) on the first
   ``BENCH_BASELINE_N`` points (default ``BENCH_N``), 20 iterations;
9. parity (``BENCH_PARITY``): the port's f32 brute-force ICP on the card
   against the native pipeline on a mild 50,000-point pair, held to the
   1e-4 m transform-error gate.

The last stdout line is ``bench.py``'s JSON: ``{"metric":
"icp_points_per_sec_per_chip", "value", "unit", "vs_baseline", "rows":
{"terrain", "volume", "plane"}}``. Unlike ``bench.py``, no failure is
hidden: a section that is enabled and fails (an exception, the native
library that cannot be built, a parity error above the gate) makes
``main`` return 1 without the JSON line; a section is skipped only by its
own variable or deadline, and the skip is logged. The variables are read
when ``main`` runs. ``--device cpu`` runs the kernels' plain versions;
their times are CPU times and get no card floor. Standalone::

    python -m iterativeclosestpoint_tpu_torch.bench [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import platform
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

PARITY_GATE_M = 1e-4  # PARITY.md's f32 transform-error gate
PARITY_N = 50_000     # points of the parity pair
SOL_REPS = 20         # launches per standalone timing


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class BenchSettings:
    """The environment ``bench.py`` reads, with its defaults."""

    n: int
    iters: int
    baseline_n: int
    reps: int
    smoke: bool
    volume: bool
    volume_n: int
    volume_deadline_s: float
    plane: bool
    plane_deadline_s: float
    baseline: bool
    parity: bool

    @classmethod
    def from_environ(cls, env=None) -> "BenchSettings":
        env = os.environ if env is None else env
        n = int(env.get("BENCH_N", 1_000_000))
        return cls(
            n=n,
            iters=int(env.get("BENCH_ITERS", 20)),
            baseline_n=int(env.get("BENCH_BASELINE_N", n)),
            reps=int(env.get("BENCH_REPS", 8)),
            smoke=env.get("BENCH_SMOKE", "1") == "1",
            volume=env.get("BENCH_VOLUME", "1") == "1",
            volume_n=int(env.get("BENCH_VOLUME_N", n)),
            volume_deadline_s=float(env.get("BENCH_VOLUME_DEADLINE_S",
                                            2400)),
            plane=env.get("BENCH_PLANE", "1") == "1",
            plane_deadline_s=float(env.get("BENCH_PLANE_DEADLINE_S", 3000)),
            baseline=env.get("BENCH_BASELINE", "1") == "1",
            parity=env.get("BENCH_PARITY", "1") == "1",
        )


class BenchError(RuntimeError):
    """An enabled section that did not give its result."""


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise BenchError(msg)


def host_cpu() -> str:
    """The host CPU the native baseline runs on: ``/proc/cpuinfo``'s model
    name, vendor, family, model number and clock of its first processor
    (a virtual machine may report the name as "unknown"; the family and
    model still name the part), and the core count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not ln.strip():
                    break  # the first processor's block only
                key, _, value = ln.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    usable = (len(os.sched_getaffinity(0))
              if hasattr(os, "sched_getaffinity") else os.cpu_count())
    part = ", ".join(f"{k} {info[k]}" for k in ("cpu family", "model",
                                                 "cpu MHz") if k in info)
    return (f"{info.get('model name', 'model not reported')} "
            f"({info.get('vendor_id', platform.machine())}"
            f"{', ' + part if part else ''}), {os.cpu_count()} cores "
            f"({usable} usable)")


def card_line(dev: torch.device) -> str:
    """The first stderr line: the card, its power limit, the host CPU."""
    cpu = host_cpu()
    if dev.type != "cuda":
        return (f"card: none (--device cpu: the kernels' plain PyTorch "
                f"versions); host CPU: {cpu}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return (f"card: {torch.cuda.get_device_name(index)}; nvidia-smi: {smi}; "
            f"host CPU (the native baseline's): {cpu}")


def _seconds(dev: torch.device, fn):
    """Mean seconds of ``fn()`` over ``SOL_REPS`` back-to-back calls after
    one warm-up, and its last result: CUDA events on the card, the host
    clock on the CPU."""
    reps = SOL_REPS
    out = fn()
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / 1e3 / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps, out


def _wall(dev: torch.device, fn):
    """Host-clock seconds of ``fn()`` from an idle card, and its result."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def _nn_line(dev, n_queries, tile_q, slabs, trange, seconds, name, extra):
    """The sweep's report: against the card's issue floor, or the CPU
    time alone."""
    from iterativeclosestpoint_tpu_torch.runtime.profiling import (
        nn_kernel_report,
    )

    if dev.type == "cuda":
        head = nn_kernel_report(n_queries, tile_q, slabs, trange, seconds,
                                name=name).line()
    else:
        head = (f"{name}: {seconds * 1e3:.4f} ms on the CPU (plain version; "
                "no card floor)")
    return f"{head}  [measured standalone, {extra}]"


def _measure_kernel_sol(src, tgt, dev):
    """Standalone times of the fine loop's two hot stages at the
    registered (steady-state) pose, where the fine loop spends its
    iterations: one fine sweep on the pipeline's own grid (resolution and
    trange by the pipeline's data-adaptive rules) and query layout (the
    factory's ``tile_q`` and ``layout_group``), at the pipeline's fused-form
    gate; then the 3σ statistics and the masked moments as the loop runs
    them. Returns (sweep s, moments s)."""
    from iterativeclosestpoint_tpu_torch.models.icp import (
        icp_register,
        iteration_statistics,
    )
    from iterativeclosestpoint_tpu_torch.ops.cellblock import (
        auto_resolution_data,
    )
    from iterativeclosestpoint_tpu_torch.ops.kabsch import _weighted_moments
    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
        grouped_tile_order_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import colsweep
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
        nn_colsweep,
        sweep_window,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
        auto_trange,
        use_fused_sweep,
    )
    from iterativeclosestpoint_tpu_torch.runtime.profiling import (
        covariance_kernel_report,
    )
    from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset

    offset = center_offset(tgt)
    tgtl = (tgt - offset).astype(np.float32)
    tgt_dev = torch.as_tensor(tgtl, device=dev)
    res = icp_register(src, tgt, dtype=torch.float32, nn_backend="pallas",
                       max_iterations=25, tolerance=1e-7,
                       return_registered=True, device=dev)
    q = torch.as_tensor((res.source_registered - offset).astype(np.float32),
                        device=dev)

    slabs = 4
    R = auto_resolution_data(tgtl, surface_boost_occupancy=32)
    trange = auto_trange(tgtl, R)
    nn_fn, state, R = make_pallas_nn_device(
        tgtl, resolution=R, trange=trange, slabs=slabs, target_dev=tgt_dev)
    grid = state[0]
    rows, weight = grouped_tile_order_device(
        q, grid.origin, grid.cell_size, resolution=R, tile_q=nn_fn.tile_q,
        group=nn_fn.layout_group)
    q_dev = q[rows]
    fused = use_fused_sweep(slabs, trange)
    nn_s, out = _seconds(dev, lambda: nn_colsweep(
        q_dev, grid, resolution=R, tile_q=nn_fn.tile_q, slabs=slabs,
        trange=trange, fused=fused))
    matched, dist, cert = out[0], out[2], out[3]
    certified = float((cert.to(torch.float32) * weight).sum() / weight.sum())
    tiles = q_dev.shape[0] // nn_fn.tile_q
    form = "K1 fused" if fused else "K2 slot-wise"
    log(_nn_line(dev, q_dev.shape[0], nn_fn.tile_q, slabs, trange, nn_s,
                 "nn-slab-sweep",
                 f"nn_colsweep: {form}, R={R}, trange {trange}, {tiles} "
                 f"tiles x {slabs} slots, {certified * 100:.2f}% of real "
                 "rows certified"))
    # The launch alone on the same window: what the sweep's window and
    # certificate arithmetic adds around it is the difference.
    win = sweep_window(q_dev, grid, resolution=R, tile_q=nn_fn.tile_q,
                       slabs=slabs, trange=trange, fused=fused)
    k_s, _ = _seconds(dev, lambda: colsweep(
        win.base, win.q32, grid.tgt_t, slabs=slabs, trange=trange,
        fused=fused, slack=win.slack))
    log(_nn_line(dev, q_dev.shape[0], nn_fn.tile_q, slabs, trange, k_s,
                 "nn-slab-sweep kernel", f"the {form} launch alone"))

    def moments():
        stats = iteration_statistics(dist, weight, 3.0, widen_first=False,
                                     is_first=False)
        return _weighted_moments(q_dev, matched, stats[3])

    mo_s, _ = _seconds(dev, moments)
    if dev.type == "cuda":
        head = covariance_kernel_report(q_dev.shape[0], mo_s).line()
    else:
        head = (f"reject+moments: {mo_s * 1e3:.4f} ms on the CPU "
                "(no card floor)")
    log(f"{head}  [measured standalone: iteration_statistics + the masked "
        f"moments of kabsch_masked over {q_dev.shape[0]} layout rows]")
    return nn_s, mo_s


def _fine_loop_seconds(src, tgt, kwargs, iters, label):
    """The ``fine/loop`` stage's seconds in a synced breakdown (the second
    of two passes), with its stage lines when ``label`` is "breakdown";
    returns (fine-loop seconds, the collector)."""
    from iterativeclosestpoint_tpu_torch.models.multiscale import (
        icp_register_multiscale,
    )
    from iterativeclosestpoint_tpu_torch.runtime.timing import collect

    with collect(sync=True):
        icp_register_multiscale(src, tgt, **kwargs)
    with collect(sync=True) as col:
        icp_register_multiscale(src, tgt, **kwargs)
    fine_loop = col.stages.get("fine/loop")
    _expect(bool(fine_loop), f"{label}: the breakdown has no fine/loop stage")
    log(f"{label}: fine-loop-only rate = "
        f"{len(src) * iters / fine_loop:,.0f} points/s/chip "
        f"({fine_loop / iters * 1e3:.4f} ms/iter synced)")
    return fine_loop, col


def _row(n, iters, seconds, rmse, fine_loop):
    """A row of the JSON line, ``bench.py``'s keys."""
    return {
        "blended_pts_per_s": round(n * iters / seconds),
        "seconds": round(seconds, 3),
        "rmse": round(float(rmse), 5),
        "fine_loop_pts_per_s": round(n * iters / fine_loop),
        "fine_ms_per_iter": round(fine_loop / iters * 1e3, 1),
    }


def _timed_row(src, tgt, kwargs, runs, dev):
    """One warm-up and ``runs`` timed registrations; (best s, all s, the
    last result)."""
    from iterativeclosestpoint_tpu_torch.models.multiscale import (
        icp_register_multiscale,
    )

    res = icp_register_multiscale(src, tgt, **kwargs)  # warm-up
    times = []
    for _ in range(runs):
        dt, res = _wall(dev, lambda: icp_register_multiscale(src, tgt,
                                                             **kwargs))
        times.append(dt)
    return min(times), times, res


def _measure_volume(cfg, kwargs, t_start, dev, rows):
    """The volume row: the same pipeline on a uniform box, where the
    kernel-regime gate picks the z-column sweep; then its standalone
    report. Seed 7: the JAX package's density-table workload."""
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    if time.perf_counter() - t_start > cfg.volume_deadline_s:
        log(f"volume: skipped (past the {cfg.volume_deadline_s:.0f} s "
            "deadline, BENCH_VOLUME_DEADLINE_S)")
        return
    n = cfg.volume_n
    src, tgt, _ = make_registration_pair(
        n=n, seed=7, noise_sigma=0.02, kind="uniform", extent=100.0)
    el, _, res = _timed_row(src, tgt, kwargs, 3, dev)
    _expect(res.final.iterations == cfg.iters,
            f"volume: {res.final.iterations} fine iterations, not "
            f"{cfg.iters}")
    log(f"volume: {el:.4f}s for {cfg.iters} iters of {n} uniform-volume "
        f"pts -> {n * cfg.iters / el:,.0f} points/s/chip (auto kernel; "
        f"rmse={res.final.rmse!r})")
    fl, _ = _fine_loop_seconds(src, tgt, kwargs, cfg.iters, "volume")
    rows["volume"] = _row(n, cfg.iters, el, res.final.rmse, fl)
    _measure_zcol_sol(src, tgt, res, dev)


def _measure_plane(cfg, kwargs, t_start, dev, rows, src, tgt):
    """The plane row: the headline pair and kwargs with
    ``estimator="plane"``, the JAX package's 10M+ production mode."""
    if time.perf_counter() - t_start > cfg.plane_deadline_s:
        log(f"plane: skipped (past the {cfg.plane_deadline_s:.0f} s "
            "deadline, BENCH_PLANE_DEADLINE_S)")
        return
    pkw = dict(kwargs, estimator="plane")
    el, _, res = _timed_row(src, tgt, pkw, 3, dev)
    _expect(res.final.iterations == cfg.iters,
            f"plane: {res.final.iterations} fine iterations, not "
            f"{cfg.iters}")
    log(f"plane: {el:.4f}s for {cfg.iters} iters of {cfg.n} terrain pts "
        f"-> {cfg.n * cfg.iters / el:,.0f} points/s/chip (estimator=plane;"
        f" rmse={res.final.rmse!r})")
    fl, _ = _fine_loop_seconds(src, tgt, pkw, cfg.iters, "plane")
    rows["plane"] = _row(cfg.n, cfg.iters, el, res.final.rmse, fl)


def _measure_zcol_sol(src, tgt, res, dev):
    """Standalone report of the volume regime's z-column sweep (K1 over
    12 z-window slots) at the volume row's registered pose; its certified
    fraction counts real rows only (the (x, y)-group layout pads each
    group with weight-0 replicas)."""
    from iterativeclosestpoint_tpu_torch.ops.cellblock import (
        auto_resolution_data,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
        build_zgrid,
        grouped_tile_order_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import colsweep
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        XY_SLOTS,
        nn_colsweep_z,
        zcol_window,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_params import auto_zrange
    from iterativeclosestpoint_tpu_torch.utils.hostmath import (
        bbox,
        center_offset,
    )

    offset = center_offset(tgt)
    tgtl = (tgt - offset).astype(np.float32)
    tgt_dev = torch.as_tensor(tgtl, device=dev)
    T = res.final.transform
    q = torch.as_tensor(
        ((src @ T[:3, :3].T + T[:3, 3]) - offset).astype(np.float32),
        device=dev)
    R = auto_resolution_data(tgtl)
    zr = auto_zrange(tgtl, R)
    lo3, hi3 = bbox(tgtl)
    cell3 = np.maximum((hi3 - lo3) / R, 1e-9).astype(np.float32)
    grid = build_zgrid(
        tgt_dev, torch.as_tensor(lo3, dtype=torch.float32, device=dev),
        torch.as_tensor(cell3, device=dev), resolution=R, zrange=zr)
    rows, weight = grouped_tile_order_device(
        q, grid.origin, grid.cell_size, resolution=R, group="xy")
    q_dev = q[rows]
    dt, out = _seconds(dev, lambda: nn_colsweep_z(q_dev, grid, resolution=R,
                                                  zrange=zr))
    cert = float((out[3].to(torch.float32) * weight).sum() / weight.sum())
    fused = XY_SLOTS * zr <= 24576  # nn_colsweep_z's gate
    form = "K1 fused" if fused else "K2 slot-wise"
    log(_nn_line(dev, q_dev.shape[0], 128, XY_SLOTS, zr, dt, "nn-zcol",
                 f"nn_colsweep_z: {form}, R={R}, zrange {zr}, "
                 f"{q_dev.shape[0] // 128} tiles x {XY_SLOTS} slots, "
                 f"{cert * 100:.2f}% of real rows certified"))
    win = zcol_window(q_dev, grid, resolution=R, tile_q=128, zrange=zr,
                      fused=fused)
    k_s, _ = _seconds(dev, lambda: colsweep(
        win.base, win.q32, grid.tgt_t, slabs=XY_SLOTS, trange=zr,
        fused=fused, slack=win.slack))
    log(_nn_line(dev, q_dev.shape[0], 128, XY_SLOTS, zr, k_s,
                 "nn-zcol kernel", f"the {form} launch alone"))


def _native():
    """The native module, or BenchError with the build's output."""
    from iterativeclosestpoint_tpu_torch.runtime import native

    if not native.native_available():
        raise BenchError("the native octree library (native/icp_native.cpp)"
                         " cannot be built or loaded:\n"
                         + native.native_failure())
    return native


def _baseline(cfg, src, tgt, pps):
    """The native octree ICP on the first ``BENCH_BASELINE_N`` points,
    ``BENCH_ITERS`` iterations at tolerance 0, on this host's CPU;
    returns the port's points/s over the baseline's."""
    native = _native()
    bn = cfg.baseline_n
    t0 = time.perf_counter()
    _, _, iters, _, _ = native.octree_icp_baseline(
        src[:bn], tgt[:bn], max_iterations=cfg.iters, tolerance=0.0)
    el = time.perf_counter() - t0
    cpu_pps = bn * iters / el
    vs = pps / cpu_pps
    note = ("" if bn == cfg.n else
            f"; the port's rate is at {cfg.n} points, not {bn}")
    log(f"baseline: {el:.3f}s for {iters} iters of {bn} pts on "
        f"{host_cpu()} -> {cpu_pps:,.0f} points/s -> speedup {vs:.1f}x"
        f"{note}")
    return vs


def parity_pair():
    """The parity pair (``bench.py``'s): the target
    ``make_cloud(PARITY_N, seed=3)``, the source under the inverse of a
    mild transform (0.3 m, 2°: inside both engines' convergence basin;
    terrain locks all six DoF) plus N(0, 0.01) noise from
    ``default_rng(4)``."""
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        apply_transform_np,
        make_cloud,
        random_rigid_transform,
    )

    tgt = make_cloud(PARITY_N, seed=3)
    T_mild = random_rigid_transform(seed=3, max_yaw_deg=2.0,
                                    max_pitch_roll_deg=1.0, max_txy=0.3,
                                    max_tz=0.2)
    src = apply_transform_np(np.linalg.inv(T_mild), tgt) + \
        np.random.default_rng(4).normal(0, 0.01, tgt.shape)
    return src, tgt


def _parity(dev):
    """The parity pair through both engines from identical inputs: the
    port's f32 brute force (K3 on the card) and the native octree
    pipeline; the transform error (the port's ``registration_error`` in
    f64 over the source) must stay under the 1e-4 m gate."""
    from iterativeclosestpoint_tpu_torch.models.icp import icp_register
    from iterativeclosestpoint_tpu_torch.ops.se3 import registration_error

    native = _native()
    psrc, ptgt = parity_pair()
    ours = icp_register(psrc, ptgt, dtype=torch.float32,
                        nn_backend="bruteforce", max_iterations=50,
                        tolerance=1e-6, return_registered=False, device=dev)
    log(f"parity: ours iters={ours.iterations} rmse={ours.rmse:.6f} "
        f"({ours.message}) on {dev.type}")
    T_ref, hist, it_ref, _, _ = native.octree_icp_baseline(
        psrc, ptgt, max_iterations=50, tolerance=1e-6)
    err = float(registration_error(
        torch.as_tensor(ours.transform, dtype=torch.float64),
        torch.as_tensor(T_ref, dtype=torch.float64),
        torch.as_tensor(psrc, dtype=torch.float64)))
    passed = err < PARITY_GATE_M
    log(f"parity: reference iters={it_ref} "
        f"rmse={hist[-1] if len(hist) else 0:.6f}; transform error vs "
        f"reference = {err:.3e} m ({'PASS' if passed else 'FAIL'} "
        f"{PARITY_GATE_M:g} gate)")
    _expect(passed, f"parity: transform error {err:.3e} m is above the "
                    f"{PARITY_GATE_M:g} m gate")


def run(cfg: BenchSettings, dev: torch.device) -> dict:
    """Every enabled section, in order; returns the JSON line's object."""
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    t_start = time.perf_counter()
    log(card_line(dev))
    launches0 = collections.Counter(sk.LAUNCH_SHAPES)

    # The cheap single-shape exactness check first, so a kernel fault
    # shows before the long rows.
    if cfg.smoke:
        from iterativeclosestpoint_tpu_torch.runtime.smoke import (
            kernel_smoke,
        )

        for k, dt in kernel_smoke(device=dev).items():
            log(f"smoke[{k}]: kernel exact vs brute force OK on {dev.type} "
                f"({dt * 1e3:.1f} ms)")
    else:
        log("smoke: skipped (BENCH_SMOKE=0)")

    src, tgt, _ = make_registration_pair(
        n=cfg.n, seed=7, noise_sigma=0.02, kind="terrain", extent=100.0)
    # Coarse-to-fine: a stride-subsampled coarse pass absorbs the bulk
    # misalignment, then ITERS full-resolution iterations.
    kwargs = dict(
        coarse_max_points=30_000,
        coarse_iterations=15,
        max_iterations=cfg.iters,
        tolerance=0.0,  # a fixed fine iteration count for stable timing
        dtype=torch.float32,
        nn_backend="pallas",
        return_registered=False,
        device=dev,
    )
    log("warmup...")
    elapsed, times, res = _timed_row(src, tgt, kwargs, cfg.reps, dev)
    _expect(res.final.iterations == cfg.iters,
            f"terrain: {res.final.iterations} fine iterations, not "
            f"{cfg.iters}")
    pps = cfg.n * cfg.iters / elapsed
    log(f"{dev.type} runs: " + ", ".join(f"{t:.4f}s" for t in times))

    _measure_kernel_sol(src, tgt, dev)
    log(f"terrain: {elapsed:.4f}s for {cfg.iters} iters of {cfg.n} pts -> "
        f"{pps:,.0f} points/s/chip ({elapsed / cfg.iters * 1e3:.2f} "
        f"ms/iteration full pipeline; rmse={res.final.rmse!r}, fine "
        f"iterations {res.final.iterations})")

    # The synced breakdown: stages that overlap serialise here, so its
    # total bounds the blended wall from above, with every fixed cost
    # attributed.
    fine_loop, col = _fine_loop_seconds(src, tgt, kwargs, cfg.iters,
                                        "breakdown")
    for line in col.lines():
        log(f"breakdown: {line}")
    synced_total = sum(v for k, v in col.stages.items() if "/" not in k)
    log(f"breakdown: synced total {synced_total:.4f}s (blended "
        f"{elapsed:.4f}s; overlap hides "
        f"{max(synced_total - elapsed, 0):.4f}s)")
    rows = {"terrain": _row(cfg.n, cfg.iters, elapsed, res.final.rmse,
                            fine_loop)}

    if cfg.volume:
        _measure_volume(cfg, kwargs, t_start, dev, rows)
    else:
        log("volume: skipped (BENCH_VOLUME=0)")
    if cfg.plane:
        _measure_plane(cfg, kwargs, t_start, dev, rows, src, tgt)
    else:
        log("plane: skipped (BENCH_PLANE=0)")

    vs_baseline = None
    if cfg.baseline:
        vs_baseline = _baseline(cfg, src, tgt, pps)
    else:
        log("baseline: skipped (BENCH_BASELINE=0)")
    if cfg.parity:
        _parity(dev)
    else:
        log("parity: skipped (BENCH_PARITY=0)")

    # The CUDA kernels' launches over every section (none on the CPU),
    # as JSON: by kernel, and by kernel and launch shape.
    shapes = collections.Counter(sk.LAUNCH_SHAPES) - launches0
    by_kernel = {k: sum(c for (nm, _), c in shapes.items() if nm == k)
                 for k in sk.LAUNCHES}
    log(f"launches: {json.dumps(by_kernel)}")
    log("launch shapes: " + json.dumps(
        [[nm, list(sh), c] for (nm, sh), c in sorted(shapes.items())]))
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    return {
        "metric": "icp_points_per_sec_per_chip",
        "value": round(pps),
        "unit": "points/s/chip",
        "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
        "rows": rows,
    }


def main(argv=None) -> int:
    """Run the benchmark; prints the JSON line last on stdout and returns
    0, or returns 1 with the failure on stderr and no JSON line."""
    from iterativeclosestpoint_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(prog="icp-torch bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the card, the default) or cpu (the plain "
                        "versions)")
    args = p.parse_args(argv)
    cfg = BenchSettings.from_environ()
    try:
        dev = resolve_device(args.device)
        line = run(cfg, dev)
    except Exception as e:  # the command's boundary: report, exit non-zero
        log(traceback.format_exc())
        log(f"bench failed: {type(e).__name__}: {e}")
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
