"""Command-line surface of the PyTorch/CUDA port: ``icp-torch``.

The twin of the JAX package's ``icp`` (``cli.py``), with the same verbs,
flags and files, run on one NVIDIA card (``--device cuda``, the default)
or on the CPU's plain versions (``--device cpu``). Without CUDA the card
is not quietly replaced by the CPU: the command exits non-zero. Covers the
reference's product surface (SURVEY.md §2, C9-C16):

  run       — the console pipeline (icp_registration.cpp:817-949): read two
              LAS files, optional stride downsample, ICP, save registered
              LAS + transform report with per-iteration history.
  synth     — the test-data generator (test_icp.cpp:191-291): known random
              SE(3) perturbation within the reference envelope, plus
              noise/outlier/overlap options.
  info      — cloud bounds/count display (datamanagerpage.cpp:207-242).
  replay    — iteration replay export (visualizationpage + viewer,
              pointcloudviewer.cpp:86-116): apply iteration k's recorded
              cumulative transform to the original source.
  status    — run-history dashboard (dashboardpage.cpp:150-173).
  settings  — config show/edit with validated ranges (settingspage.cpp).
  smoke     — the kernels' exact chains against brute force.
  graph     — multi-scan joint registration: pairwise ICP edges (chain,
              overlap-detected, loop closure) and a pose-graph solve;
              merged LAS in scan 0's frame, pose JSON, scene viewer.
  bench     — the benchmark (``bench.py``): headline, volume and plane
              rows, kernel reports, the native octree baseline on this
              host's CPU and the parity check; one JSON line last.

``run``/``graph --parallel dp|partition`` run over a mesh of one rank per
visible card (``parallel/``; on ``--device cpu`` one CPU rank). The ranks
are threads of this process, and their host work contends for the
interpreter: on four H100 cards ``--parallel dp`` ran the 1M fine loop
~19x and ``partition`` the 10M one ~5x slower than one card (PERF.md §5),
so ``--parallel none`` is the faster choice wherever one card holds the
clouds. ``run --parallel partition --ingest`` streams both LAS files
(``parallel/ingest.py``) for clouds beyond the host's memory, over the
same mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np


def _print(msg: str) -> None:
    print(msg, flush=True)


def _device_or_exit(args):
    """The run's device, or None after printing why the card is missing
    (``resolve_device`` raises rather than fall back to the CPU)."""
    from iterativeclosestpoint_tpu_torch.utils.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        _print(f"icp-torch: {e}")
        return None


def _run_partition_ingest(args, cfg, dev) -> int:
    """``run --parallel partition --ingest``: the streamed registration
    for clouds beyond the host's memory. One strided sample pass per file
    gives the slab walls, the per-slab grid parameters and a coarse pose
    (``coarse_carry_from_files``, the reference's stride-downsample
    coarse workflow, icp_registration.cpp:852-882); both files then
    stream through bounded batches, each rank keeping its slab
    (``parallel/ingest.py``), and the partitioned run starts from the
    coarse pose (or ``--resume``'s carry). Writes the transform report,
    history, metrics and checkpoint, not a registered cloud."""
    from iterativeclosestpoint_tpu_torch.io.las import read_header
    from iterativeclosestpoint_tpu_torch.parallel.ingest import (
        coarse_carry_from_files,
        estimate_partition_grid_params,
        header_center,
        load_las_partitioned_source,
        load_las_partitioned_target,
        sample_points,
    )
    from iterativeclosestpoint_tpu_torch.parallel.mesh import make_mesh
    from iterativeclosestpoint_tpu_torch.parallel.partition import (
        icp_register_partitioned,
    )
    from iterativeclosestpoint_tpu_torch.runtime.checkpoint import (
        save_checkpoint,
    )
    from iterativeclosestpoint_tpu_torch.runtime.metrics import (
        MetricsWriter,
        write_history_json,
        write_transform_report,
    )

    # Options the streamed path cannot honour fail loudly (the session
    # path handles them; --ingest bypasses it).
    bad = [flag for val, flag in (
        (args.voxel, "--voxel"), (args.multiscale, "--multiscale"),
        (args.live_every, "--live-every"), (args.output, "-o/--output"))
        if val]
    if bad:
        _print(f"--ingest does not support {', '.join(bad)} (the streamed "
               "wall-sharded run produces the transform and history, not "
               "a registered cloud; downsample with --stride)")
        return 1

    t0 = time.perf_counter()
    mesh = make_mesh(device=dev)
    hdr_t = read_header(args.target)
    hdr_s = read_header(args.source)
    offset = header_center(hdr_t)
    ext = float(np.max(np.asarray(hdr_t.bounds_max, np.float64)
                       - np.asarray(hdr_t.bounds_min, np.float64)))
    halo = 0.02 * ext
    _print(f"ingest-partitioned: {mesh.size}-rank mesh, "
           f"{hdr_s.point_count} source / {hdr_t.point_count} target pts, "
           f"halo {halo:.3f} m"
           + (f", stride {args.stride}" if args.stride > 1 else ""))

    # One strided pass per file feeds the walls, the grid parameters and
    # the coarse pose.
    s_tgt, _ = sample_points(args.target, header=hdr_t)
    s_src, _ = sample_points(args.source, header=hdr_s)
    walls = np.quantile(s_tgt[:, 0], np.linspace(0, 1, mesh.size + 1))
    walls[0], walls[-1] = -np.inf, np.inf
    if args.resume:
        from iterativeclosestpoint_tpu_torch.runtime.checkpoint import (
            load_checkpoint,
            resume_arguments,
        )

        ckpt = load_checkpoint(args.resume)
        patch = resume_arguments(ckpt, cfg.max_iterations)
        cfg.max_iterations = patch["max_iterations"]
        carry = patch.get("resume_carry") or {
            "transform": np.asarray(ckpt["transform"]),
            "prev_error": 1e10, "no_improve": 0}
        _print(f"resuming from iteration {ckpt['iteration']}")
    else:
        # Plane mode whatever the fine estimator (coarse_carry_from_files
        # says why).
        carry = coarse_carry_from_files(
            args.source, args.target, mode=cfg.mode,
            tolerance=max(min(cfg.tolerance, 1e-5), 1e-9),
            samples=(s_src, s_tgt), device=dev)
        _print(f"coarse sample alignment done "
               f"({time.perf_counter() - t0:.2f}s)")
    gp = estimate_partition_grid_params(
        args.target, walls, halo, header=hdr_t,
        grid_resolution=(cfg.grid_resolution or None),
        n_queries_hint=hdr_s.point_count, sample=s_tgt)
    _print(f"sampled grid params: {gp}")
    del s_src, s_tgt
    tstats, sstats = {}, {}
    part, walls = load_las_partitioned_target(
        args.target, mesh, halo=halo, offset=offset, walls=walls,
        stride=args.stride, stats=tstats)
    src_g = load_las_partitioned_source(
        args.source, mesh, walls=walls, offset=offset, stride=args.stride,
        stats=sstats)
    _print(f"streamed ingest done ({time.perf_counter() - t0:.2f}s; "
           f"this process retained {tstats['retained_rows']} target / "
           f"{sstats['retained_rows']} source rows)")

    res = icp_register_partitioned(
        None, None, mesh=mesh, partition_state=part, source_global=src_g,
        offset=offset, grid_params=gp, resume_carry=carry,
        max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
        sigma_multiplier=cfg.sigma_multiplier, mode=cfg.mode,
        estimator=cfg.estimator, robust=cfg.robust, return_registered=False)
    _print("========== registration finished ==========")
    _print(f"iterations: {res.iterations}  final RMSE: {res.rmse:.6f}  "
           f"({res.message}, {time.perf_counter() - t0:.2f}s)")
    if args.metrics:
        mw = MetricsWriter(jsonl_path=args.metrics, console=False)
        for rec in res.iteration_records():
            mw.iteration(rec, cfg.max_iterations)
        mw.event("run", success=res.success, rmse=float(res.rmse),
                 iterations=res.iterations, message=res.message)
        mw.close()
        _print(f"metrics written to {args.metrics}")
    if args.report:
        write_transform_report(args.report, res)
        write_history_json(str(Path(args.report).with_suffix(".json")), res)
        _print(f"transform report written to {args.report}")
    if args.checkpoint:
        save_checkpoint(
            args.checkpoint, iteration=res.iterations,
            transform=res.transform, rmse_history=res.history_rmse,
            prev_error=res.carry_prev_error,
            no_improve=res.carry_no_improve,
            transform_local=res.carry_transform_local,
            center_offset=res.center_offset,
            source_path=args.source, target_path=args.target)
        _print(f"checkpoint written to {args.checkpoint}")
    if args.history:
        _append_history(args.history, {
            "timestamp": time.time(),
            "source_points": hdr_s.point_count,
            "target_points": hdr_t.point_count,
            "iterations": res.iterations, "rmse": float(res.rmse),
            "duration_s": time.perf_counter() - t0,
            "message": res.message, "success": res.success,
        })
    return 0 if res.success else 1


def cmd_run(args) -> int:
    from iterativeclosestpoint_tpu_torch.runtime.metrics import MetricsWriter
    from iterativeclosestpoint_tpu_torch.runtime.session import (
        RegistrationSession,
    )
    from iterativeclosestpoint_tpu_torch.utils.config import AppSettings

    settings = AppSettings.load(args.settings) if args.settings else AppSettings()
    cfg = settings.icp
    for field in ("max_iterations", "tolerance", "sigma_multiplier", "mode",
                  "nn_backend", "estimator", "robust", "grid_resolution",
                  "cell_capacity"):
        v = getattr(args, field, None)
        if v is not None:
            setattr(cfg, field, v)

    if args.ingest and args.parallel != "partition":
        _print("--ingest requires --parallel partition")
        return 1
    dev = _device_or_exit(args)
    if dev is None:
        return 1
    if args.ingest:
        return _run_partition_ingest(args, cfg, dev)

    metrics = MetricsWriter(jsonl_path=args.metrics, console=True,
                            stream=sys.stdout)
    sess = RegistrationSession(settings=settings, metrics=metrics,
                               device=dev)
    sess.load_source(args.source, stride=args.stride)
    sess.load_target(args.target, stride=args.stride)
    if args.voxel:
        from iterativeclosestpoint_tpu_torch.ops.downsample import (
            downsample_voxel_stride,
        )

        sess.set_clouds(
            downsample_voxel_stride(sess.source, args.voxel),
            downsample_voxel_stride(sess.target, args.voxel),
        )
        _print(f"voxel downsample {args.voxel} m -> "
               f"{len(sess.source)} / {len(sess.target)} points")

    initial = None
    run_extra = {}
    if args.resume:
        from iterativeclosestpoint_tpu_torch.runtime.checkpoint import (
            load_checkpoint,
            resume_arguments,
        )

        ckpt = load_checkpoint(args.resume)
        patch = resume_arguments(ckpt, cfg.max_iterations)
        cfg.max_iterations = patch["max_iterations"]
        run_extra["iteration_base"] = ckpt["iteration"]
        if "resume_carry" in patch and not args.multiscale:
            # Full convergence carry: continues bit-identically.
            run_extra["resume_carry"] = patch["resume_carry"]
            _print(f"resuming from iteration {ckpt['iteration']} "
                   "(exact convergence carry)")
        else:
            # Legacy / multiscale resume: exact pose, reset counters.
            initial = ckpt["transform"]
            _print(f"resuming from iteration {ckpt['iteration']}")

    from iterativeclosestpoint_tpu_torch.runtime.profiling import trace

    with trace(args.profile):
        res = sess.run(
            config=cfg,
            multiscale=args.multiscale,
            checkpoint_path=args.checkpoint,
            initial_transform=initial,
            live_every=args.live_every,
            # Mid-run viewer exports (segment-boundary refresh) when both
            # --live-every and --html are given.
            live_html=(args.html if args.live_every else None),
            parallel=args.parallel,
            **run_extra,
        )

    if args.output:
        sess.save_result(args.output, rebase=args.rebase)
        _print(f"registered cloud written to {args.output}")
    report_txt = args.report or (
        str(Path(args.output).with_suffix("")) + "_transform.txt"
        if args.output else None
    )
    if report_txt:
        sess.save_report(
            txt_path=report_txt,
            json_path=str(Path(report_txt).with_suffix(".json")),
        )
        _print(f"transform report written to {report_txt}")
    if args.history:
        _append_history(args.history, sess.history[-1])
    if args.html:
        sess.export_html(args.html)
        _print(f"interactive viewer written to {args.html}")
    return 0 if res.success else 1


def cmd_synth(args) -> int:
    from iterativeclosestpoint_tpu_torch.io.las import write_las
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    src, tgt, T = make_registration_pair(
        n=args.n, seed=args.seed, noise_sigma=args.noise,
        outlier_frac=args.outliers, overlap_frac=args.overlap, kind=args.kind,
    )
    write_las(args.source_out, src)
    write_las(args.target_out, tgt)
    _print(f"wrote {args.source_out} ({len(src)} pts), "
           f"{args.target_out} ({len(tgt)} pts)")
    _print("ground-truth transform (P_target = R * P_source + t):")
    for r in range(4):
        _print("  [" + ", ".join(f"{T[r, c]: .8f}" for c in range(4)) + "]")
    if args.transform_out:
        Path(args.transform_out).write_text(json.dumps(T.tolist(), indent=1))
    return 0


def cmd_info(args) -> int:
    from iterativeclosestpoint_tpu_torch.io.las import read_header, read_las

    hdr = read_header(args.file)
    _print(f"file:           {args.file}")
    _print(f"LAS version:    {hdr.version[0]}.{hdr.version[1]}")
    _print(f"point format:   {hdr.point_format} "
           f"(record length {hdr.point_record_length})")
    _print(f"points:         {hdr.point_count}")
    _print(f"scale:          {hdr.scale}")
    _print(f"offset:         {hdr.offset}")
    if args.full:
        pts, _ = read_las(args.file)
        _print(f"bounds X: [{pts[:,0].min():.3f}, {pts[:,0].max():.3f}]")
        _print(f"bounds Y: [{pts[:,1].min():.3f}, {pts[:,1].max():.3f}]")
        _print(f"bounds Z: [{pts[:,2].min():.3f}, {pts[:,2].max():.3f}]")
    else:
        _print(f"bounds min:     {hdr.bounds_min}")
        _print(f"bounds max:     {hdr.bounds_max}")
    return 0


def cmd_replay(args) -> int:
    from iterativeclosestpoint_tpu_torch.io.las import read_las, write_las
    from iterativeclosestpoint_tpu_torch.runtime.metrics import (
        read_history_json,
    )

    pts, hdr = read_las(args.source)
    hist = read_history_json(args.history)
    k = args.iteration
    if k < 0:
        k = hist["iterations"]
    if k == 0:
        out = pts
    else:
        k = min(k, hist["iterations"])
        T = hist["history"][k - 1]["transform"]
        out = pts @ T[:3, :3].T + T[:3, 3]
    write_las(args.output, out, scale=hdr.scale, offset=hdr.offset)
    _print(f"iteration {k} cloud written to {args.output}")
    return 0


def cmd_view(args) -> int:
    from iterativeclosestpoint_tpu_torch.io.las import read_las
    from iterativeclosestpoint_tpu_torch.runtime.viz import (
        render_registration_png,
    )

    src, _ = read_las(args.source)
    tgt, _ = read_las(args.target)
    rmse = None
    title = f"{Path(args.source).name} vs {Path(args.target).name}"
    if Path(args.output).suffix.lower() in (".html", ".htm"):
        # Interactive WebGL viewer (the reference's QOpenGLWidget
        # counterpart): orbit/pan/zoom + iteration replay slider driven
        # by the embedded history transforms.
        from iterativeclosestpoint_tpu_torch.runtime.htmlviz import (
            export_interactive_html,
        )

        history = None
        if args.history:
            from iterativeclosestpoint_tpu_torch.runtime.metrics import (
                read_history_json,
            )

            history = read_history_json(args.history)["history"]
        export_interactive_html(args.output, src, tgt, history=history,
                                title=title, max_points=args.max_points)
        _print(f"interactive viewer written to {args.output}")
        return 0
    if args.history:
        from iterativeclosestpoint_tpu_torch.runtime.metrics import (
            read_history_json,
        )

        hist = read_history_json(args.history)
        rmse = [h["rmse"] for h in hist["history"]]
        k = args.iteration if args.iteration >= 0 else hist["iterations"]
        if k > 0:
            T = hist["history"][min(k, hist["iterations"]) - 1]["transform"]
            src = src @ T[:3, :3].T + T[:3, 3]
            title += f" (iteration {k})"
    render_registration_png(args.output, src, tgt, rmse_history=rmse,
                            title=title)
    _print(f"view written to {args.output}")
    return 0


def cmd_graph(args) -> int:
    """Multi-scan joint registration: pairwise ICP edges and a pose-graph
    solve (an extension: the reference registers one pair at a time)."""
    from iterativeclosestpoint_tpu_torch.io.las import read_las, write_las
    from iterativeclosestpoint_tpu_torch.models.posegraph import (
        detect_overlap_edges,
        register_scans,
    )

    if args.parallel == "partition" and args.multiscale:
        _print("--parallel partition cannot combine with --multiscale "
               "(partitioned edges have no ladder)")
        return 1
    dev = _device_or_exit(args)
    if dev is None:
        return 1
    scans = []
    hdr0 = None
    for p in args.scans:
        pts, hdr = read_las(p, stride=args.stride)
        if args.voxel:
            from iterativeclosestpoint_tpu_torch.ops.downsample import (
                downsample_voxel_stride,
            )

            pts = downsample_voxel_stride(pts, args.voxel)
        hdr0 = hdr0 or hdr
        scans.append(pts)
        _print(f"loaded {p}: {len(pts)} points")
    if len(scans) < 2:
        _print("need at least two scans")
        return 1

    if args.edges == "auto":
        edges = detect_overlap_edges(scans, min_overlap=args.min_overlap)
        if not edges:
            edges = [(i, i + 1) for i in range(len(scans) - 1)]
        _print(f"overlap-detected edges: {edges}")
    else:
        edges = [(i, i + 1) for i in range(len(scans) - 1)]
    if args.loop and len(scans) > 2 and (0, len(scans) - 1) not in edges:
        edges.append((0, len(scans) - 1))  # loop closure: last onto first

    kw = dict(max_iterations=args.max_iterations, tolerance=args.tolerance)
    if args.estimator:
        kw["estimator"] = args.estimator
    if args.robust:
        kw["robust"] = args.robust
    if args.nn_backend:
        kw["nn_backend"] = args.nn_backend
    mesh = None
    if args.parallel != "none":
        from iterativeclosestpoint_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=dev)
        _print(f"parallel={args.parallel}: {mesh.size}-rank mesh")
    stats = {}
    res = register_scans(scans, edges=edges,
                         pose_graph_iterations=args.graph_iterations,
                         multiscale=args.multiscale,
                         graph_robust=args.graph_robust, stats=stats,
                         device=dev, mesh=mesh,
                         partition=args.parallel == "partition", **kw)
    if "scan_uploads" in stats:
        _print(f"device residency: {stats['scan_uploads']} scan uploads, "
               f"{stats.get('grids_built', 0)} NN grids for "
               f"{len(edges)} edges")
    for (i, j), er in zip(edges, res.edge_results):
        flag = "" if er.success else "  ** FAILED: edge dropped **"
        _print(f"edge {i}<-{j}: iters={er.iterations} rmse={er.rmse:.6f} "
               f"({er.message}){flag}")
    if res.disconnected:
        _print(f"ERROR: scan(s) {res.disconnected} have no successful-edge "
               f"path to scan 0; their poses are NOT estimated (identity); "
               f"no usable joint registration")
        return 1
    if not np.isfinite(res.residual_rmse):
        _print("ERROR: pose-graph optimization failed (non-finite residual: "
               "mutually inconsistent edges); no usable joint registration")
        return 1
    _print(f"pose graph: {res.iterations} GN iterations, "
           f"edge-residual RMS {res.residual_rmse:.3e}"
           f"{' (converged)' if res.converged else ''}")
    if args.poses:
        Path(args.poses).write_text(json.dumps({
            "poses": res.poses.tolist(),
            "iterations": res.iterations,
            "residual_rmse": res.residual_rmse,
            "converged": bool(res.converged),
            "edges": [
                {"target": i, "source": j, "rmse": float(er.rmse),
                 "iterations": int(er.iterations), "message": er.message}
                for (i, j), er in zip(edges, res.edge_results)
            ],
        }, indent=1))
        _print(f"poses written to {args.poses}")
    if args.output:
        merged = np.concatenate([
            s @ T[:3, :3].T + T[:3, 3]
            for s, T in zip(scans, np.asarray(res.poses))
        ])
        # Scan 0's georeference, as ``run`` keeps the target's.
        write_las(args.output, merged, scale=hdr0.scale, offset=hdr0.offset)
        _print(f"merged cloud ({len(merged)} pts, scan-0 frame) written "
               f"to {args.output}")
    if args.html:
        from iterativeclosestpoint_tpu_torch.runtime.htmlviz import (
            export_scene_html,
        )

        export_scene_html(
            args.html,
            [s @ T[:3, :3].T + T[:3, 3]
             for s, T in zip(scans, np.asarray(res.poses))],
            names=[Path(p).name for p in args.scans],
            title=f"{len(scans)} scans, joint registration (scan-0 frame)",
        )
        _print(f"interactive scene viewer written to {args.html}")
    return 0 if res.iterations > 0 else 1


def cmd_status(args) -> int:
    p = Path(args.history)
    if not p.exists():
        _print("no run history")
        return 0
    rows = [json.loads(line) for line in p.read_text().splitlines() if line]
    ok = sum(1 for r in rows if r.get("success"))
    _print(f"runs: {len(rows)}  successful: {ok}")
    _print(f"{'time':19} {'src pts':>9} {'tgt pts':>9} {'iters':>5} "
           f"{'rmse':>10} {'secs':>7} status")
    for r in rows[-args.limit:]:
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(r["timestamp"]))
        _print(f"{ts:19} {r['source_points']:>9} {r['target_points']:>9} "
               f"{r['iterations']:>5} {r['rmse']:>10.6f} "
               f"{r['duration_s']:>7.2f} {r['message']}")
    return 0


def _append_history(path: str, rec) -> None:
    if not isinstance(rec, dict):
        rec = dataclasses.asdict(rec)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def cmd_settings(args) -> int:
    from iterativeclosestpoint_tpu_torch.utils.config import (
        AppSettings,
        default_settings_path,
    )

    path = Path(args.settings or default_settings_path())
    settings = AppSettings.load(path)
    if args.set:
        for kv in args.set:
            key, _, value = kv.partition("=")
            target = settings
            if key.startswith("icp."):
                target = settings.icp
                key = key[4:]
            if not hasattr(target, key):
                _print(f"unknown setting: {kv}")
                return 1
            old = getattr(target, key)
            typ = type(old)
            setattr(target, key, typ(value) if typ is not bool
                    else value.lower() in ("1", "true", "yes"))
        settings.icp.validate()
        path.parent.mkdir(parents=True, exist_ok=True)
        settings.save(path)
        _print(f"saved to {path}")
    _print(json.dumps(settings.to_dict(), indent=2))
    return 0


def cmd_smoke(args) -> int:
    """Kernel exactness smoke check (runtime/smoke.py): fast evidence
    that the NN chains give exact 1-NN on this device before a long run."""
    from iterativeclosestpoint_tpu_torch.runtime.smoke import kernel_smoke

    dev = _device_or_exit(args)
    if dev is None:
        return 1
    for k, dt in kernel_smoke(device=dev).items():
        _print(f"smoke[{k}]: kernel exact vs brute force OK on {dev.type} "
               f"({dt * 1e3:.1f} ms)")
    return 0


def cmd_bench(args) -> int:
    """The benchmark (``bench.py``); its settings are the ``BENCH_*``
    environment variables."""
    from iterativeclosestpoint_tpu_torch import bench

    return bench.main(["--device", args.device])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="icp-torch",
        description="Point-cloud registration (ICP for LAS scans) on an "
                    "NVIDIA card, PyTorch/CUDA",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="cuda (the default: the card; exits non-zero without CUDA) "
             "or cpu (the kernels' plain PyTorch versions)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("run", help="register source onto target")
    r.add_argument("source")
    r.add_argument("target")
    r.add_argument("-o", "--output", help="registered LAS output")
    r.add_argument("--report", help="transform report path (.txt)")
    r.add_argument("--html", help="write a standalone interactive viewer "
                                  "(orbit/pan/zoom + iteration replay)")
    r.add_argument("--metrics", help="JSONL metrics path")
    r.add_argument("--history",
                   help="run-history JSONL (for `icp-torch status`)")
    r.add_argument("--checkpoint", help="write checkpoint after the run")
    r.add_argument("--resume", help="resume from checkpoint file")
    r.add_argument("--stride", type=int, default=1,
                   help="decode-time downsample stride (CLI default 50 in "
                        "the reference; 1 = all points)")
    r.add_argument("--voxel", type=float, default=0.0,
                   help="voxel-grid downsample size in metres (0 = off; "
                        "spatially uniform, unlike stride)")
    r.add_argument("--max-iterations", type=int, dest="max_iterations")
    r.add_argument("--tolerance", type=float)
    r.add_argument("--sigma-multiplier", type=float, dest="sigma_multiplier")
    r.add_argument("--mode", choices=["gui", "cli"])
    r.add_argument("--nn-backend", dest="nn_backend",
                   choices=["auto", "bruteforce", "hashgrid", "cellblock",
                            "pallas"])
    r.add_argument("--estimator", choices=["point", "plane"],
                   help="'point' = reference Kabsch semantics; 'plane' = "
                        "point-to-plane extension (fast on smooth scans)")
    r.add_argument("--grid-resolution", dest="grid_resolution", type=int,
                   help="NN grid cells per axis (8-512; 0/omitted = "
                        "data-adaptive auto sizing)")
    r.add_argument("--cell-capacity", dest="cell_capacity", type=int,
                   help="per-cell candidate slots for the hashgrid "
                        "backend (reference octree leaf capacity, 5-100)")
    r.add_argument("--robust", choices=["none", "huber", "tukey"],
                   help="M-estimator pose-update weighting (extension; "
                        "statistics keep the reference's 3-sigma mask)")
    r.add_argument("--multiscale", action="store_true",
                   help="coarse-to-fine pyramid (replaces stride downsample)")
    r.add_argument("--parallel", choices=["none", "dp", "partition"],
                   default="none",
                   help="multi-device dispatch over one rank per visible "
                        "card: dp = source split over the ranks, "
                        "partition = target split into x-slabs + halo; the "
                        "ranks are threads of this process, measured "
                        "slower than none on 4 H100 cards (PERF.md section "
                        "5); a mesh over several processes is the library's "
                        "parallel.init_multihost")
    r.add_argument("--ingest", action="store_true",
                   help="with --parallel partition: STREAM both LAS files "
                        "(bounded batches, each rank keeps only its slab: "
                        "clouds beyond the host's memory); a coarse pass on "
                        "a strided file sample cold-starts the pose; writes "
                        "the transform report (--report), not a registered "
                        "cloud")
    r.add_argument("--live-every", dest="live_every", type=int, default=0,
                   metavar="K",
                   help="stream per-iteration progress every K iterations "
                        "(segmented dispatch; also the cooperative-stop "
                        "granularity)")
    r.add_argument("--rebase", action="store_true",
                   help="GUI-style writer: re-base offsets to cloud min")
    r.add_argument("--settings", help="settings JSON path")
    r.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace to "
                        "DIR/trace.json")
    r.set_defaults(fn=cmd_run)

    s = sub.add_parser("synth", help="generate a test pair with known SE(3)")
    s.add_argument("source_out")
    s.add_argument("target_out")
    s.add_argument("--n", type=int, default=100_000)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--noise", type=float, default=0.0)
    s.add_argument("--outliers", type=float, default=0.0)
    s.add_argument("--overlap", type=float, default=1.0)
    s.add_argument("--kind", default="terrain",
                   choices=["terrain", "uniform", "sphere"])
    s.add_argument("--transform-out", help="ground-truth transform JSON")
    s.set_defaults(fn=cmd_synth)

    i = sub.add_parser("info", help="LAS file info")
    i.add_argument("file")
    i.add_argument("--full", action="store_true", help="decode and show bounds")
    i.set_defaults(fn=cmd_info)

    rp = sub.add_parser("replay", help="export the cloud at iteration k")
    rp.add_argument("source", help="original (pre-registration) source LAS")
    rp.add_argument("history", help="history JSON from `icp-torch run`")
    rp.add_argument("-k", "--iteration", type=int, default=-1,
                    help="iteration number (default: last)")
    rp.add_argument("-o", "--output", required=True)
    rp.set_defaults(fn=cmd_replay)

    v = sub.add_parser("view", help="render clouds to PNG, or to an "
                                    "interactive HTML viewer (-o out.html: "
                                    "orbit/pan/zoom + replay slider)")
    v.add_argument("source")
    v.add_argument("target")
    v.add_argument("-o", "--output", required=True)
    v.add_argument("--history", help="history JSON (enables replay + RMSE curve)")
    v.add_argument("-k", "--iteration", type=int, default=-1,
                   help="PNG only; the HTML viewer embeds every iteration")
    v.add_argument("--max-points", type=int, default=400_000,
                   help="per-cloud embed cap for the HTML viewer")
    v.set_defaults(fn=cmd_view)

    g = sub.add_parser("graph", help="multi-scan joint registration "
                                     "(pairwise ICP edges + pose graph)")
    g.add_argument("scans", nargs="+", help="two or more LAS files, in "
                                            "chain order")
    g.add_argument("-o", "--output", help="merged LAS (scan-0 frame)")
    g.add_argument("--poses", help="per-scan pose JSON output")
    g.add_argument("--edges", choices=["chain", "auto"], default="chain",
                   help="edge selection: sequential chain or "
                        "occupancy-overlap detection")
    g.add_argument("--min-overlap", dest="min_overlap", type=float,
                   default=0.25,
                   help="minimum occupancy-overlap fraction for --edges auto")
    g.add_argument("--multiscale", action="store_true",
                   help="coarse-to-fine pipeline per edge (large scans)")
    g.add_argument("--parallel", choices=["none", "dp", "partition"],
                   default="none",
                   help="multi-device edges over one rank per visible "
                        "card (dp: source split; partition: target split "
                        "into x-slabs) and the edge-sharded pose graph; the "
                        "ranks are threads of one process, measured slower "
                        "than none on 4 H100 cards (PERF.md section 5)")
    g.add_argument("--graph-robust", dest="graph_robust",
                   choices=["none", "huber", "tukey"], default="none",
                   help="IRLS edge weighting in the pose-graph solve "
                        "(tukey rejects gross-outlier edges outright)")
    g.add_argument("--loop", action="store_true",
                   help="add a loop-closure edge (last scan onto first)")
    g.add_argument("--stride", type=int, default=1)
    g.add_argument("--voxel", type=float, default=0.0)
    g.add_argument("--html", help="interactive scene viewer of the "
                                  "optimized scans (standalone HTML)")
    g.add_argument("--max-iterations", type=int, dest="max_iterations",
                   default=50)
    g.add_argument("--tolerance", type=float, default=1e-6)
    g.add_argument("--graph-iterations", type=int, dest="graph_iterations",
                   default=20)
    g.add_argument("--estimator", choices=["point", "plane"])
    g.add_argument("--robust", choices=["none", "huber", "tukey"])
    g.add_argument("--nn-backend", dest="nn_backend",
                   choices=["auto", "bruteforce", "hashgrid", "cellblock",
                            "pallas"])
    g.set_defaults(fn=cmd_graph)

    st = sub.add_parser("status", help="run-history dashboard")
    st.add_argument("--history", default="icp_history.jsonl")
    st.add_argument("--limit", type=int, default=20)
    st.set_defaults(fn=cmd_status)

    se = sub.add_parser("settings", help="show/edit persisted settings")
    se.add_argument("--settings", help="settings file path")
    se.add_argument("--set", nargs="*", metavar="KEY=VALUE")
    se.set_defaults(fn=cmd_settings)

    b = sub.add_parser("bench", help="the headline benchmark (BENCH_* "
                                     "environment variables; last stdout "
                                     "line JSON)")
    b.set_defaults(fn=cmd_bench)

    sm = sub.add_parser("smoke", help="kernel exactness check")
    sm.set_defaults(fn=cmd_smoke)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
