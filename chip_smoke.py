"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

Run from the repository root with one card visible:

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card's name, ``nvidia-smi`` name and power limit, and its
   maximum SM clock, from which the issue floor below is computed;
2. build: the four CUDA sources (``csrc/*.cu``; K1 and K2 each in a
   default and a first-tie form, the two sweep windows), one nvcc each,
   together;
3. kernels against plain, at every shape the main paths launch. On the
   1M-point terrain pair (seed 7), on grids that carry the target's
   cell-PCA normals in rows 3-5 (the plane path's grids; the point paths
   launch the same shapes): K1 on the fine grid, K2 on the coarse repair
   grid at each stage size of the repair chain (64, 192 and 512 tiles),
   K3 at the coarse-level shape and at the repair chain's brute stages
   (512 and 4096 queries against the 1M target). On the 10M-point terrain
   pair (seed 7): the same on the fine level's base grid and on its
   boosted grid (the two-stage plane level, both with normals), and on the
   555,556-point middle level's own grid (point mode, no normals), K3 at
   the first coarse level's shape. Where a fine sweep's trange sends it
   to K2's slot-wise form, K2 is held at the fine layout's tile count. On
   the 1M-point uniform volume pair (seed 7): K1 as the z-column sweep
   (12 z-window slots of zrange rows), K2 on the volume's coarse repair
   grid at the same three stage sizes, and K2 in the z-column sweep's
   slot-wise form (12 slots × 3072 rows, past its 24576-lane gate) on 512
   tiles. On rows without an exact tie the winner's rows 0-5 (xyz and
   normal) and d² must be bit-identical, and the tie flags equal
   everywhere; K3's indices and distances equal everywhere. Each K3 line
   names the target splits its wrapper chose (``brute_splits``), and at
   the 1M shapes a second line gives the kernel at other split counts,
   from 2 to 48 CTAs per SM, whose keys must equal those at the chosen
   count. Times are CUDA-event medians of 5 wrapper calls (2 for the
   plain versions at 10M), except K3's: its wrapper adds ~15 small torch
   operations (key decode, distance recomputation) whose host time can
   exceed the kernel's, so K3's kernel time is that of its launch step
   (``brute_keys``: key fill and kernel) over 20 back-to-back launches,
   with the wrapper call's time beside it; the library yardstick (chunked
   ``torch.cdist`` + argmin) is the median of 3 calls at the 1M shapes and
   one call at the 10M shapes (about 6 s at 512 × 10M; the 4,096 × 10M
   pass is left to ``--library-times``). The data-sheet bound
   is the larger of bytes / 3.35 TB/s and 9 f32 operations per
   query–candidate pair / 67 TFLOP/s (the H100 SXM data-sheet peaks), the
   ``bound_s`` of each launch's ``runtime/profiling.py::KernelReport``.
   That rate counts an FMA as two operations, but the d² contract forbids
   FMA, so each of the 9 is one instruction issued at 128 per SM per
   clock: the issue floor, pairs · 9 / (SMs · 128 · max SM clock), is
   about twice the data-sheet bound, and each line gives the share of it
   the kernel reaches. K2's pairs count each tile's distinct rows (its
   kernel scans a row that two slab windows share once), and its lines
   name the CTAs per tile (splits) its wrapper chose. Each sweep any
   phase holds takes its window from a ``[3 windows]`` line, which holds
   the window kernel (``slab_window``, ``zcol_window``) against its plain
   version on the same layout, bit for bit, with both times (CUDA-event
   medians of 5), its bytes bound and its launch tally: the fine windows
   (the 1M terrain's, the 10M base and boosted grids', the middle
   level's, the 1M volume's z-columns and their slot-wise form) and the
   coarse repair windows beside them. A window is keyed (slots, trange,
   fused), as K1 is, so each window shape a path launches is held
   wherever the sweep it feeds is;
4. the main path: ``icp_register_multiscale`` with the headline
   configuration (1M points, coarse_max_points 30k, 15 coarse and 20 fine
   iterations at tolerance 0), one warm-up and 3 timed runs, launch counts
   by kernel and shape (K1 and K3 must launch, and every shape launched
   must be one phase 3 held against plain), the stage breakdown of a
   synced run, one run under ``torch.profiler`` (device busy time, idle
   share, kernels by device time), and the final pose's NN held against
   ``scipy.spatial.cKDTree``;
4b. the volume path: the same, with ``bench.py``'s volume configuration
   (the 1M uniform 10:10:2 box, seed 7, the headline's kwargs), where the
   regime gate picks the z-column sweep: K1 must launch at 12 slots;
4c. the plane path: the same, with ``bench.py``'s plane row (the headline
   with ``estimator="plane"``); the breakdown shows the normal estimation
   as its own stage inside grid_build, and at the final pose every
   returned normal must equal the target's normal at the winner, bit for
   bit; the two-stage gate's inputs are printed (at 1M the surface boost
   already applies, so the fine level is one stage);
4d. the two-stage plane path at 10M points (``make_registration_pair(n=
   10_000_000, seed=7, noise_sigma=0.02, kind="terrain", extent=100.0)``,
   the plane kwargs): the gate's construction guard (R == base, boost at
   16 points per cell), one warm-up and one timed run, the breakdown of a
   synced run, ``nn_resolution == 2·base`` and 20 fine iterations, and
   distances and normals at the final pose on a seeded sample of 200,000
   real rows against cKDTree;
5. the repair path: ``icp_register`` at 250k points from a misalignment of
   a few fine cells (K2 must launch; the first iteration's NN is exact);
6. card against CPU: a 60k-point terrain, a 50k-point uniform box
   (z-column sweep on both devices), a 25k-point terrain through the
   two-stage plane level (``nn_resolution == 2·base`` on both) and the
   60k terrain with ``robust="tukey"``, multiscale on both, same iteration
   counts and stop codes, registration error ≤ 1e-4 m. On the card alone:
   the two-stage plane run in segments of 3 equals the one-dispatch run,
   a 5 + 5 iteration run resumed through ``resume_carry`` equals the
   10-iteration run (history and transform, bit for bit), and two
   estimations of the 1M target's normals are bit-equal (timed). The
   JAX package's non-finite case (n=1000, seed 8, one NaN source
   coordinate) through ``icp_register`` (pallas and bruteforce, f32 and
   f64) and ``icp_register_multiscale`` (pallas, f32) stops with code 6 after
   0 iterations and ``success=False`` on the card and on the CPU alike,
   and the public ``kabsch`` returns R and t of NaN on the card; every
   shape those runs launched is held against plain;
7. the product surface, ``icp-torch`` (``cli.main``) in this process in a
   temporary directory: (a) ``synth`` a 1M-point terrain pair as LAS
   (seed 7, noise 0.02, the CLI's default extent of 50 m) and ``info
   --full``; (b) ``smoke``: both regimes' exact chains against K3; (c)
   ``run --multiscale --nn-backend pallas --max-iterations 20`` with
   metrics, history, checkpoint and HTML: its wall, the session's
   duration and the host I/O stages (decode of each file, the registered
   LAS, the reports, the HTML); the library call on the decoded clouds
   with the session's kwargs must give the same iterations, stop code and
   transform bit for bit, the metrics log's records must equal its
   history, and the final pose is held against cKDTree; a shape the run
   launched that phase 3 did not hold is held against plain on this
   pair's grids; (d) on a 250k pair without multiscale, 5 + 5 iterations
   resumed from the checkpoint equal 10 in one run, and a run in live
   segments of 5 streams the one-shot history, bit for bit; (e)
   ``replay -k 3``, ``status`` and ``view`` to HTML (the ``--parallel``
   runs are phase 9e, ``bench`` phase 11a);
8. the multi-scan pose graph: (a) ``tools/exp_ms3.py``'s configuration,
   four x-windows (0.4 of the x extent at a step of 0.2, ~800k points
   each, N(0, 0.01) noise from ``default_rng(0)``) of
   ``make_cloud(2_000_000, seed=3, extent=200.0)``, through
   ``register_scans(edges="auto", reuse_device=True, max_iterations=20,
   tolerance=0.0, mode="gui")``: one warm-up, one timed run (wall,
   launches; 3 edges, 3 scan uploads, 3 grids, 3 cropped uploads, no
   scan disconnected, a finite residual), one synced run (each edge's
   fine-loop ms/iteration, ``edge_stage``, ``grid_build`` and the GN's
   iterations and ms); each edge's final pose held against cKDTree on a
   seeded sample of 200,000 real rows (the edges slide on this periodic
   terrain, leaving queries metres from the target, where one f32 ulp of
   a distance passes 1e-6 m: each returned point must be a nearest
   neighbour within 1e-9 m in f64, and each distance its winner's,
   recomputed, bit for bit); every shape the timed run
   launched that phase 3 did not hold is held against plain on the
   targets' grids; (b) card against CPU on four ~20k strips of the same
   density (crop margin 0, where the edges converge): same edges,
   per-edge iterations and stop codes, poses within 1e-4 m; (c) the
   5-pose graph with one corrupted edge (6 edges) solved on the card
   with tukey: poses within 1e-6 of the truth and within 1e-9 of the
   CPU's (f64); (d) ``icp-torch graph --edges auto`` on the four strips
   as LAS with ``--poses``, ``--html`` and ``-o``: its poses equal
   ``register_scans`` on the decoded clouds bit for bit; (e) the test and
   reference
   backends: ``icp_register`` with ``nn_backend="cellblock"`` and with
   ``"hashgrid"`` (``cell_capacity=10``) on phase 6's 60k terrain, held
   to the pallas backend's iteration count and stop code and 1e-4 m,
   and each backend's NN exact against cKDTree at its final pose; every
   K3 shape they launched that phase 3 did not hold is held against
   plain;
9. the single-host multi-device paths (``parallel/``) on this one card:
   a mesh of one rank and a mesh of four ranks, all on ``cuda:0`` (the
   counterpart of the JAX tests' virtual host devices: four ranks on one
   card measure correctness and overhead, not scaling). For each run its
   wall, launches and the bytes each rank contributed to collectives per
   iteration. (a) dp: the headline through ``icp_register_multiscale(...,
   mesh=)``, one warm-up and one timed run per mesh and a synced
   breakdown: 1 rank gives the single-device iterations, stop code,
   transform and history bit for bit; 4 ranks the same iterations and
   stop code within 1e-4 m; the final pose's NN exact against cKDTree;
   (b) the partitioned target at 10M (phase 4d's pair,
   ``tools/exp_partition10m.py``'s recipe: the plane ladder with 8
   iterations at tolerance 1e-7, then ``icp_register_partitioned(
   estimator="plane", max_iterations=20, tolerance=0.0)`` from its pose)
   on 1 and 4 ranks: prep and loop times, fine ms/iteration, the
   collective repair's passes and queries per iteration; the same
   iterations and stop code as the 20 iterations on one device without
   slabs, within 1e-4 m, and 1 rank against 4 within 1e-4 m; on a seeded
   200,000-row sample of the last iteration's matches each returned point
   is a target point and a nearest neighbour in f64 (≤ 1e-9 m) and each
   normal its winner's, bit for bit; every shape launched is held against
   plain on the ranks' own slabs; (c) the cross-rank tie of
   ``tests/test_partition.py`` on two ranks returns B exactly, and a 20k
   terrain lifted 500 m above its target with a halo of 1e-4 sends every
   query through the collective repair, whose winners equal the plain
   brute force's over the whole target; (d) phase 8b's four strips
   through ``register_scans(mesh=4 ranks)``, data-parallel and
   partitioned, against phase 8b's CPU run (edges, stop codes, poses
   within 1e-4 m), and phase 8c's tukey graph through
   ``optimize_pose_graph_sharded`` on 4 ranks within 1e-9 of one device
   (f64); (e) ``icp-torch run --multiscale --parallel dp|partition`` on a
   1M LAS pair (the CLI's mesh: one rank per visible card) equals the
   library call bit for bit, and ``graph --parallel dp`` equals
   ``register_scans(mesh=)`` bit for bit;
10. the mesh over several processes (``init_multihost``): worker
   processes are this script started again with ``--worker``, two of
   them sharing ``cuda:0`` over gloo, one rank each; a worker that exits
   non-zero fails the phase. (a) dp: the headline through
   ``icp_register_multiscale(mesh=)`` (the fine level takes the host path
   on a multi-process mesh): bit-equal to a 1-process 2-rank mesh on the
   card from the same coarse pose, and the iterations and stop code of
   one device on that path within 1e-4 m (the gap to one device's
   multiscale run printed beside it); wall, fine ms/iteration, bytes per
   iteration per
   rank and launches per process; (b) the streamed ingest at 10M: phase
   4d's pair written as LAS, then in each process ``sample_points``,
   walls, ``estimate_partition_grid_params``, ``coarse_carry_from_files``,
   ``load_las_partitioned_target``/``_source`` (batches of 1M rows) and
   ``icp_register_partitioned(partition_state=, source_global=, offset=,
   grid_params=, estimator="plane", max_iterations=20, tolerance=0.0)``
   from the coarse carry, with a repair budget (8,192 × 8) that covers
   every row the pose carries across a wall (the most sent in one
   iteration is checked against it): each process keeps part of each
   file, bit-equal
   to the same sequence on a 1-process 2-rank mesh; on a seeded 200,000-
   row sample of the last matches each returned point is a target point
   and a nearest neighbour in f64 (≤ 1e-9 m) against cKDTree, and (rows
   the repair did not touch) each normal is its winner's slab normal;
   ``icp-torch run --parallel partition --ingest`` on the files (one rank
   in this process) equals the library sequence on one rank bit for bit;
   prep, ingest and loop times; (c) a segmented run (12 iterations in
   segments of 3, f32 pallas, n=1001) with a rolling checkpoint, where
   process 1 SIGKILLs itself at iteration 6: the survivor fails within
   30 s naming the lost process, and two fresh processes resume to the
   uninterrupted tail and transform bit for bit. Every shape the dp and
   ingest processes launched is held against plain;
11a. the benchmark: ``icp-torch bench`` as a subprocess on the card
   (``BENCH_REPS=3``, ``BENCH_SMOKE=0``, full N; the native octree
   baseline at ``BENCH_BASELINE_N=250000`` to keep the phase short: the
   1M baseline alone takes minutes on the host's CPU). Its exit code is
   0, its JSON line has the terrain, volume and plane rows with
   ``bench.py``'s keys, the terrain row ran 20 fine iterations to phase
   4's RMSE bit for bit (the same call on the same card),
   ``vs_baseline`` is a number and the parity error against the native
   pipeline is under 1e-4 m (the reference's iteration count is printed,
   not gated); each kernel launched in it, and every shape it launched
   is held against plain (the parity pair's K3 shape here). Its JSON
   line, report lines, baseline and parity lines are printed;
11b. the f64 oracle on the card: ``icp_register(dtype=torch.float64,
   nn_backend="bruteforce", center=False, max_iterations=30)`` on the
   card against the port's ``utils/oracle.py`` on 20,000-point pairs
   (seeds 0 and 3, gui and cli): the same iteration count, stop message
   and inlier counts, every iteration's transform within 1e-9 (and its
   RMSE within 1e-9 relative). Then ``nn_backend="pallas"`` at f64 on a
   4,000-point pair (seed 5, noise 0.02) whose uncertified queries reach
   the sweep's brute tiers (the plain f64 brute force), point and plane,
   10 iterations, on the card against the CPU: the brute tier fires at
   f64, the same iterations and stop code, every point transform within
   1e-9 and the plane's final one within 1e-8; every shape the card's
   runs launched is held against plain;
12. the JAX package's last public options, on the card: ``kabsch`` and
   ``kabsch_masked`` with f32 points and ``accum_dtype=torch.float64`` on
   phase 6's 60k terrain pair against the same calls on the CPU (within
   1e-12: the f32 results are equal), each entry equal to or one f32 ulp
   from the f64 oracle's ``best_fit_transform`` cast to f32, and R and t
   all NaN with one NaN source coordinate; ``nn_bruteforce(use_matmul=
   True)`` on the pair's first 4,096 centred source rows against its
   60,000 target rows, on the card against the CPU: every index equal in
   f64 and f32 (each operation rounds alike on both), every distance the
   explicit one to its winner, and every index the explicit form's
   wherever the explicit best d² lies more than 4·|c|²·eps below the best
   at other coordinates (|c| the largest coordinate norm), with the count
   of rows that differ and the time beside the explicit form's; the
   ``KernelReport`` roofline of phase 3's K1 launch on the 1M terrain's
   fine grid (its sol and bound, which must be phase 3's Bound ms) beside
   ``nn_kernel_report``'s every-lane model of the same launch;
13. the JAX package's last left-out surface, on the card: (a) K1's and
   K2's first-tie forms (``colsweep_fused_ft``, ``colsweep_ft``) through
   ``nn_colsweep(first_tie=True)`` on a triplicated target (3,000 points,
   each three times, R=16: K1 at trange 768, K2 at 1536) and on the 1M
   terrain's fine grid (K1 at R=128 / trange 768; K2 at the 10M base's
   trange 1536), each held against its plain version (rows 0-7 bit for
   bit, row 7 all 1) and against the default form (the same rows 0-6
   wherever that one is unique), with kernel ms (CUDA-event median of
   5), issue floor, bound and plain ms; (b) ``make_pallas_brute`` on the
   headline's 29,412-point coarse target: its K3 and K2's first-tie form
   on the same one-cell grid give every winner and distance alike, their
   times beside phase 3's chunked ``torch.cdist`` + argmin; (c)
   ``make_pallas_nn`` (the host factory, trange ≥ 2048, 6 slabs: K2
   slot-wise) on the 1M terrain as ``icp_register``'s ``nn_fn`` from the
   headline's coarse pose, the source in the device grid's x-group order,
   against the device factory's nn_fn on the same rows: the same
   iterations and stop code, within 1e-4 m, and every distance K3's at
   the first and the last pose; (d) a 2M terrain (one coarse level of
   40,000 points) with a progress callback: fine dispatches of max(2,
   8,000,000 // n) = 4 iterations, a record per iteration and a carry at
   each slice's end, the transform and histories bit for bit those of
   the run without it, which makes one dispatch (each run's launches
   counted from zero: paths ``autoseg_one`` and ``autoseg``); (e)
   ``mask_far`` on the 1M target with 300 far rows: real rows bit for
   bit the build without them, far rows +z, card against CPU by angle.
   Every shape its runs launched is held against plain;
14. a JSON line ``{"kernels": [...]}`` with each kernel's launches (the
   windows' too) over the main paths (headline, volume, plane, plane_10m, product, graph,
   backends, phase 9's mesh_dp, mesh_partition, mesh_repair, mesh_graph,
   mesh_product, phase 10's mp_dp and mp_ingest, each summed over its
   processes, phase 11a's bench, and phase 13's first_tie, host_factory,
   autoseg_one and autoseg), error, times, data-sheet bound and issue floor at its
   most launched shape (K3 and K2's first-tie form: the most launched
   with a library time), and every measured shape under ``shapes`` with
   its launches per path;
15. the last line: ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --across-cards``, on a host with several cards,
runs phases 1 and 2, then phase 9a and 9b's runs on ``make_mesh()`` (one
rank per visible card, what ``icp-torch --parallel`` builds), and on a
mesh of one process per card over NCCL (``init_multihost``), against one
device and a 1-rank mesh: best wall of 3 and the fine loop's
ms/iteration (9a); prep, wall and fine ms/iteration (9b); the same
iterations and stop code within 1e-4 m. A process mesh runs 9a's fine
level on the host path (the coarse pose applied on the host in f64), so
its references are that path's: one device (the gate) and the thread
mesh over the cards, bit for bit. It holds no kernel and prints no
``kernels`` line.

``python3 chip_smoke.py --library-times`` runs phases 1 and 2, then times
the library yardstick (chunked ``torch.cdist`` + argmin, one call each)
at the K3 shapes the default run leaves untimed (past 1e9 pairs): phase
9b's slabs, 512 and 4,096 queries against 2,700,718 rows and 32,768
against 2,500,047, phase 10b's, 512, 4,096 and 16,384 against
5,205,074, phase 11a's parity pair, 50,000 against 50,000, and phase 3's
bulk brute pass, 4,096 against the 10M target (about five minutes).

Any failed check raises, so the script exits non-zero and prints no result
line. Without CUDA it exits with code 1 before anything else.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

HEADLINE = dict(n=1_000_000, seed=7, noise_sigma=0.02, kind="terrain",
                extent=100.0)
HEADLINE_KW = dict(coarse_max_points=30_000, coarse_iterations=15,
                   max_iterations=20, tolerance=0.0, nn_backend="pallas",
                   return_registered=False)
# bench.py's volume row: the headline's kwargs on a uniform box.
VOLUME = dict(n=1_000_000, seed=7, noise_sigma=0.02, kind="uniform",
              extent=100.0)
# bench.py's plane row: the headline with the point-to-plane estimator;
# at 10M points its fine level runs the two-stage boosted grids.
PLANE_KW = dict(HEADLINE_KW, estimator="plane")
PLANE_10M = dict(HEADLINE, n=10_000_000)
SAMPLE_10M = 200_000    # phase 4d: real rows held against cKDTree
# phase 6: the two-stage plane regime of the JAX package's multiscale test
TWO_STAGE = dict(n=25_000, seed=21, noise_sigma=0.02, kind="terrain",
                 extent=100.0)
TWO_STAGE_KW = dict(coarse_max_points=3000, coarse_iterations=10,
                    max_iterations=12, tolerance=0.0, estimator="plane")
ZCOL_SLOTWISE = 3072    # phase 3: a zrange past the 24576-lane K1 gate
SLOTWISE_TILES = 512    # phase 3: tiles of that slot-wise K2 launch
# phase 3: K3's split counts timed beside the wrapper's, as CTAs per SM
# (the scan keeps 6 resident)
K3_CTAS_PER_SM = (2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 24, 32, 48)
BOX_N = 50_000          # phase 6 uniform box
# phase 6: the JAX package's non-finite case (tests/test_icp_pairwise.py):
# its n=1000, seed 8 pair with source[13, 1] = NaN
NONFINITE = dict(n=1000, seed=8)
# phase 11b: a pair whose f64 pallas run reaches the sweep's brute tiers
F64_PALLAS = dict(n=4000, seed=5, noise_sigma=0.02)
REPAIR_N = 250_000      # phase 5 cloud size
CARD_CPU_N = 60_000     # phase 6 cloud size
PRODUCT_N = 1_000_000   # phase 7 LAS pair (icp-torch synth)
RESUME_N = 250_000      # phase 7 resume pair
# phase 8: tools/exp_ms3.py's multi-scan job, and a 4-strip graph of the
# same density (~50 points/m²) small enough for the CPU
GRAPH_WORLD = dict(n=2_000_000, seed=3, extent=200.0)
GRAPH_KW = dict(edges="auto", reuse_device=True, max_iterations=20,
                tolerance=0.0, mode="gui")
GRAPH_SMALL = dict(n=50_000, seed=3, extent=32.0)
GRAPH_SAMPLE = 200_000  # phase 8a: real rows held against cKDTree per edge
# phase 9: ranks of the multi-rank mesh, all on the one card
MESH_RANKS = 4
# phase 9b: tools/exp_partition10m.py's 10M recipe, the ladder init and
# the partitioned fine pass
PART_LADDER_KW = dict(nn_backend="pallas", estimator="plane",
                      max_iterations=8, tolerance=1e-7,
                      return_registered=False)
PART_KW = dict(estimator="plane", max_iterations=20, tolerance=0.0,
               return_registered=False)
# phase 9b: a halo of 1 mm sends the queries near each slab wall through
# the collective repair every iteration (up to ~32k rows of a rank's 2.5M
# in one iteration); a budget that covers them all
PART_REPAIR_HALO = 1e-3
PART_REPAIR_BUDGET = 8192
PART_REPAIR_PASSES = 8
PART_REPAIR_HELD = 4096  # repaired rows held against the plain brute force
# phase 9: K3 shapes up to this many pairs get the library yardstick (a
# chunked cdist takes ~1.2 ns a pair: ~10 s at a 10M slab's 4096 queries)
LIBRARY_PAIRS_MAX = 1e9
# phase 3: the repair chain's bulk K3 pass at 4,096 × 10M (4.1e10 pairs, a
# ~50 s chunked cdist; no path launches it) leaves its yardstick to
# --library-times
LIBRARY_PAIRS_HELD = 1e10
REPAIR_ALL_N = 20_000   # phase 9c: queries sent through the repair
REPAIR_ALL_LIFT = 500.0  # m: past every slab margin (a 100 m terrain)
# phase 10: processes of the multi-process mesh, all on the one card over
# gloo (NCCL refuses two ranks of one communicator on one GPU)
MP_PROCESSES = 2
MP_TIMEOUT_S = 300      # a phase-10 process group's wall limit
MP_HEARTBEAT_S = 60     # the process group's call bound
MP_BATCH = 1_000_000    # phase 10b: the streamed loaders' batch rows
# phase 10b: the source is sharded by the target's walls in the file's
# frame, so the rows the pose carries across a wall (~10,000 of a rank's
# 5M) go through the collective repair every iteration; a budget that
# covers them all (the default 1,024 × 4 leaves most approximate, as in
# JAX)
MP_REPAIR = dict(repair_budget=PART_REPAIR_BUDGET,
                 repair_passes=PART_REPAIR_PASSES)
# phase 10c: tests/_torch_failure_worker.py's run, f32 on the card
MP_FAIL = dict(n=1001, seed=50, noise_sigma=0.02)
MP_FAIL_KW = dict(nn_backend="pallas", max_iterations=12,
                  segment_iterations=3, return_registered=False)
MP_KILL_AT = 6          # the iteration at whose boundary process 1 dies
MP_DETECT_S = 30.0      # the survivor's bound from the kill to its error
CARDS_TIMEOUT_S = 600   # --across-cards: a process group's wall limit
# phase 11a: icp-torch bench at full N; its native baseline at a quarter
# of N (the 1M baseline takes minutes on the host's CPU)
BENCH_REPS = 3
BENCH_BASELINE_N = 250_000
BENCH_TIMEOUT_S = 600
ORACLE_N = 20_000       # phase 11b: the f64 pairs held against the oracle
# phase 12: phase 6's 60k terrain pair (rows correspond), fitted by
# kabsch with f64 sums; its first 4,096 source rows against the 60,000
# target rows through nn_bruteforce(use_matmul=True)
OPTIONS_PAIR = dict(n=CARD_CPU_N, seed=95, noise_sigma=0.01)
MATMUL_QUERIES = 4096
# phase 13: the first-tie forms on a target of this many points, each
# three times (tests/test_pallas_nn.py's tie fixture, scaled), at R=16
FT_TRIPLE = 3000
# phase 13d: the ≥2M auto-segmentation on a 2M terrain (slices of
# max(2, 8,000,000 // 2,000,000) = 4 iterations)
AUTOSEG_PAIR = dict(n=2_000_000, seed=7, noise_sigma=0.02, kind="terrain",
                    extent=100.0)
AUTOSEG_COARSE = 40_000  # its coarse level's cap: one level, stride 50
MASK_FAR_PADS = 300     # phase 13e: far rows appended to the 1M target
# --library-times: K3's shapes past LIBRARY_PAIRS_MAX: phase 9b's slabs (4
# ranks, halo 2% and 1 mm), phase 10b's (2 ranks; the other slab holds
# 5,194,278 rows), phase 11a's parity pair and phase 3's 4,096 × 10M
LIBRARY_SHAPES = ((512, 2_700_718), (4096, 2_700_718), (32_768, 2_500_047),
                  (512, 5_205_074), (4096, 5_205_074), (16_384, 5_205_074),
                  (50_000, 50_000), (4096, 10_000_000))
DEVICE = "cuda"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def make_data(config):
    """A registration pair and its centered f32 copies."""
    from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    src, tgt, T_true = make_registration_pair(**config)
    offset = center_offset(tgt)
    return dict(src=src, tgt=tgt, T_true=T_true, offset=offset,
                src_local=(src - offset).astype(np.float32),
                tgt_local=(tgt - offset).astype(np.float32))


def cuda_ms(fn, reps=5, warmup=True):
    """Median CUDA-event time of ``fn()`` over ``reps`` calls (after one
    warm-up call unless ``warmup`` is false), and the last result."""
    out = fn() if warmup else None
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), out


def cdist_argmin(q, t, chunk=65536, q_chunk=32768):
    """The library yardstick for K3: ``torch.cdist`` in its explicit
    (non-matmul) mode and an argmin, over target chunks of ``chunk`` rows
    and query chunks of ``q_chunk`` rows (one call over a 1M-row target,
    or 60,000 queries against 60,000 targets, is refused as an invalid
    launch configuration). The port never calls it."""
    if q.shape[0] > q_chunk:
        return torch.cat([cdist_argmin(q[q0:q0 + q_chunk], t, chunk, q_chunk)
                          for q0 in range(0, q.shape[0], q_chunk)])
    best = torch.full((q.shape[0],), float("inf"), device=q.device)
    arg = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
    for t0 in range(0, t.shape[0], chunk):
        d = torch.cdist(q, t[t0:t0 + chunk],
                        compute_mode="donot_use_mm_for_euclid_dist")
        v, i = d.min(dim=1)
        take = v < best
        best = torch.where(take, v, best)
        arg = torch.where(take, i + t0, arg)
    return arg


def launch_report(label, ms, pairs, nbytes, spec):
    """A launch's ``runtime/profiling.py::KernelReport`` on the card
    ``spec``: its query–candidate ``pairs`` against the issue floor, and 9
    f32 operations a pair and ``nbytes`` against the data-sheet
    roofline."""
    from iterativeclosestpoint_tpu_torch.runtime.profiling import (
        OPS_PER_PAIR,
        KernelReport,
    )

    return KernelReport(label, ms / 1e3, pairs, spec,
                        flops=pairs * OPS_PER_PAIR, bytes_hbm=nbytes)


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device():
    """The card's name, nvidia-smi's name and power limit, and its
    ``CardSpec``: SMs and maximum SM clock (the issue floor's), and the
    H100 SXM data sheet's f32 and HBM rates (the roofline's)."""
    from iterativeclosestpoint_tpu_torch.runtime.profiling import CardSpec

    name = torch.cuda.get_device_name(0)
    smi = _smi("name,power.limit")
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    spec = CardSpec(name, sms, clock_mhz * 1e6)
    print(f"[1 device] {name}; count {torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; max SM clock {clock_mhz:.0f} MHz, {sms} SMs: "
          f"issue rate {spec.issue_rate:.4e} instructions/s; roofline "
          f"{spec.f32_ops_per_s:.4e} f32 operations/s "
          f"({spec.f32_source}), {spec.hbm_bytes_per_s:.4e} B/s HBM "
          f"({spec.hbm_source}); torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    return name, smi, spec


def phase_build():
    from iterativeclosestpoint_tpu_torch.ops import _build

    secs = _build.build_all()
    print(f"[2 build] {secs:.3f} s for {len(_build.SOURCES)} sources",
          flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 build] {name}: {line.strip()}")


def _compare_sweeps(out_k, out_p):
    """Tie flags equal everywhere; rows 0-6 bit-identical where neither
    reports a tie. Returns the max abs error over those rows."""
    tie_k, tie_p = out_k[:, 7] != 1.0, out_p[:, 7] != 1.0
    check(torch.equal(tie_k, tie_p), "tie flags differ from plain")
    free = (~tie_k)[:, None, :].expand(-1, 7, -1)
    diff = (out_k[:, 0:7] - out_p[:, 0:7]).abs()[free]
    err = float(diff.max()) if diff.numel() else 0.0
    check(err == 0.0, f"kernel differs from plain on tie-free rows: {err}")
    return err, int(tie_k.sum())


def _timed_pair(label, kernel, plain, compare, pairs, nbytes, spec,
                library=None, device_ms=None, plain_reps=5,
                library_once=False, tag="3 kernels"):
    """Time ``kernel`` and ``plain`` (and ``library``, K3's yardstick) on
    the same inputs, hold kernel against plain with ``compare`` (returns
    max_abs_err and a note), and compute the data-sheet bound and the
    issue floor. ``device_ms``, where given (K3), is the kernel's own
    device time: it stands for the kernel, and the wrapper call's CUDA-event
    time is reported beside it. ``library_once``: one timed library call
    with no warm-up (the 10M shapes, where one call takes up to a minute).
    Prints one line and returns the entry."""
    ms, out_k = cuda_ms(kernel)
    wrapper = {}
    if device_ms is not None:
        wrapper = {"wrapper_ms": ms}
        ms = device_ms
    plain_ms, out_p = cuda_ms(plain, reps=plain_reps)
    err, note = compare(out_k, out_p)
    if wrapper:
        note += f", wrapper call {wrapper['wrapper_ms']:.4f} ms"
    lib_ms = None
    if library is not None:
        lib_ms, lib_out = (cuda_ms(library, reps=1, warmup=False)
                           if library_once else cuda_ms(library, reps=3))
        agree = float((lib_out == out_k[0]).float().mean())
        note += (f", chunked cdist + argmin {lib_ms:.4f} ms (winner "
                 f"agreement {agree:.6f})")
    rep = launch_report(label, ms, pairs, nbytes, spec)
    b, by, floor = rep.bound_s * 1e3, rep.bound_by, rep.floor_s * 1e3
    print(f"[{tag}] {label}: {pairs:.4e} pairs, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, issue floor {floor:.4f} ms (reached "
          f"{floor / ms:.3f}), data-sheet bound {b:.4f} ms ({by}), "
          f"max_abs_err {err}{note}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                floor_ms=floor, max_abs_err=err, library_ms=lib_ms,
                pairs=pairs, bytes=nbytes, **wrapper)


def _compare_sweep(out_k, out_p):
    err, ties = _compare_sweeps(out_k, out_p)
    return err, f", ties {ties}"


def _record(results, name, key, entry):
    """Keep ``entry`` under ``key`` (a launch shape as ``_shape_key``
    gives it); K1's key leaves out the tile count, so one key may hold
    entries of several layouts."""
    results[name].setdefault(key, []).append(entry)


def _sweep_k1(results, win, tgt_t, slabs, trange, replaces, spec,
              plain_reps=5):
    """K1 against plain on one window (all its tiles), the certificates
    too; keyed (slabs, trange), since its tile count follows the query
    layout."""
    from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import (
        colsweep,
        colsweep_plain,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import sweep_results

    t = win.base.shape[0]
    args = (win.base, win.q32, tgt_t)
    kw = dict(slabs=slabs, trange=trange, fused=True, slack=win.slack)
    v = win.slack.long()
    lens = torch.clamp(torch.minimum(v >> 7, trange - (v & 127)), min=0)

    def compare_k1(out_k, out_p):
        err, note = _compare_sweep(out_k, out_p)
        cert_k = sweep_results(out_k, win, torch.float32)[3]
        cert_p = sweep_results(out_p, win, torch.float32)[3]
        check(torch.equal(cert_k, cert_p), "K1 certified differs from plain")
        return err, note + f", certified {float(cert_k.float().mean()):.6f}"

    shape = f"{t} tiles x {slabs} slots, trange {trange}"
    entry = _timed_pair(
        f"K1 colsweep_fused {shape}", lambda: colsweep(*args, **kw),
        lambda: colsweep_plain(*args, **kw), compare_k1,
        int(lens.sum()) * 128,
        t * 128 * 12 + t * slabs * 8 + (tgt_t.shape[1] - trange) * 12
        + t * 8 * 128 * 4, spec, plain_reps=plain_reps)
    entry.update(shape=shape, replaces=replaces, tiles=t)
    _record(results, "colsweep_fused", (slabs, trange), entry)


def _hold_window(results, label, kind, query, grid, kw, spec):
    """The window kernel of ``kind`` ("slab", ``sweep_window``'s keywords
    in ``kw``, or "zcol", ``zcol_window``'s) against its plain version on
    ``query``'s tiles: CUDA-event medians of 5 calls of each, the outputs
    bit for bit (radius: NaN where plain has NaN) and the launch tally;
    keyed (slots, trange, fused), since its tile count follows the query
    layout as K1's does. Bound: bytes, 12 read and 5 written a query, 8
    gathered and 4 (base) or 8 (base and mask) written a slot, over the
    data sheet's HBM rate. Returns the kernel's window: every sweep a
    phase holds takes its window from here, so each window shape a main
    path launches is held where its sweep's shape is."""
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops import sweep_nn as tsn

    tpu = "iterativeclosestpoint_tpu/ops/pallas_nn.py"
    name, kernel, plain, replaces = (
        ("zcol_window", tsn.zcol_window, tsn._zcol_window_plain,
         f"{tpu}:1692") if kind == "zcol" else
        ("slab_window", tsn.sweep_window, tsn._sweep_window_plain,
         f"{tpu}:1429"))
    q = query.contiguous()
    before = sk.LAUNCHES[name]
    ms, win_k = cuda_ms(lambda: kernel(q, grid, **kw))
    launches = sk.LAUNCHES[name] - before
    check(launches == 6, f"{label}: {name} launched {launches} times in 6 "
          "calls")
    plain_ms, win_p = cuda_ms(lambda: plain(q, grid, **kw))
    for field in ("base", "slack", "complete"):
        a, b = getattr(win_k, field), getattr(win_p, field)
        check((a is None and b is None) or torch.equal(a, b),
              f"{label}: {name} {field} differs from plain")
    nan = torch.isnan(win_p.radius)
    check(torch.equal(torch.isnan(win_k.radius), nan) and torch.equal(
        win_k.radius.masked_fill(nan, 0).view(torch.int32),
        win_p.radius.masked_fill(nan, 0).view(torch.int32)),
        f"{label}: {name} radius differs from plain")
    t, slots = win_k.base.shape
    fused = win_k.slack is not None
    nbytes = t * 128 * 17 + t * slots * (16 if fused else 12)
    bound = nbytes / spec.hbm_bytes_per_s * 1e3
    trange = kw.get("trange", kw.get("zrange"))
    share = float(win_p.complete.float().mean())
    shape = (f"{t} tiles x {slots} slots, trange {trange}"
             f"{'' if fused else ', no masks'}")
    print(f"[3 windows] {label}: {name} {shape}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bytes bound {bound:.4f} ms ({nbytes} B); "
          f"base, slack, complete and radius bit-equal; complete "
          f"{share:.6f}; launches {launches}", flush=True)
    _record(results, name, (slots, trange, fused), dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
        floor_ms=None, max_abs_err=0.0, library_ms=None, pairs=0,
        bytes=nbytes, shape=shape, replaces=replaces, tiles=t))
    return win_k


def _distinct_rows(base, trange):
    """Rows in the union of each tile's slab windows [b, b + trange): the
    candidates K2 scans once each."""
    b = torch.sort(base.long(), dim=1).values
    gaps = torch.clamp(b[:, 1:] - b[:, :-1], max=trange)
    return int(gaps.sum()) + base.shape[0] * trange


def _sweep_k2(results, win, tgt_t, slabs, trange, tile_counts, replaces,
              spec, plain_reps=5):
    """K2 against plain on the first ``ct`` tiles of one window for each
    ``ct``; keyed (ct, slabs, trange). Pairs count each tile's distinct
    rows (the union of its slab windows), the work its queries need; the
    plain version and the TPU kernel sweep every lane, overlaps
    included."""
    from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import (
        colsweep,
        colsweep_plain,
        sweep_splits,
    )

    kw = dict(slabs=slabs, trange=trange, fused=False)
    for ct in tile_counts:
        args = (win.base[:ct].contiguous(),
                win.q32[:ct * 128].contiguous(), tgt_t)
        splits = sweep_splits(ct, slabs, trange, tgt_t.device)
        shape = f"{ct} tiles x {slabs} slabs, trange {trange}"
        lanes = ct * slabs * trange * 128
        entry = _timed_pair(
            f"K2 colsweep {shape} ({splits} splits, {lanes:.4e} lanes)",
            lambda: colsweep(*args, **kw),
            lambda: colsweep_plain(*args, **kw), _compare_sweep,
            _distinct_rows(args[0], trange) * 128,
            ct * 128 * 12 + ct * slabs * 4 + (tgt_t.shape[1] - trange) * 12
            + ct * 8 * 128 * 4, spec, plain_reps=plain_reps)
        entry.update(shape=shape, replaces=replaces, splits=splits)
        _record(results, "colsweep", (ct, slabs, trange), entry)


def _k3_kernel_ms(qq, tt, splits, reps=20):
    """K3's launch step alone at ``splits`` target splits (``brute_keys``:
    the key fill and the kernel, without the wrapper's decode and distance
    recomputation): CUDA events around ``reps`` back-to-back launches, per
    launch. The host enqueues a launch in far less than the kernel runs,
    so the card stays busy and the host's gaps drop out."""
    from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import brute_keys

    brute_keys(qq, tt, splits)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        brute_keys(qq, tt, splits)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _hold_k3(results, qq, tt, spec, replaces, full=True,
             library=True):
    """K3 against plain at (queries, targets) = the shapes of ``qq``,
    ``tt``, and the library yardstick. ``full``: the yardstick's median of
    3 and the kernel at other split counts (their keys must equal the
    chosen count's); else one timed yardstick call. ``library=False``
    skips the yardstick (phase 9's shapes past ``LIBRARY_PAIRS_MAX``
    pairs, on a 10M target's slabs, each a ~10 s chunked cdist; the
    kernel line's ``library_ms`` comes from a shape that has one)."""
    from iterativeclosestpoint_tpu_torch.ops.bruteforce import nn_bruteforce
    from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import (
        brute_keys,
        brute_splits,
        nn_brute,
    )

    def compare_brute(out_k, out_p):
        (ik, dk), (ip, dp) = out_k, out_p
        check(torch.equal(ik, ip), "K3: winners differ from plain")
        err = float((dk - dp).abs().max())
        check(err == 0.0, f"K3: distances differ from plain: {err}")
        return err, ""

    n_q, n_t = qq.shape[0], tt.shape[0]
    if (n_q, n_t) in results["brute_nn"]:
        return
    sms = torch.cuda.get_device_properties(qq.device).multi_processor_count
    tiles = -(-n_q // 128)
    splits = brute_splits(n_q, n_t, sms)
    cands = {splits}
    if full:
        cands |= {max(1, min(n_t // 1024, round(k * sms / tiles)))
                  for k in K3_CTAS_PER_SM}
    keys = brute_keys(qq, tt, splits)
    by_splits = {}
    for s in sorted(cands):
        check(torch.equal(brute_keys(qq, tt, s), keys),
              f"K3 at {s} splits: keys differ from {splits} splits")
        by_splits[s] = _k3_kernel_ms(qq, tt, s)
    entry = _timed_pair(
        f"K3 brute_nn {n_q} x {n_t} ({splits} splits, {tiles * splits} "
        "CTAs)", lambda: nn_brute(qq, tt),
        lambda: nn_bruteforce(qq, tt), compare_brute, n_q * n_t,
        (n_q + n_t) * 12 + n_q * 8, spec,
        library=(lambda: cdist_argmin(qq, tt)) if library else None,
        library_once=not full,
        device_ms=by_splits[splits], plain_reps=5 if full else 2)
    entry.update(shape=f"{n_q} x {n_t}", replaces=replaces, splits=splits)
    _record(results, "brute_nn", (n_q, n_t), entry)
    if full:
        print(f"[3 kernels] K3 {n_q} x {n_t} kernel ms by splits (CTAs per "
              "SM): " + ", ".join(f"{s} ({tiles * s / sms:.2f}): {ms:.4f}"
                                  for s, ms in by_splits.items()),
              flush=True)


def _repair_queries(tgt_local, cell, n, rng):
    """``n`` target points moved up to 1.2 fine cells per axis, so that
    many fine tiles decertify (the coarse repair stages' input)."""
    idx = rng.choice(len(tgt_local), n, replace=n > len(tgt_local))
    c = np.broadcast_to(np.asarray(cell, np.float32), (3,))
    return tgt_local[idx] + rng.uniform(-1.2 * c, 1.2 * c,
                                        (n, 3)).astype(np.float32)


def _stage_tiles(t):
    """The repair chain's coarse stage sizes (nn_colsweep_exact's
    ct_small, ct_mid and ct_full at the default 65536-query budget)."""
    ct_full = max(min(65536 // 128, t), 1)
    ct_small = max(min(64, ct_full // 2), 1)
    ct_mid = max(min(3 * ct_small, ct_full // 2), 1)
    return sorted({ct_small, ct_mid, ct_full})


def _hold_slab_grids(results, label, prepared, tgt_local, tgt_dev, rng,
                     spec, full=True, library=True, fine_tiles=(), slabs=4):
    """Every kernel one slab-sweep factory's nn_fn can launch, on its
    grids: the fine sweep over a whole layout of the target + N(0, 0.02)
    (K1, or K2's slot-wise form where the trange sends it there, also on
    the first tiles of that layout for each launched K2 shape in
    ``fine_tiles`` on this grid: a query layout of another tile count),
    K2 on the coarse repair grid at each stage size, and K3 at the brute
    tiers (512 and 4096 queries against the whole target). ``slabs``:
    the factory's slabs (6 for the host factory ``make_pallas_nn``)."""
    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
        grouped_tile_order_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
        use_fused_sweep,
    )

    tpu = "iterativeclosestpoint_tpu/ops/pallas_nn.py"
    fn, (grid, coarse, nrm), R = prepared
    m = tgt_dev.shape[0]
    trange = grid.tgt_t.shape[1] - m
    ctrange = coarse.tgt_t.shape[1] - m
    Rc = max(R // 4, 8)
    fused = use_fused_sweep(slabs, trange)
    normals = "none"
    if nrm is not None:
        for g in (grid, coarse):
            check(float(g.tgt_t[3:6, :m].abs().amax()) <= 1.0 + 1e-6
                  and bool((g.tgt_t[3:6, m:] == 0).all()),
                  f"{label}: rows 3-5 do not hold the normals")
        normals = (f"real, |n_z| median "
                   f"{float(grid.tgt_t[5, :m].abs().median()):.4f}")
    reps = 5 if full else 2
    print(f"[3 kernels] {label}: fine grid R={R} trange={trange} "
          f"({'K1' if fused else 'K2 slot-wise'}); coarse grid R={Rc} "
          f"trange={ctrange}; target {m} points; normals in rows 3-5: "
          f"{normals}", flush=True)
    gen = torch.Generator(device=tgt_dev.device).manual_seed(7)
    q = tgt_dev + 0.02 * torch.randn(tgt_dev.shape, generator=gen,
                                     device=tgt_dev.device)
    rows, _ = grouped_tile_order_device(q, grid.origin, grid.cell_size,
                                        resolution=R)
    ql = q[rows].contiguous()
    win = _hold_window(results, label, "slab", ql, grid, dict(
        resolution=R, tile_q=128, slabs=slabs, trange=trange, fused=fused),
        spec)
    if fused:
        _sweep_k1(results, win, grid.tgt_t, slabs, trange, f"{tpu}:1165",
                  spec, plain_reps=reps)
    else:
        t = win.base.shape[0]
        _sweep_k2(results, win, grid.tgt_t, slabs, trange, sorted(
            {t} | {sh[0] for sh in fine_tiles
                   if tuple(sh[1:]) == (slabs, trange) and sh[0] <= t}),
                  f"{tpu}:1025", spec, plain_reps=reps)

    cts = _stage_tiles(win.base.shape[0])
    n2 = cts[-1] * 128
    q2 = torch.as_tensor(
        _repair_queries(tgt_local, float(grid.cell_size), n2, rng),
        device=tgt_dev.device)
    rows2, _ = grouped_tile_order_device(q2, grid.origin, grid.cell_size,
                                         resolution=R)
    win2 = _hold_window(results, f"{label} coarse", "slab", q2[rows2][:n2],
                        coarse, dict(resolution=Rc, tile_q=128, slabs=slabs,
                                     trange=ctrange, fused=False), spec)
    _sweep_k2(results, win2, coarse.tgt_t, slabs, ctrange, cts,
              f"{tpu}:1025", spec)
    bt = 4096 // 128
    for nb in (max(bt // 8, 1), bt):
        _hold_k3(results, ql[:nb * 128].contiguous(), tgt_dev, spec,
                 f"{tpu}:1103", full=full,
                 library=library and nb * 128 * m <= LIBRARY_PAIRS_HELD)


def phase_kernels(data, vdata, data10, spec):
    """Each kernel against its plain version at every shape the main paths
    can launch it with. Returns {name: {key: [entry, ...]}}; a key is the
    launch shape the wrapper tallies in ``LAUNCH_SHAPES`` (K1: (slabs,
    trange), its tile count follows the query layout)."""
    from iterativeclosestpoint_tpu_torch.models.prep import prepare_level
    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
        build_zgrid,
        grouped_tile_order_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
        estimate_grid_params,
    )

    dev = torch.device(DEVICE)
    tpu = "iterativeclosestpoint_tpu/ops/pallas_nn.py"
    results = {"colsweep_fused": {}, "colsweep": {}, "colsweep_fused_ft": {},
               "colsweep_ft": {}, "brute_nn": {}, "slab_window": {},
               "zcol_window": {}}
    rng = np.random.default_rng(7)

    def coarse_level(d, stride):
        return (torch.as_tensor(np.ascontiguousarray(
                    d["src_local"][::stride]), device=dev),
                torch.as_tensor(np.ascontiguousarray(
                    d["tgt_local"][::stride]), device=dev))

    # Terrain 1M: the plane path's grids (with normals); the headline's
    # point grids have the same shapes.
    _, prep, prep2, _ = prepare_level(data["src"], data["tgt"], dev,
                                      nn_backend="pallas", estimator="plane",
                                      two_stage=True)
    check(prep2 is None, "1M terrain: the two-stage gate opened")
    tgt_dev = torch.as_tensor(data["tgt_local"], device=dev)
    _hold_slab_grids(results, "terrain 1M", prep, data["tgt_local"],
                     tgt_dev, rng, spec)
    # K3 at the coarse level's shape (stride 34); the volume run launches
    # it at this same shape.
    stride = -(-len(data["src"]) // HEADLINE_KW["coarse_max_points"])
    _hold_k3(results, *coarse_level(data, stride), spec,
             f"{tpu}:1103")
    del prep, tgt_dev

    # Terrain 10M, the two-stage plane level: the base and boosted grids
    # (with normals), the middle level's own grid (stride 18, point mode)
    # and the first coarse level (stride 334).
    _, prep, prep2, _ = prepare_level(data10["src"], data10["tgt"], dev,
                                      nn_backend="pallas", estimator="plane",
                                      two_stage=True)
    check(prep2 is not None, "10M terrain: the two-stage gate refused")
    tgt_dev = torch.as_tensor(data10["tgt_local"], device=dev)
    for label, p in (("terrain 10M base", prep),
                     ("terrain 10M boosted", prep2)):
        _hold_slab_grids(results, label, p, data10["tgt_local"], tgt_dev,
                         rng, spec, full=False)
    del prep, prep2, tgt_dev
    n10 = len(data10["src"])
    strides = [-(-n10 // HEADLINE_KW["coarse_max_points"])]
    while strides[-1] > 64:
        strides.append(max(2, int(round(strides[-1] ** 0.5))))
    check(len(strides) == 2, f"10M ladder {strides}")
    _hold_k3(results, *coarse_level(data10, strides[0]), spec,
             f"{tpu}:1103", full=False)
    # The middle level's own prep, as icp_register makes it (the coarse
    # levels' backend "auto" is the slab sweep at its size).
    (_, mid_dev, _), mid_nn, _, _ = prepare_level(
        data10["src"][::strides[1]], data10["tgt"][::strides[1]], dev,
        nn_backend="auto")
    check(hasattr(mid_nn[0], "layout_group"),
          "10M middle level: backend auto did not pick the slab sweep")
    _hold_slab_grids(results, f"terrain 10M middle level (stride "
                     f"{strides[1]})", mid_nn, mid_dev.cpu().numpy(),
                     mid_dev, rng, spec, full=False)
    del mid_dev, mid_nn

    # Volume: the z-column sweep on anisotropic cells.
    tgt_local = vdata["tgt_local"]
    tgt_dev = torch.as_tensor(tgt_local, device=dev)
    est = estimate_grid_params(tgt_local)
    R, ctrange, zrange = est[0], est[2], est[4]
    fn, (zgrid, coarse, _), _ = make_pallas_nn_device(
        tgt_local, target_dev=tgt_dev, est=est)
    check(fn.layout_group == "xy", "the volume pair did not select zcol")
    Rc = max(R // 4, 8)
    cell3 = zgrid.cell_size.cpu().numpy()
    print(f"[3 kernels] volume: fine z-grid R={R} zrange={zrange} cells "
          f"{cell3.tolist()}; coarse grid R={Rc} trange={ctrange}; target "
          f"{len(tgt_local)} points", flush=True)
    qv = torch.as_tensor(
        tgt_local + rng.normal(0, 0.02, tgt_local.shape).astype(np.float32),
        device=dev)
    rows, _ = grouped_tile_order_device(qv, zgrid.origin, zgrid.cell_size,
                                        resolution=R, group="xy")
    win = _hold_window(results, "volume", "zcol", qv[rows], zgrid, dict(
        resolution=R, tile_q=128, zrange=zrange, fused=True), spec)
    _sweep_k1(results, win, zgrid.tgt_t, 12, zrange, f"{tpu}:1833",
              spec)

    # K2 on the volume's coarse grid, fed by the fine (x, y)-group layout
    # as nn_colsweep_exact feeds it.
    cts = _stage_tiles(win.base.shape[0])
    n2 = cts[-1] * 128
    q2 = torch.as_tensor(_repair_queries(tgt_local, cell3, n2, rng),
                         device=dev)
    rows2, _ = grouped_tile_order_device(q2, zgrid.origin, zgrid.cell_size,
                                         resolution=R, group="xy")
    win2 = _hold_window(results, "volume coarse", "slab", q2[rows2][:n2],
                        coarse, dict(resolution=Rc, tile_q=128, slabs=4,
                                     trange=ctrange, fused=False), spec)
    _sweep_k2(results, win2, coarse.tgt_t, 4, ctrange, cts, f"{tpu}:1025",
              spec)

    # K2 as the z-column sweep's slot-wise form (12 unmasked slots), on a
    # z-grid with a zrange past the fused gate.
    zg2 = build_zgrid(tgt_dev, zgrid.origin, zgrid.cell_size, resolution=R,
                      zrange=ZCOL_SLOTWISE)
    win3 = _hold_window(results, "volume slot-wise", "zcol", qv[rows], zg2,
                        dict(resolution=R, tile_q=128, zrange=ZCOL_SLOTWISE,
                             fused=False), spec)
    _sweep_k2(results, win3, zg2.tgt_t, 12, ZCOL_SLOTWISE,
              [SLOTWISE_TILES], f"{tpu}:1833", spec)
    return results


def _shape_key(name, shape):
    """The phase-3 key of a launch tallied as ``(name, shape)`` (K1's
    forms and the windows leave out the tile count)."""
    return (shape[1:] if name.startswith("colsweep_fused")
            or name.endswith("_window") else shape)


def _final_pose(tag, data, transform, prepared, sample=None,
                by_winner=False):
    """Exactness at a final pose: the fine sweep's certified fraction over
    real rows, and the exact chain's distances (and, with normals, each
    returned normal against the target's normal at the winner, bit for
    bit) against cKDTree on the real rows, or on a seeded sample of
    ``sample`` of them. ``by_winner``: for queries far from the target,
    where one f32 ulp of the distance exceeds 1e-6 m (the sliding edges
    of the multi-scan job), each returned point's f64 distance from its
    query must be cKDTree's (it is a nearest neighbour) within 1e-9 m, and
    each returned f32 distance must be that point's, recomputed by
    ``winner_dist``, bit for bit."""
    from iterativeclosestpoint_tpu_torch.models.icp import (
        _prep_fine_source,
        _rebase_transform,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        nn_colsweep,
        nn_colsweep_z,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
        use_fused_sweep,
    )
    from scipy.spatial import cKDTree

    dev = torch.device(DEVICE)
    nn_fn, state, R = prepared
    tgt_local = data["tgt_local"]
    m = len(tgt_local)
    tgt_dev = torch.as_tensor(tgt_local, device=dev)
    trange = state[0].tgt_t.shape[1] - m
    T_loc = torch.as_tensor(_rebase_transform(transform, -data["offset"]),
                            dtype=torch.float32, device=dev)
    q, _, w = _prep_fine_source(
        torch.as_tensor(data["src_local"], device=dev), T_loc,
        state[0].origin, state[0].cell_size, resolution=R,
        group=nn_fn.layout_group)
    real = w > 0
    if nn_fn.layout_group == "xy":
        cert = nn_colsweep_z(q, state[0], resolution=R, zrange=trange)[3]
    else:
        cert = nn_colsweep(q, state[0], resolution=R, slabs=4,
                           trange=trange, fused=use_fused_sweep(4, trange))[3]
    frac = float(cert[real].float().mean())
    out = nn_fn(q, tgt_dev, state)
    rows = torch.nonzero(real).squeeze(1)
    if sample is not None:
        gen = torch.Generator(device=dev).manual_seed(7)
        rows = rows[torch.randperm(rows.shape[0], generator=gen,
                                   device=dev)[:sample]]
    qh = q[rows].cpu().numpy().astype(np.float64)
    tree = cKDTree(tgt_local.astype(np.float64))
    d_ref, _ = tree.query(qh, workers=-1)
    gap = float(np.abs(out[1][rows].cpu().numpy() - d_ref).max())
    note = ""
    if nn_fn.with_normals:
        matched = out[0][rows].cpu().numpy().astype(np.float64)
        d0, win = tree.query(matched, workers=-1)
        check(not d0.any(), f"{tag}: a matched point is not a target point")
        nrm_ref = state[2][torch.as_tensor(win, device=dev)]
        same = torch.equal(out[2][rows], nrm_ref)
        note = (f"; normals equal normals[winner] on all {len(qh)} rows: "
                f"{same}")
        check(same, f"{tag}: a returned normal is not its winner's")
    if by_winner:
        from iterativeclosestpoint_tpu_torch.ops.bruteforce import (
            winner_dist,
        )

        matched = out[0][rows]
        d_win = np.linalg.norm(matched.cpu().numpy().astype(np.float64)
                               - qh, axis=1)
        wgap = float(np.abs(d_win - d_ref).max())
        recomputed = torch.equal(
            out[1][rows], winner_dist(q[rows], matched,
                                      torch.arange(rows.shape[0],
                                                   device=dev)))
        note += (f"; max cKDTree distance {d_ref.max():.3f} m; winners' "
                 f"f64 distance - cKDTree {wgap:.3e} m; dist = winner_dist "
                 f"bit for bit: {recomputed}")
        check(wgap <= 1e-9, f"{tag}: a returned point is not a nearest "
              f"neighbour: {wgap}")
        check(recomputed, f"{tag}: a distance is not its winner's")
    print(f"[{tag}] final pose: certified {frac:.6f} of "
          f"{int(real.sum())} real queries at the fine level "
          f"({q.shape[0]} laid out); max |dist - cKDTree| {gap:.3e} m over "
          f"{len(qh)} rows{note}", flush=True)
    if not by_winner:
        check(gap <= 1e-6, f"{tag}: final-pose NN not exact: {gap}")


def _launch_checks(tag, by_shape, measured, launches):
    for (name, shape), c in sorted(by_shape.items()):
        print(f"[{tag}] launches {name} {shape}: {c}")
        check(_shape_key(name, shape) in measured[name],
              f"the {tag} run launched {name} at {shape}, a shape phase 3 "
              "did not hold against plain")
    check(launches["colsweep_fused"] > 0, "K1 never launched")
    check(launches["brute_nn"] > 0, "K3 never launched")


def _breakdown(tag, data, kw):
    """One synced run under the stage collector; returns the fine loop's
    seconds and the run's result."""
    from iterativeclosestpoint_tpu_torch import icp_register_multiscale
    from iterativeclosestpoint_tpu_torch.runtime.timing import collect

    with collect(sync=True) as col:
        res = icp_register_multiscale(data["src"], data["tgt"], **kw)
    for line in col.lines():
        print(f"[{tag}] breakdown: {line}")
    loop_s = col.stages["fine/loop"]  # both stages of a two-stage level
    iters = res.final.iterations
    print(f"[{tag}] fine loop {loop_s * 1e3 / iters:.4f} ms/iteration, "
          f"{len(data['src']) * iters / loop_s:.1f} points/s (synced run)",
          flush=True)
    return res


def phase_main_path(tag, data, measured, zcol, kw):
    """One main path at full width: the terrain headline, the uniform box
    (``zcol``: the regime gate must pick the z-column sweep) or the plane
    row."""
    from torch.profiler import ProfilerActivity, profile

    from iterativeclosestpoint_tpu_torch import icp_register_multiscale
    from iterativeclosestpoint_tpu_torch.models.prep import prepare_level
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops.se3 import registration_error

    src, tgt, T_true = data["src"], data["tgt"], data["T_true"]
    n = len(src)
    iters = kw["max_iterations"]
    kw = dict(kw, device=DEVICE)
    res = icp_register_multiscale(src, tgt, **kw)  # warm-up
    times = []
    for _ in range(3):
        sk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp_register_multiscale(src, tgt, **kw)
        times.append(time.perf_counter() - t0)
        launches = dict(sk.LAUNCHES)
        by_shape = dict(sk.LAUNCH_SHAPES)
    fine = res.final
    check(fine.iterations == iters, f"fine iterations {fine.iterations}")
    best = min(times)
    print(f"[{tag}] runs: {', '.join(f'{t:.4f}' for t in times)} s; "
          f"best {best:.4f} s -> {n * iters / best:.1f} points/s blended; "
          f"nn_resolution {fine.nn_resolution}; launches per run "
          f"{launches}", flush=True)
    _launch_checks(tag, by_shape, measured, launches)
    if zcol:
        check(any(name == "colsweep_fused" and shape[1] == 12
                  for name, shape in by_shape),
              "K1 never launched at 12 z-window slots")

    _breakdown(tag, data, kw)

    # One run under torch.profiler: the device's busy time (one stream,
    # so the kernels' summed time) and the kernels ranked by device time.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        icp_register_multiscale(src, tgt, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e6  # us -> s
    check(busy > 0, "the profiler saw no device time")
    print(f"[{tag}] profiled run: {wall:.4f} s wall under the "
          f"profiler, {len(kernels)} device kernels, {busy:.4f} s device "
          f"busy; idle share {1 - busy / wall:.4f} against the profiled "
          f"wall, {1 - busy / best:.4f} against the best unprofiled run",
          flush=True)
    by_name: dict = {}
    for e in kernels:
        t_us, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t_us + e.device_time, c + 1)
    for name, (t_us, c) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:12]:
        print(f"[{tag}] device {t_us / 1e3:10.4f} ms {c:6d} "
              f"launches  {name[:100]}")

    pts = torch.as_tensor(src, dtype=torch.float64)
    err = float(registration_error(torch.as_tensor(fine.transform),
                                   torch.as_tensor(T_true), pts))
    print(f"[{tag}] rmse {fine.rmse:.6f}, stop {fine.message!r}, "
          f"coarse {res.levels[0][1].iterations} iterations, "
          f"registration_error vs T_true {err:.6f} m (not gated)",
          flush=True)

    if kw.get("estimator") == "plane":
        check(not _gate(tag, data["tgt_local"]),
              f"{tag}: the two-stage gate opened")
    _, prepared, prepared2, _ = prepare_level(
        src, tgt, torch.device(DEVICE), nn_backend="pallas",
        estimator=kw.get("estimator", "point"), two_stage=True)
    check(prepared2 is None, f"{tag}: the two-stage gate opened")
    check((prepared[0].layout_group == "xy") == zcol,
          f"regime gate picked layout {prepared[0].layout_group!r}")
    _final_pose(tag, data, fine.transform, prepared)
    return by_shape, res


def _gate(tag, tgt_local):
    """The two-stage gate's inputs: (R, base, trange, zrange) and the
    16-points-per-cell boost test at 2·base; returns whether it opens."""
    from iterativeclosestpoint_tpu_torch.ops.cellblock import (
        surface_boost_ok,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
        estimate_grid_params,
    )

    R, trange, _, base, zrange = estimate_grid_params(tgt_local)
    boost = surface_boost_ok(tgt_local, 2 * base, occupancy=16)
    print(f"[{tag}] two-stage gate: R={R}, base={base}, trange={trange}, "
          f"zrange={zrange}, surface_boost_ok(2·base, occupancy=16) "
          f"{boost}", flush=True)
    return R == base and zrange is None and trange < 2048 and boost


def phase_plane_10m(data, measured):
    """The two-stage plane level at 10M points: the gate's construction
    guard, one warm-up and one timed run, a synced breakdown, the boosted
    resolution, and exactness at the final pose on a sample."""
    from iterativeclosestpoint_tpu_torch import icp_register_multiscale
    from iterativeclosestpoint_tpu_torch.models.prep import prepare_level
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops.cellblock import (
        auto_resolution_data,
    )
    from iterativeclosestpoint_tpu_torch.ops.se3 import registration_error

    tag = "4d plane 10M"
    src, tgt = data["src"], data["tgt"]
    check(_gate(tag, data["tgt_local"]),
          "10M terrain: the two-stage gate's construction guard fails")
    base = auto_resolution_data(data["tgt_local"],
                                surface_boost_occupancy=32,
                                return_base=True)[1]
    kw = dict(PLANE_KW, device=DEVICE)
    iters = kw["max_iterations"]
    icp_register_multiscale(src, tgt, **kw)  # warm-up
    sk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = icp_register_multiscale(src, tgt, **kw)
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    by_shape = dict(sk.LAUNCH_SHAPES)
    fine = res.final
    print(f"[{tag}] run: {wall:.4f} s -> {len(src) * iters / wall:.1f} "
          f"points/s blended; levels "
          f"{[(s, r.iterations, r.nn_resolution) for s, r in res.levels]}; "
          f"launches {launches}", flush=True)
    check(fine.nn_resolution == 2 * base,
          f"fine nn_resolution {fine.nn_resolution}, expected {2 * base}")
    check(fine.iterations == iters, f"fine iterations {fine.iterations}")
    _launch_checks(tag, by_shape, measured, launches)
    _breakdown(tag, data, kw)
    err = float(registration_error(
        torch.as_tensor(fine.transform), torch.as_tensor(data["T_true"]),
        torch.as_tensor(src[::10], dtype=torch.float64)))
    print(f"[{tag}] rmse {fine.rmse:.6f}, stop {fine.message!r}, "
          f"registration_error vs T_true {err:.6f} m over every 10th "
          "point (not gated)", flush=True)
    _, _, prepared2, _ = prepare_level(
        src, tgt, torch.device(DEVICE), nn_backend="pallas",
        estimator=kw["estimator"], two_stage=True)
    _final_pose(tag, data, fine.transform, prepared2, sample=SAMPLE_10M)
    return by_shape


def phase_repair():
    from iterativeclosestpoint_tpu_torch import icp_register
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
        grouped_tile_order_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
    )
    from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset
    from iterativeclosestpoint_tpu_torch.utils.synth import make_cloud
    from scipy.spatial import cKDTree

    dev = torch.device(DEVICE)
    tgt = make_cloud(REPAIR_N, seed=11, kind="terrain", extent=100.0)
    offset = center_offset(tgt)
    tgt_local = (tgt - offset).astype(np.float32)
    tgt_dev = torch.as_tensor(tgt_local, device=dev)
    nn_fn, state, R = make_pallas_nn_device(tgt_local, target_dev=tgt_dev)
    cell = float(state[0].cell_size)
    rng = np.random.default_rng(11)
    src = tgt + np.array([2.5 * cell, 2.5 * cell, 0.0]) + rng.normal(
        0, 0.02, tgt.shape)
    src_dev = torch.as_tensor((src - offset).astype(np.float32), device=dev)
    rows, w = grouped_tile_order_device(src_dev, state[0].origin,
                                        state[0].cell_size, resolution=R)
    sk.reset_launches()
    _, d = nn_fn(src_dev[rows], tgt_dev, state)
    first = dict(sk.LAUNCHES)
    real = w > 0
    qh = src_dev[rows][real].cpu().numpy().astype(np.float64)
    d_ref, _ = cKDTree(tgt_local.astype(np.float64)).query(qh, workers=-1)
    gap = np.abs(d[real].cpu().numpy() - d_ref)
    check(np.all(gap <= 1e-6 + 2e-7 * d_ref),
          f"repair-path NN not exact: {gap.max()}")
    sk.reset_launches()
    res = icp_register(src, tgt, nn_backend="pallas", max_iterations=5,
                       tolerance=0.0, return_registered=False, device=DEVICE)
    launches = dict(sk.LAUNCHES)
    print(f"[5 repair] {REPAIR_N} points, R={R}, cell {cell:.4f} m, shift 2.5 cells: first "
          f"NN launches {first}, max |dist - cKDTree| {gap.max():.3e} m; "
          f"5 iterations launches {launches}, rmse {res.rmse:.6f}",
          flush=True)
    check(first["colsweep"] > 0 and launches["colsweep"] > 0,
          "K2 never launched on the repair path")
    return launches


def _same_history(a, b):
    """Bit-equal histories, transforms and stop codes of two results."""
    return (a.iterations == b.iterations and a.stop_reason == b.stop_reason
            and np.array_equal(a.transform, b.transform)
            and all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
                "history_rmse", "history_valid", "history_transform",
                "history_mean_dist", "history_std_dist",
                "history_threshold")))


def phase_card_vs_cpu(data):
    """The same multiscale runs on the card and on the CPU; then the
    card's segmented, resumed and normal-estimation runs against their
    one-dispatch and repeated twins. ``data``: the 1M terrain pair."""
    from iterativeclosestpoint_tpu_torch import (
        icp_register,
        icp_register_multiscale,
    )
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops.cellblock import (
        auto_resolution_data,
    )
    from iterativeclosestpoint_tpu_torch.ops.normals import (
        estimate_normals_cellpca_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
    )

    terrain = dict(n=CARD_CPU_N, seed=95, noise_sigma=0.01)
    cases = [
        ("terrain", terrain, dict(max_iterations=15)),
        # The uniform box selects the z-column sweep; fine iterations are
        # capped (6) because the CPU runs K1's plain version over 12 slots.
        ("uniform box", dict(n=BOX_N, seed=7, noise_sigma=0.02,
                             kind="uniform", extent=100.0),
         dict(max_iterations=6)),
        ("terrain two-stage plane", TWO_STAGE, TWO_STAGE_KW),
        ("terrain tukey", terrain, dict(max_iterations=15, robust="tukey")),
    ]
    two_stage_card = None
    for label, config, extra in cases:
        data_c = make_data(config)
        src, tgt = data_c["src"], data_c["tgt"]
        kw = {"coarse_max_points": 10_000, "nn_backend": "pallas",
              "return_registered": False, **extra}
        layouts = [make_pallas_nn_device(data_c["tgt_local"], device=d)[0]
                   .layout_group for d in (DEVICE, "cpu")]
        sk.reset_launches()
        t0 = time.perf_counter()
        card = icp_register_multiscale(src, tgt, device=DEVICE, **kw)
        t1 = time.perf_counter()
        by_shape = dict(sk.LAUNCH_SHAPES)
        cpu = icp_register_multiscale(src, tgt, device="cpu", **kw)
        t2 = time.perf_counter()
        levels_card = [(s, r.iterations, r.stop_reason)
                       for s, r in card.levels]
        levels_cpu = [(s, r.iterations, r.stop_reason)
                      for s, r in cpu.levels]
        Ta, Tb = card.transform, cpu.transform
        err = float(np.linalg.norm(
            (src @ Ta[:3, :3].T + Ta[:3, 3])
            - (src @ Tb[:3, :3].T + Tb[:3, 3]), axis=1).max())
        k1 = sorted(sh for nm, sh in by_shape if nm == "colsweep_fused")
        res_pair = (card.final.nn_resolution, cpu.final.nn_resolution)
        print(f"[6 card vs cpu] {label}, {len(src)} points, layouts "
              f"{layouts}, card K1 shapes {k1}: card {levels_card} in "
              f"{t1 - t0:.3f} s, cpu {levels_cpu} in {t2 - t1:.3f} s, "
              f"fine nn_resolution {res_pair}, registration_error "
              f"{err:.3e} m", flush=True)
        want = "xy" if config.get("kind") == "uniform" else "x"
        check(layouts == [want, want],
              f"{label}: regime gate picked {layouts}, expected {want}")
        if want == "xy":
            check(any(sh[1] == 12 for sh in k1),
                  f"{label}: K1 never launched at 12 slots on the card")
        check(levels_card == levels_cpu,
              f"{label}: iteration counts or stop codes differ")
        check(err <= 1e-4, f"{label}: card and cpu disagree: {err} m")
        if extra is TWO_STAGE_KW:
            base = auto_resolution_data(tgt, surface_boost_occupancy=32,
                                        return_base=True)[1]
            check(res_pair == (2 * base, 2 * base),
                  f"{label}: fine nn_resolution {res_pair}, expected "
                  f"{2 * base} on both")
            two_stage_card = (data_c, kw, card)

    # The card alone: segments, resume and normals are bit-identical.
    data_c, kw, one = two_stage_card
    seg = icp_register_multiscale(data_c["src"], data_c["tgt"],
                                  device=DEVICE, segment_iterations=3, **kw)
    same_seg = _same_history(seg.final, one.final)
    pair = dict(nn_backend="pallas", estimator="plane", tolerance=0.0,
                return_registered=False, device=DEVICE)
    full = icp_register(data_c["src"], data_c["tgt"], max_iterations=10,
                        **pair)
    states = []
    first = icp_register(data_c["src"], data_c["tgt"], max_iterations=5,
                         segment_iterations=5,
                         segment_callback=states.append, **pair)
    rest = icp_register(data_c["src"], data_c["tgt"], max_iterations=5,
                        resume_carry=states[-1], **pair)
    for f in ("history_rmse", "history_valid", "history_transform",
              "history_mean_dist", "history_std_dist", "history_threshold"):
        setattr(rest, f, np.concatenate([getattr(first, f),
                                         getattr(rest, f)]))
    rest.iterations += first.iterations
    same_resume = _same_history(rest, full)
    dev = torch.device(DEVICE)
    tgt_dev = torch.as_tensor(data["tgt_local"], device=dev)
    base = auto_resolution_data(data["tgt_local"],
                                surface_boost_occupancy=32,
                                return_base=True)[1]
    tmin = data["tgt_local"].min(axis=0)
    cell = max(float((data["tgt_local"].max(axis=0) - tmin).max()) / base,
               1e-9)
    args = (tgt_dev, torch.as_tensor(tmin, device=dev),
            torch.tensor(cell, dtype=torch.float32, device=dev))
    ms, n1 = cuda_ms(lambda: estimate_normals_cellpca_device(
        *args, resolution=base))
    n2 = estimate_normals_cellpca_device(*args, resolution=base)
    same_normals = torch.equal(n1, n2)
    print(f"[6 card] two-stage plane in segments of 3 == one dispatch: "
          f"{same_seg}; 5 + 5 resumed through resume_carry == 10 "
          f"iterations ({full.iterations} recorded): {same_resume}; two "
          f"estimations of the 1M target's normals (R={base}) bit-equal: "
          f"{same_normals}, {ms:.4f} ms each (CUDA-event median of 5)",
          flush=True)
    check(same_seg, "segmented plane run differs from one dispatch")
    check(same_resume, "resumed run differs from the uninterrupted one")
    check(same_normals, "normal estimation is not deterministic")


def _spy_pallas_grids():
    """Keep the grids each pallas run builds (``make_pallas_nn_device`` as
    ``models/prep.py`` calls it), to hold the run's launches on them.
    Returns (kept, restore); kept holds (target_local, (fn, state, R))."""
    from iterativeclosestpoint_tpu_torch.models import prep

    orig = prep.make_pallas_nn_device
    kept = []

    def spy(*a, target_dev, **k):
        out = orig(*a, target_dev=target_dev, **k)
        kept.append((target_dev.cpu().numpy().astype(np.float32), out))
        return out

    prep.make_pallas_nn_device = spy

    def restore():
        prep.make_pallas_nn_device = orig

    return kept, restore


def _hold_small_runs(tag, by_shape, measured, spec, kept):
    """Hold every shape ``by_shape`` launched that no phase held yet, on
    the grids the runs built (``kept``, small targets): K1 on a layout of
    the target + N(0, 0.02), K2 on the coarse grid at each launched tile
    count (repair queries), K3 against the whole target."""
    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
        grouped_tile_order_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
        use_fused_sweep,
    )

    tpu = "iterativeclosestpoint_tpu/ops/pallas_nn.py"
    unheld = _unheld(by_shape, measured)
    print(f"[{tag}] launches by shape {sorted(by_shape.items())}; shapes "
          f"no phase held yet: {unheld}", flush=True)
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(9)
    for tgt_local, (_, (grid, coarse, _), R) in kept:
        left = _unheld(by_shape, measured)
        if not left:
            break
        if grid.tgt_t.device.type != "cuda":  # a CPU run's grids
            continue
        tgt_dev = torch.as_tensor(tgt_local, device=dev)
        m = tgt_dev.shape[0]
        trange = grid.tgt_t.shape[1] - m
        ctrange = coarse.tgt_t.shape[1] - m
        gen = torch.Generator(device=dev).manual_seed(7)
        q = tgt_dev + 0.02 * torch.randn(tgt_dev.shape, generator=gen,
                                         device=dev)
        rows, _ = grouped_tile_order_device(q, grid.origin, grid.cell_size,
                                            resolution=R)
        ql = q[rows].contiguous()
        fused = use_fused_sweep(4, trange)
        if ("colsweep_fused", (4, trange)) in [
                (nm, _shape_key(nm, sh)) for nm, sh in left]:
            _sweep_k1(measured, _hold_window(
                measured, tag, "slab", ql, grid, dict(
                    resolution=R, tile_q=128, slabs=4, trange=trange,
                    fused=True), spec), grid.tgt_t, 4, trange,
                f"{tpu}:1165", spec, plain_reps=2)
        for nm, sh in left:
            if nm != "colsweep" or sh[1] != 4 or sh[2] not in (trange,
                                                               ctrange):
                continue
            ct, tr = sh[0], sh[2]
            g, r_g = (coarse, max(R // 4, 8)) if tr == ctrange and (
                tr != trange or fused) else (grid, R)
            qq = torch.as_tensor(_repair_queries(
                tgt_local, float(grid.cell_size), ct * 128, rng),
                device=dev)
            order, _ = grouped_tile_order_device(
                qq, grid.origin, grid.cell_size, resolution=R)
            _sweep_k2(measured, _hold_window(
                measured, tag, "slab", qq[order][:ct * 128], g, dict(
                    resolution=r_g, tile_q=128, slabs=4, trange=tr,
                    fused=False), spec), g.tgt_t, 4, tr, [ct],
                f"{tpu}:1025", spec, plain_reps=2)
        for nm, sh in _unheld(by_shape, measured):
            if nm == "brute_nn" and sh[1] == m:
                qk = ql.repeat(-(-sh[0] // ql.shape[0]), 1)[:sh[0]]
                _hold_k3(measured, qk.contiguous(), tgt_dev, spec,
                         f"{tpu}:1103", full=False)
    check(not _unheld(by_shape, measured), f"{tag}: a shape is unheld")


def _outcome(fn, *args, **kw):
    """(stop code, iterations, success, message) of a run, or the
    exception it raised as text (printed, then failed by the caller)."""
    try:
        r = fn(*args, **kw)
    except Exception as e:
        return f"raised {type(e).__name__}: {e}"
    r = getattr(r, "final", r)
    return r.stop_reason, r.iterations, r.success, r.message


def phase_nonfinite(measured, spec):
    """Phase 6's non-finite case: one NaN source coordinate stops the run
    with NUMERICAL_ERROR (6) before any iteration is recorded, on the card
    as on the CPU, as the JAX package's loop does; the public ``kabsch``
    returns a NaN transform on the card."""
    from iterativeclosestpoint_tpu_torch import (
        icp_register,
        icp_register_multiscale,
    )
    from iterativeclosestpoint_tpu_torch.models.icp import NUMERICAL_ERROR
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops.kabsch import kabsch
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    src, tgt, _ = make_registration_pair(**NONFINITE)
    src = src.copy()
    src[13, 1] = np.nan
    cases = [(f"icp_register {be} {str(dt)[6:]}", icp_register,
              dict(nn_backend=be, dtype=dt))
             for be in ("pallas", "bruteforce")
             for dt in (torch.float32, torch.float64)]
    cases.append(("icp_register_multiscale pallas float32",
                  icp_register_multiscale,
                  dict(nn_backend="pallas", dtype=torch.float32)))
    kept, restore = _spy_pallas_grids()
    sk.reset_launches()
    try:
        card = [_outcome(fn, src, tgt, max_iterations=10, device=DEVICE,
                         **kw) for _, fn, kw in cases]
    finally:
        restore()
    by_shape = dict(sk.LAUNCH_SHAPES)
    cpu = [_outcome(fn, src, tgt, max_iterations=10, device="cpu", **kw)
           for _, fn, kw in cases]
    for (label, _, _), a, b in zip(cases, card, cpu):
        print(f"[6 nonfinite] {label}, source[13, 1] = NaN: card {a}; "
              f"cpu {b}", flush=True)
    for (label, _, _), a, b in zip(cases, card, cpu):
        check(a == b and a[:3] == (NUMERICAL_ERROR, 0, False),
              f"{label}: card {a}, cpu {b}; expected stop code "
              f"{NUMERICAL_ERROR} after 0 iterations on both")
    dev = torch.device(DEVICE)
    T = kabsch(torch.as_tensor(src, device=dev),
               torch.as_tensor(tgt, device=dev)).cpu().numpy()
    print(f"[6 nonfinite] kabsch on the card: rotation and translation "
          f"all NaN {bool(np.isnan(T[:3]).all())}, last row {T[3]}; "
          f"launches {dict(sk.LAUNCHES)}", flush=True)
    check(bool(np.isnan(T[:3]).all()) and T[3].tolist() == [0, 0, 0, 1],
          "kabsch on a NaN source is not the NaN transform")
    _hold_small_runs("6 nonfinite", by_shape, measured, spec, kept)


def _cli(*argv, expect_ok=True):
    """``icp-torch`` in this process (``cli.main``), its standard output
    captured; returns (exit code, output)."""
    from iterativeclosestpoint_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    out = buf.getvalue()
    if expect_ok:
        check(rc == 0, f"icp-torch {argv[0]} exited {rc}: {out[-3000:]}")
    return rc, out


def _iteration_rows(path):
    rows = [json.loads(line) for line in open(path)]
    return [{k: v for k, v in r.items() if k != "ts"} for r in rows
            if r["kind"] == "iteration"]


def phase_product(measured, spec):
    """Phase 7, the product surface: ``icp-torch`` (``cli.main``) on the
    card in a temporary directory. (a) synth a 1M terrain pair as LAS and
    info; (b) smoke; (c) a multiscale pallas run with metrics, history,
    checkpoint and HTML, held against the library call on the decoded
    clouds and against cKDTree at its final pose; (d) resume and live
    segments on a 250k pair, bit for bit; (e) replay, status and view;
    (f) the unported options exit non-zero with their item. Returns the
    launches by shape of run (c)."""
    import tempfile
    from pathlib import Path

    from iterativeclosestpoint_tpu_torch import icp_register_multiscale
    from iterativeclosestpoint_tpu_torch.io.las import read_las
    from iterativeclosestpoint_tpu_torch.models.prep import prepare_level
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops.se3 import registration_error
    from iterativeclosestpoint_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
    )
    from iterativeclosestpoint_tpu_torch.runtime.metrics import (
        read_history_json,
    )
    from iterativeclosestpoint_tpu_torch.runtime.timing import collect
    from iterativeclosestpoint_tpu_torch.utils.config import ICPConfig
    from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset

    dev = torch.device(DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        src_las, tgt_las = d / "src.las", d / "tgt.las"
        # (a) synth + info
        t0 = time.perf_counter()
        _cli("synth", src_las, tgt_las, "--n", PRODUCT_N, "--seed", 7,
             "--noise", 0.02, "--transform-out", d / "truth.json")
        t1 = time.perf_counter()
        _, info = _cli("info", src_las, "--full")
        print(f"[7a synth] {PRODUCT_N} + {PRODUCT_N} points written in "
              f"{t1 - t0:.3f} s ({src_las.stat().st_size} bytes each); "
              "info --full: " + "; ".join(
                  ln for ln in info.splitlines() if "bounds" in ln),
              flush=True)

        # (b) smoke: both regimes' exact chains against K3
        sk.reset_launches()
        t0 = time.perf_counter()
        _, out = _cli("smoke")
        print(f"[7b smoke] {time.perf_counter() - t0:.3f} s, launches "
              f"{dict(sk.LAUNCHES)}: " + "; ".join(out.splitlines()),
              flush=True)
        check(out.count("exact vs brute force OK on cuda") == 2,
              f"smoke output: {out}")

        # (c) the multiscale pallas run
        run = ("run", src_las, tgt_las, "-o", d / "reg.las", "--multiscale",
               "--nn-backend", "pallas", "--max-iterations", 20,
               "--metrics", d / "m.jsonl", "--history", d / "h.jsonl",
               "--checkpoint", d / "c.json", "--html", d / "v.html")
        sk.reset_launches()
        torch.cuda.synchronize()
        with collect(sync=False) as col:
            t0 = time.perf_counter()
            _, out = _cli(*run)
            wall = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
        by_shape = dict(sk.LAUNCH_SHAPES)
        duration = json.loads(
            (d / "h.jsonl").read_text().splitlines()[-1])["duration_s"]
        st = col.stages
        io_ms = {k: st[k] * 1e3 for k in ("load_source", "load_target",
                                          "write_las", "report", "html")}
        print(f"[7c run] wall {wall:.4f} s; session duration_s "
              f"{duration:.4f} s; host I/O ms: "
              + ", ".join(f"{k} {v:.1f}" for k, v in io_ms.items())
              + f"; launches {launches}", flush=True)
        for line in col.lines():
            print(f"[7c run] stage (unsynced): {line}")
        for line in out.splitlines()[-3:]:
            print(f"[7c run] icp-torch: {line}")

        report = read_history_json(d / "reg_transform.json")
        src, _ = read_las(src_las)
        tgt, _ = read_las(tgt_las)
        cfg = ICPConfig(max_iterations=20, nn_backend="pallas")
        lib_kw = dict(max_iterations=cfg.max_iterations,
                      tolerance=cfg.tolerance,
                      sigma_multiplier=cfg.sigma_multiplier, mode=cfg.mode,
                      nn_backend=cfg.nn_backend, estimator=cfg.estimator,
                      robust=cfg.robust,
                      grid_resolution=cfg.grid_resolution or None,
                      cell_capacity=cfg.cell_capacity, device=DEVICE)
        lib = icp_register_multiscale(src, tgt, **lib_kw).final
        T_cli = np.asarray(report["transform"])
        same = np.array_equal(lib.transform, T_cli)
        pts = torch.as_tensor(src, dtype=torch.float64)
        gap = float(registration_error(torch.as_tensor(lib.transform),
                                       torch.as_tensor(T_cli), pts))
        truth = np.asarray(json.loads((d / "truth.json").read_text()))
        err = float(registration_error(torch.as_tensor(T_cli),
                                       torch.as_tensor(truth), pts))
        print(f"[7c run] library call on the decoded clouds: "
              f"{lib.iterations} iterations, {lib.message!r} (icp-torch: "
              f"{report['iterations']}, {report['message']!r}); transform "
              f"bit-equal {same}, registration error between them "
              f"{gap:.3e} m; against truth.json {err:.6f} m (not gated)",
              flush=True)
        check((lib.iterations, lib.stop_reason) == (
            report["iterations"], report["stop_reason"]),
            "icp-torch and the library call differ in iterations or stop")
        check(same and gap <= 1e-6, "icp-torch's transform is not the "
              f"library call's: {gap} m")
        rows = _iteration_rows(d / "m.jsonl")
        check([r["rmse"] for r in rows] == [float(x) for x in
                                            lib.history_rmse],
              "the metrics log's records differ from history_rmse")
        offset = center_offset(tgt)
        pdata = dict(src=src, tgt=tgt, offset=offset,
                     src_local=(src - offset).astype(np.float32),
                     tgt_local=(tgt - offset).astype(np.float32))
        _, prepared, _, _ = prepare_level(src, tgt, dev, nn_backend="pallas")
        _final_pose("7c run", pdata, T_cli, prepared)
        # The 1M pair is synthesized at the CLI's extent, not the
        # headline's: where run (c) launched a shape phase 3 did not hold,
        # hold this pair's grids and coarse shape against plain.
        unheld = sorted((nm, sh) for nm, sh in by_shape
                        if _shape_key(nm, sh) not in measured[nm])
        print(f"[7c run] launched shapes phase 3 did not hold: {unheld}",
              flush=True)
        if unheld:
            tgt_dev = torch.as_tensor(pdata["tgt_local"], device=dev)
            _hold_slab_grids(measured, "7 product 1M", prepared,
                             pdata["tgt_local"], tgt_dev,
                             np.random.default_rng(7), spec,
                             full=False)
            stride = -(-len(src) // 30_000)
            _hold_k3(measured, torch.as_tensor(np.ascontiguousarray(
                         pdata["src_local"][::stride]), device=dev),
                     torch.as_tensor(np.ascontiguousarray(
                         pdata["tgt_local"][::stride]), device=dev),
                     spec, "iterativeclosestpoint_tpu/ops/pallas_nn.py:"
                     "1103", full=False)
            del tgt_dev
        del prepared
        _launch_checks("7c run", by_shape, measured, launches)
        check(launches["colsweep"] > 0, "K2 never launched in run (c)")

        # (d) resume and live segments on a 250k pair, no multiscale
        rs, rt = d / "rs.las", d / "rt.las"
        _cli("synth", rs, rt, "--n", RESUME_N, "--seed", 11, "--noise",
             0.02)
        base = ("run", rs, rt, "--nn-backend", "pallas")
        t0 = time.perf_counter()
        _cli(*base, "--max-iterations", 10, "--checkpoint", d / "a.json",
             "--metrics", d / "a.jsonl")
        _cli(*base, "--max-iterations", 5, "--checkpoint", d / "b.json")
        _cli(*base, "--resume", d / "b.json", "--max-iterations", 10,
             "--checkpoint", d / "c2.json")
        _cli(*base, "--live-every", 5, "--max-iterations", 10,
             "--metrics", d / "l.jsonl")
        a, b, c = (load_checkpoint(d / f) for f in
                   ("a.json", "b.json", "c2.json"))
        same_resume = (np.array_equal(a["transform"], c["transform"])
                       and b["rmse_history"] + c["rmse_history"]
                       == a["rmse_history"])
        live, once = _iteration_rows(d / "l.jsonl"), _iteration_rows(
            d / "a.jsonl")
        print(f"[7d resume] {RESUME_N} points: iterations a {a['iteration']}"
              f", b {b['iteration']}, c {c['iteration']}; 5 + 5 resumed == "
              f"10 in one run (transform, rmse trail): {same_resume}; live "
              f"segments of 5: {len(live)} streamed records == the one-shot "
              f"history: {live == once}; {time.perf_counter() - t0:.3f} s "
              "for the four runs", flush=True)
        check(same_resume, "the resumed CLI run differs from one run")
        check(len(live) == a["iteration"] and live == once,
              "the streamed records differ from the one-shot history")

        # (e) replay, status, view
        _cli("replay", src_las, d / "reg_transform.json", "-k", 3, "-o",
             d / "r3.las")
        T3 = report["history"][2]["transform"]
        r3, _ = read_las(d / "r3.las")
        rgap = float(np.abs(r3 - (src @ T3[:3, :3].T + T3[:3, 3])).max())
        _, status = _cli("status", "--history", d / "h.jsonl")
        t0 = time.perf_counter()
        _cli("view", src_las, tgt_las, "-o", d / "v2.html", "--history",
             d / "reg_transform.json")
        print(f"[7e replay] iteration 3 against the source under "
              f"history_transform[2]: max |diff| {rgap:.3e} m (LAS "
              f"quantum 1e-3 m); status: {status.splitlines()[0]}; view "
              f"HTML {(d / 'v2.html').stat().st_size} bytes in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        check(rgap <= 0.0005 + 1e-6, f"replay differs: {rgap}")
        check("runs: 1" in status, status)
    return by_shape


def strip_scans(n, seed, extent, k=4):
    """``tools/exp_ms3.py``'s scans: ``k`` x-windows of 0.4 of one world
    cloud's x extent at a step of 0.2, each with N(0, 0.01) noise from
    ``default_rng(0)``."""
    from iterativeclosestpoint_tpu_torch.utils.synth import make_cloud

    world = make_cloud(n, seed=seed, extent=extent)
    x = world[:, 0]
    lo, hi = float(x.min()), float(x.max())
    ext = hi - lo
    rng = np.random.default_rng(0)
    scans = []
    for s in range(k):
        w_lo = lo + s * 0.2 * ext
        sel = world[(x >= w_lo) & (x <= w_lo + 0.4 * ext)]
        scans.append(sel + rng.normal(0, 0.01, sel.shape))
    return scans


def _pose_gap(Ta, Tb, pts):
    """Max displacement (m) between two poses over ``pts``."""
    Ta, Tb = np.asarray(Ta), np.asarray(Tb)
    return float(np.linalg.norm((pts @ Ta[:3, :3].T + Ta[:3, 3])
                                - (pts @ Tb[:3, :3].T + Tb[:3, 3]),
                                axis=1).max())


def _unheld(by_shape, measured):
    return sorted((nm, sh) for nm, sh in by_shape
                  if _shape_key(nm, sh) not in measured[nm])


def phase_graph(measured, spec):
    """Phase 8, the multi-scan pose graph and the test and reference
    backends; see the module docstring. Returns the launches by shape of
    run (a) and of the backends' runs (e)."""
    import tempfile
    from pathlib import Path

    from iterativeclosestpoint_tpu_torch import icp_register
    from iterativeclosestpoint_tpu_torch.io.las import read_las, write_las
    from iterativeclosestpoint_tpu_torch.models.icp import _rebase_transform
    from iterativeclosestpoint_tpu_torch.models.posegraph import (
        _overlap_crop,
        detect_overlap_edges,
        optimize_pose_graph,
        register_scans,
    )
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops.cellblock import (
        make_cellblock_nn,
    )
    from iterativeclosestpoint_tpu_torch.ops.hashgrid import make_hashgrid_nn
    from iterativeclosestpoint_tpu_torch.ops.se3 import apply_transform
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
    )
    from iterativeclosestpoint_tpu_torch.runtime.timing import collect
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        random_rigid_transform,
    )
    from scipy.spatial import cKDTree

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    tpu = "iterativeclosestpoint_tpu/ops/pallas_nn.py"

    # (a) the full-width job
    scans = strip_scans(**GRAPH_WORLD)
    edges = detect_overlap_edges(scans)
    kw = dict(GRAPH_KW, device=DEVICE)
    t0 = time.perf_counter()
    register_scans(scans, **kw)  # warm-up
    warm = time.perf_counter() - t0
    stats = {}
    sk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = register_scans(scans, stats=stats, **kw)
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    by_shape = dict(sk.LAUNCH_SHAPES)
    n_src = [len(_overlap_crop(scans[j], scans[i].min(axis=0),
                               scans[i].max(axis=0), 0.05))
             for i, j in edges]
    print(f"[8a graph] scans {[len(s) for s in scans]}, edges {edges}, "
          f"cropped sources {n_src}: warm-up {warm:.4f} s, timed run "
          f"{wall:.4f} s -> {sum(n_src) * GRAPH_KW['max_iterations'] / wall:.1f}"
          f" edge-source points x iterations/s; stats {stats}; launches "
          f"{launches}; GN {res.iterations} iterations, residual "
          f"{res.residual_rmse:.3e}, converged {res.converged}",
          flush=True)
    for (i, j), er in zip(edges, res.edge_results):
        print(f"[8a graph] edge {i}<-{j}: {er.iterations} iterations, "
              f"{er.message!r}, rmse {er.rmse:.6f}, nn_resolution "
              f"{er.nn_resolution}, pose vs identity (the truth) "
              f"{_pose_gap(er.transform, np.eye(4), scans[j]):.4f} m (not "
              "gated)", flush=True)
    check(len(edges) == 3 and len(res.edge_results) == 3,
          f"graph edges {edges}")
    check(stats == {"scan_uploads": 3, "grids_built": 3,
                    "cropped_source_uploads": 3}, f"graph stats {stats}")
    check(not res.disconnected, f"disconnected scans {res.disconnected}")
    check(np.isfinite(res.residual_rmse), "non-finite graph residual")
    check(all(er.success and er.iterations == GRAPH_KW["max_iterations"]
              for er in res.edge_results), "an edge stopped early")
    with collect(sync=True) as col:
        register_scans(scans, **kw)
    st = col.stages
    print(f"[8a graph] synced run: edge_stage {st['edge_stage'] * 1e3:.3f} "
          f"ms (3 uploads), grid_build {st['grid_build'] * 1e3:.3f} ms (3 "
          f"grids), pose_graph {st['pose_graph'] * 1e3:.3f} ms "
          f"({res.iterations} GN iterations); fine loop ms/iteration per "
          "edge " + ", ".join(
              f"{st[f'edge{e}/loop'] * 1e3 / GRAPH_KW['max_iterations']:.4f}"
              for e in range(len(edges))), flush=True)
    for line in col.lines():
        print(f"[8a graph] breakdown: {line}")

    # Exactness at each edge's final pose, on the shared centering frame.
    lo = np.min([s.min(axis=0) for s in scans], axis=0)
    hi = np.max([s.max(axis=0) for s in scans], axis=0)
    offset = (lo + hi) / 2.0
    prepared = {}
    for e, ((i, j), er) in enumerate(zip(edges, res.edge_results)):
        tgt_local = (scans[i] - offset).astype(np.float32)
        tgt_dev = torch.as_tensor(tgt_local, device=dev)
        prepared[i] = (make_pallas_nn_device(tgt_local, target_dev=tgt_dev),
                       tgt_local, tgt_dev)
        src = _overlap_crop(scans[j], scans[i].min(axis=0),
                            scans[i].max(axis=0), 0.05)
        pdata = dict(offset=offset, tgt_local=tgt_local,
                     src_local=(src - offset).astype(np.float32))
        _final_pose(f"8a graph edge {i}<-{j}", pdata, er.transform,
                    prepared[i][0], sample=GRAPH_SAMPLE, by_winner=True)
    unheld = _unheld(by_shape, measured)
    print(f"[8a graph] launched shapes phase 3 did not hold: {unheld}",
          flush=True)
    for i, (prep, tgt_local, tgt_dev) in prepared.items():
        if not _unheld(by_shape, measured):
            break
        _hold_slab_grids(measured, f"8a graph target {i}", prep, tgt_local,
                         tgt_dev, np.random.default_rng(8), spec,
                         full=False)
    del prepared
    _launch_checks("8a graph", by_shape, measured, launches)
    check(launches["colsweep"] > 0, "K2 never launched on the graph path")

    # (b) card against CPU on a small graph of the same density
    small = strip_scans(**GRAPH_SMALL)
    skw = dict(GRAPH_KW, crop_margin=0.0)
    t0 = time.perf_counter()
    card = register_scans(small, device=DEVICE, **skw)
    t1 = time.perf_counter()
    cpu = register_scans(small, device="cpu", **skw)
    t2 = time.perf_counter()
    per_edge = [[(er.iterations, er.stop_reason) for er in r.edge_results]
                for r in (card, cpu)]
    gap = max(_pose_gap(a, b, s) for a, b, s in zip(card.poses, cpu.poses,
                                                   small))
    print(f"[8b graph card vs cpu] scans {[len(s) for s in small]}, edges "
          f"{detect_overlap_edges(small)}: card {per_edge[0]} in "
          f"{t1 - t0:.3f} s, cpu {per_edge[1]} in {t2 - t1:.3f} s; edge "
          f"rmse {[round(er.rmse, 6) for er in card.edge_results]}; GN "
          f"{card.iterations} / {cpu.iterations} iterations; max pose "
          f"registration error {gap:.3e} m", flush=True)
    check(per_edge[0] == per_edge[1] and card.iterations == cpu.iterations,
          "graph: card and cpu differ in edges, iterations or stop codes")
    check(gap <= 1e-4, f"graph: card and cpu poses differ by {gap} m")

    # (c) the pose-graph solve on the card: 5 poses, 6 edges, one corrupted
    poses = [np.eye(4)] + [random_rigid_transform(seed=11 + s)
                           for s in range(1, 5)]
    g_edges = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1])
               for i in range(4)]
    g_edges.append((0, 4, np.linalg.inv(poses[0]) @ poses[4]))
    bad = np.linalg.inv(poses[1]) @ poses[3]
    bad[:3, 3] += np.array([2.0, -1.5, 1.0])
    g_edges.append((1, 3, bad))
    gkw = dict(n_poses=5, robust="tukey", max_iterations=40)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_card = optimize_pose_graph(g_edges, device=DEVICE, **gkw)
    gn_ms = (time.perf_counter() - t0) * 1e3
    g_cpu = optimize_pose_graph(g_edges, device="cpu", **gkw)
    truth_err = max(float(np.abs(g_card.poses[s] - poses[s]).max())
                    for s in range(5))
    dev_gap = float(np.abs(g_card.poses - g_cpu.poses).max())
    print(f"[8c gn] tukey on the card: {g_card.iterations} iterations in "
          f"{gn_ms:.3f} ms, converged {g_card.converged}; max |pose - "
          f"truth| {truth_err:.3e}; max |card - cpu| {dev_gap:.3e} (f64)",
          flush=True)
    check(truth_err < 1e-6, f"tukey GN on the card: {truth_err}")
    check(dev_gap <= 1e-9 and g_card.iterations == g_cpu.iterations,
          f"GN card vs cpu: {dev_gap}")

    # (d) icp-torch graph on the full-width strips as LAS
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = [d / f"strip{s}.las" for s in range(len(scans))]
        t0 = time.perf_counter()
        for p, s in zip(paths, scans):
            write_las(p, s)
        t1 = time.perf_counter()
        argv = ("graph", *paths, "--edges", "auto", "--max-iterations",
                GRAPH_KW["max_iterations"], "--tolerance", 0.0,
                "--poses", d / "poses.json", "--html", d / "scene.html",
                "-o", d / "merged.las")
        _, out = _cli(*argv)
        t2 = time.perf_counter()
        doc = json.loads((d / "poses.json").read_text())
        decoded = [read_las(p)[0] for p in paths]
        lib = register_scans(decoded, edges=detect_overlap_edges(decoded),
                             max_iterations=GRAPH_KW["max_iterations"],
                             tolerance=0.0, device=DEVICE)
        same = np.array_equal(np.asarray(doc["poses"]), lib.poses)
        merged = read_las(d / "merged.las")[0]
        print(f"[8d icp-torch graph] LAS written in {t1 - t0:.3f} s; "
              f"graph call {t2 - t1:.3f} s; poses bit-equal to "
              f"register_scans on the decoded clouds: {same}; merged LAS "
              f"{len(merged)} points, scene HTML "
              f"{(d / 'scene.html').stat().st_size} bytes", flush=True)
        for line in out.splitlines():
            print(f"[8d icp-torch graph] {line}")
        check(same, "icp-torch graph's poses are not the library call's")
        check(len(merged) == sum(len(x) for x in decoded),
              "the merged LAS lost points")

    # (e) the test and reference backends on phase 6's 60k terrain
    bdata = make_data(dict(n=CARD_CPU_N, seed=95, noise_sigma=0.01))
    src, tgt = bdata["src"], bdata["tgt"]
    bkw = dict(max_iterations=40, tolerance=0.0, return_registered=False,
               device=DEVICE)
    ref = icp_register(src, tgt, nn_backend="pallas", **bkw)
    tgt_dev = torch.as_tensor(bdata["tgt_local"], device=dev)
    tree = cKDTree(bdata["tgt_local"].astype(np.float64))
    sk.reset_launches()
    backends = {}
    for be, extra in (("cellblock", {}), ("hashgrid",
                                          {"cell_capacity": 10})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backends[be] = r = icp_register(src, tgt, nn_backend=be, **bkw,
                                        **extra)
        ms = (time.perf_counter() - t0) * 1e3
        gapb = _pose_gap(r.transform, ref.transform, src)
        print(f"[8e backends] {be}{extra or ''}: {r.iterations} iterations, "
              f"{r.message!r} in {ms:.1f} ms, nn_resolution "
              f"{r.nn_resolution}; pallas {ref.iterations}, "
              f"{ref.message!r}; registration error against pallas "
              f"{gapb:.3e} m", flush=True)
        check((r.iterations, r.stop_reason) == (ref.iterations,
                                                ref.stop_reason),
              f"{be}: iterations or stop code differ from pallas")
        check(gapb <= 1e-4, f"{be}: {gapb} m from pallas")
    b_shape = dict(sk.LAUNCH_SHAPES)
    b_launch = dict(sk.LAUNCHES)
    for be, r in backends.items():
        T_loc = torch.as_tensor(
            _rebase_transform(r.transform, -bdata["offset"]),
            dtype=torch.float32, device=dev)
        q = apply_transform(T_loc, torch.as_tensor(bdata["src_local"],
                                                   device=dev))
        tgt_np = tgt - bdata["offset"]  # the f64 frame icp_register builds in
        if be == "cellblock":
            fn, state, _ = make_cellblock_nn(tgt_np, device=dev)
        else:
            fn, state = make_hashgrid_nn(tgt_np, capacity=10, device=dev)
        _, dist = fn(q, tgt_dev, state)
        d_ref, _ = tree.query(q.cpu().numpy().astype(np.float64),
                              workers=-1)
        gapd = float(np.abs(dist.cpu().numpy() - d_ref).max())
        print(f"[8e backends] {be} at its final pose: max |dist - "
              f"cKDTree| {gapd:.3e} m over {len(d_ref)} rows", flush=True)
        check(gapd <= 1e-6, f"{be}: NN not exact at the final pose: {gapd}")
    unheld = _unheld(b_shape, measured)
    print(f"[8e backends] launches {b_launch}; launched shapes phase 3 did "
          f"not hold: {unheld}", flush=True)
    src_dev = torch.as_tensor(bdata["src_local"], device=dev)
    for nm, (n_q, n_t) in unheld:
        _hold_k3(measured, src_dev[:n_q].contiguous(),
                 tgt_dev[:n_t].contiguous(), spec, f"{tpu}:1103",
                 full=False)
    check(not _unheld(b_shape, measured), "a backend shape is unheld")
    check(b_launch["brute_nn"] > 0, "K3 never launched by the backends")
    print(f"[8] phase 8 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_shape, b_shape, cpu


def _spy_repair():
    """Wrap the partitioned target's collective repair so that each
    rank's last NN output is kept: (query, matched, dist, normal, rows
    sent to the repair) after the repair, the result the loop used; and
    each rank's most rows sent to the repair in one call, under
    ``("most", rank)``. Returns (store, restore)."""
    from iterativeclosestpoint_tpu_torch.parallel import partition as tpart

    orig = tpart.collective_repair
    store = {}

    def spy(comm, query, m6, dist, certified, *a, **k):
        bad = ~certified
        most = ("most", comm.rank)
        store[most] = max(store.get(most, 0), int(bad.sum()))
        m6, dist = orig(comm, query, m6, dist, certified, *a, **k)
        store[comm.rank] = (query, m6[:, 0:3], dist, m6[:, 3:6], bad)
        return m6, dist

    tpart.collective_repair = spy

    def restore():
        tpart.collective_repair = orig

    return store, restore


def _mesh_line(tag, mesh, iters, wall, launches, extra=""):
    """Per-rank collective bytes per iteration and the launches."""
    per_rank = [st["bytes_sent"] / max(iters, 1) for st in mesh.stats]
    print(f"[{tag}] {mesh.size} rank(s) on {mesh.devices[0]}: wall "
          f"{wall:.4f} s; collective bytes per iteration per rank "
          f"{per_rank}; launches {launches}{extra}", flush=True)
    return per_rank


def _hold_unheld(tag, by_shape, measured, spec, slabs, queries,
                 pool):
    """Hold every shape ``by_shape`` launched that no phase held yet:
    sweeps on a rank's slab grids (``slabs``: rank → (prepared, slab f32
    array, slab tensor)), K3 at each (queries, rows) on the rank's slab
    of that many rows, else on the first rows of ``pool`` (the run's
    target), with the first rows of ``queries`` as queries; K3 with the
    library yardstick up to ``LIBRARY_PAIRS_MAX`` pairs."""
    tpu = "iterativeclosestpoint_tpu/ops/pallas_nn.py"
    unheld = _unheld(by_shape, measured)
    print(f"[{tag}] launched shapes no phase held yet: {unheld}", flush=True)
    for r, (prep, slab_np, slab_dev) in slabs.items():
        left = _unheld(by_shape, measured)
        if any(nm != "brute_nn" for nm, _ in left):
            _hold_slab_grids(measured, f"{tag} {r} slab", prep, slab_np,
                             slab_dev, np.random.default_rng(9), spec,
                             full=False, library=False, fine_tiles=[
                                 sh for nm, sh in left if nm == "colsweep"])
    for n_q, n_t in [sh for nm, sh in _unheld(by_shape, measured)
                     if nm == "brute_nn"]:
        tt = next((sd for _, _, sd in slabs.values() if sd.shape[0] == n_t),
                  None)
        if tt is None:
            check(pool.shape[0] >= n_t, f"{tag}: no target of {n_t} rows")
            tt = pool[:n_t].contiguous()
        _hold_k3(measured, queries[:n_q].contiguous(), tt, spec,
                 f"{tpu}:1103", full=False,
                 library=n_q * n_t <= LIBRARY_PAIRS_MAX)
    check(not _unheld(by_shape, measured), f"{tag}: a shape is unheld")


def phase_mesh(data, data10, measured, spec, small_cpu):
    """Phase 9, the single-host multi-device paths on one card: a mesh of
    one rank and one of four ranks on ``cuda:0``; see the module
    docstring. Returns {path: launches by shape}."""
    import tempfile
    from pathlib import Path

    from scipy.spatial import cKDTree

    from iterativeclosestpoint_tpu_torch import (
        icp_register,
        icp_register_multiscale,
    )
    from iterativeclosestpoint_tpu_torch.io.las import read_las, write_las
    from iterativeclosestpoint_tpu_torch.models.prep import prepare_level
    from iterativeclosestpoint_tpu_torch.models.posegraph import (
        detect_overlap_edges,
        optimize_pose_graph,
        register_scans,
    )
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops.bruteforce import nn_bruteforce
    from iterativeclosestpoint_tpu_torch.parallel import (
        icp_register_partitioned,
        make_mesh,
        optimize_pose_graph_sharded,
    )
    from iterativeclosestpoint_tpu_torch.parallel import partition as tpart
    from iterativeclosestpoint_tpu_torch.runtime.timing import collect
    from iterativeclosestpoint_tpu_torch.utils.config import ICPConfig
    from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        random_rigid_transform,
    )

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    card = torch.device("cuda", 0) if dev.type == "cuda" else dev
    one = make_mesh(devices=[card])
    four = make_mesh(devices=[card] * MESH_RANKS)
    paths = {}

    # (a) dp, the headline
    kw = dict(HEADLINE_KW, device=DEVICE)
    src, tgt = data["src"], data["tgt"]
    base = icp_register_multiscale(src, tgt, **kw).final
    _, prepared, _, _ = prepare_level(src, tgt, dev, nn_backend="pallas")
    by_dp = {}
    for tag, mesh in (("9a dp", one), ("9a dp", four)):
        tag = f"{tag} {mesh.size} rank{'s' if mesh.size > 1 else ''}"
        icp_register_multiscale(src, tgt, mesh=mesh, **kw)  # warm-up
        mesh.reset_stats()
        sk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp_register_multiscale(src, tgt, mesh=mesh, **kw)
        wall = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
        for k, c in sk.LAUNCH_SHAPES.items():
            by_dp[k] = by_dp.get(k, 0) + c
        fine = res.final
        _mesh_line(tag, mesh, fine.iterations, wall, launches)
        _breakdown(tag, data, dict(kw, mesh=mesh))
        gap = _pose_gap(fine.transform, base.transform, src)
        same = (np.array_equal(fine.transform, base.transform)
                and np.array_equal(fine.history_transform,
                                   base.history_transform))
        print(f"[{tag}] {fine.iterations} iterations, {fine.message!r} "
              f"(single device {base.iterations}, {base.message!r}); "
              f"transform and history bit-equal to the single-device run: "
              f"{same}; registration error between them {gap:.3e} m",
              flush=True)
        check((fine.iterations, fine.stop_reason)
              == (base.iterations, base.stop_reason),
              f"{tag}: iterations or stop code differ from one device")
        if mesh.size == 1:
            check(same, f"{tag}: not bit-equal to the single-device run")
        check(gap <= 1e-4, f"{tag}: {gap} m from the single-device run")
        check(launches["colsweep_fused"] > 0, f"{tag}: K1 never launched")
        _final_pose(tag, data, fine.transform, prepared)
    del prepared
    paths["mesh_dp"] = by_dp
    _hold_unheld("9a dp", by_dp, measured, spec, {},
                 torch.as_tensor(data["src_local"], device=dev),
                 torch.as_tensor(data["tgt_local"], device=dev))

    # (b) the partitioned target at 10M: tools/exp_partition10m.py's
    # recipe, ladder init then 20 partitioned plane iterations.
    src, tgt = data10["src"], data10["tgt"]
    t0 = time.perf_counter()
    ladder = icp_register_multiscale(src, tgt, device=DEVICE,
                                     **PART_LADDER_KW).final
    t_ladder = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = icp_register(src, tgt, initial_transform=ladder.transform,
                       nn_backend="pallas", device=DEVICE, **PART_KW)
    t_ref = time.perf_counter() - t0
    print(f"[9b partition 10M] ladder init {t_ladder:.4f} s "
          f"({ladder.iterations} iterations, rmse {ladder.rmse:.6f}); the "
          f"same 20 iterations on "
          f"one device without slabs: {t_ref:.4f} s, {ref.message!r}",
          flush=True)
    tgt_local = data10["tgt_local"]
    tree = cKDTree(tgt_local.astype(np.float64))
    # The normals the partition carries: the whole target's, estimated
    # on the card from the f64 centred cloud (``prepare_partition``).
    tgt_f64 = data10["tgt"] - data10["offset"]
    nrm_ref = tpart._target_normals(
        torch.as_tensor(tgt_f64, dtype=torch.float32, device=dev), tgt_f64)
    del tgt_f64
    results = {}
    by_part = {}
    slabs = {}
    tgt_dev = torch.as_tensor(tgt_local, device=dev)
    # The recipe on 1 and 4 ranks (halo 2% of the extent: after the ladder
    # no query needs the repair), and on 4 ranks with a 1 mm halo, where
    # the queries near each wall go through it every iteration.
    for mesh, halo in ((one, None), (four, None), (four, PART_REPAIR_HALO)):
        tag = (f"9b partition 10M {mesh.size} "
               f"rank{'s' if mesh.size > 1 else ''}"
               + (f" halo {halo:g}" if halo else ""))
        run_kw = dict(PART_KW)
        if halo:
            run_kw.update(repair_budget=PART_REPAIR_BUDGET,
                          repair_passes=PART_REPAIR_PASSES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp = tpart.prepare_partition(tgt, mesh=mesh, estimator="plane",
                                     halo=halo, n_queries_hint=len(src))
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t0
        mesh.reset_stats()
        sk.reset_launches()
        store, restore = _spy_repair()
        try:
            with collect(sync=True) as col:
                t0 = time.perf_counter()
                res = icp_register_partitioned(
                    src, tgt, mesh=mesh, prepared_partition=pp,
                    initial_transform=ladder.transform, **run_kw)
                wall = time.perf_counter() - t0
        finally:
            restore()
        launches = dict(sk.LAUNCHES)
        for k, c in sk.LAUNCH_SHAPES.items():
            by_part[k] = by_part.get(k, 0) + c
        if not halo:
            results[mesh.size] = res
        it = res.iterations
        st = mesh.stats
        per_rank = _mesh_line(
            tag, mesh, it, wall, launches,
            f"; prep {t_prep:.4f} s (local search {pp['local_search']}, R="
            f"{pp['resolution']}, trange {pp['trange']}, coarse trange "
            f"{pp['coarse_trange']}, slabs "
            f"{[int(p.shape[0]) for p in pp['part'].halo_pts]} rows)")
        passes = sum(s["repair_passes"] for s in st) / mesh.size / it
        queries = sum(s["repair_queries"] for s in st) / it
        print(f"[{tag}] stages: " + "; ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in col.stages.items())
            + f"; fine {col.stages['loop'] * 1e3 / it:.4f} ms/iteration; "
            f"collective repair {passes:.3f} passes and {queries:.1f} "
            f"queries per iteration (all ranks; most in one call per rank "
            f"{[store.get(('most', r), 0) for r in range(mesh.size)]}); "
            f"{it} iterations, {res.message!r}", flush=True)
        # The loop's statistics stay under 1 KB an iteration; the repair
        # adds its exchanged queries and winners (halo 1 mm).
        check(halo or max(per_rank) < 1024,
              f"{tag}: {per_rank} B per iteration")
        # One slab of the whole 10M target gets the base grid's trange of
        # 1536, where the fine sweep is K2's slot-wise form (as in 4d's
        # first stage); the 4 slabs' grids take K1.
        if mesh.size == 1:
            check(launches["colsweep"] > 0, f"{tag}: K2 never launched")
        else:
            check(launches["colsweep_fused"] > 0, f"{tag}: K1 never launched")
        if halo:
            cap = run_kw["repair_budget"] * run_kw["repair_passes"]
            check(queries > 0, f"{tag}: no query went through the repair")
            check(all(store.get(("most", r), 0) <= cap
                      for r in range(mesh.size)),
                  f"{tag}: more rows sent to the repair than it covers")
        gap_ref = _pose_gap(res.transform, ref.transform, src[::10])
        print(f"[{tag}] against the same iterations on one device without "
              f"slabs: {ref.iterations}, {ref.message!r}; registration "
              f"error {gap_ref:.3e} m over every 10th point", flush=True)
        check((res.iterations, res.stop_reason)
              == (ref.iterations, ref.stop_reason),
              f"{tag}: iterations or stop code differ from one device")
        check(gap_ref <= 1e-4, f"{tag}: {gap_ref} m from one device")
        # The last iteration's NN on a seeded sample of the rows, and
        # (halo 1 mm) on every row that went through the repair.
        q = torch.cat([store[r][0] for r in range(mesh.size)])
        m = torch.cat([store[r][1] for r in range(mesh.size)])
        dd = torch.cat([store[r][2] for r in range(mesh.size)])
        nr = torch.cat([store[r][3] for r in range(mesh.size)])
        bad = torch.cat([store[r][4] for r in range(mesh.size)])
        gen = torch.Generator(device=dev).manual_seed(7)
        sample = [("sampled", torch.randperm(q.shape[0], generator=gen,
                                             device=dev)[:SAMPLE_10M])]
        if halo:
            sample.append(("repaired", torch.nonzero(bad)[:, 0]))
        for what, rows in sample:
            qh = q[rows].cpu().numpy().astype(np.float64)
            mh = m[rows].cpu().numpy().astype(np.float64)
            d_ref, _ = tree.query(qh, workers=-1)
            d0, win = tree.query(mh, workers=-1)
            wgap = float(np.abs(np.linalg.norm(mh - qh, axis=1)
                                - d_ref).max())
            same_n = torch.equal(nr[rows], nrm_ref[torch.as_tensor(
                win, device=dev)])
            print(f"[{tag}] last iteration's NN on {len(qh)} {what} rows: "
                  f"matched rows are target points: {not d0.any()}; "
                  f"winners' f64 distance - cKDTree {wgap:.3e} m; normals "
                  f"equal the target's normal at the winner: {same_n}",
                  flush=True)
            check(not d0.any(), f"{tag}: a matched point is not a target "
                  "point")
            check(wgap <= 1e-9, f"{tag}: a match is not a nearest neighbour")
            check(same_n, f"{tag}: a returned normal is not its winner's")
        if halo:
            # The plain brute force over the whole target, first minimum
            # in target order, on the first repaired rows.
            rows = sample[1][1][:PART_REPAIR_HELD]
            t0 = time.perf_counter()
            bi, bd = nn_bruteforce(q[rows], tgt_dev)
            same = (torch.equal(m[rows], tgt_dev[bi])
                    and torch.equal(dd[rows], bd))
            print(f"[{tag}] {len(rows)} repaired rows against the plain "
                  f"brute force over all {len(tgt_dev)} target rows "
                  f"({time.perf_counter() - t0:.3f} s): winners and "
                  f"distances bit for bit: {same}", flush=True)
            check(same, f"{tag}: a repaired winner differs from brute force")
        del store, q, m, dd, nr, bad
        for r in range(mesh.size):
            # Each rank's slab and its grids, for holding the shapes the
            # runs launched (K3's target rows differ per slab).
            slab = pp["part"].halo_pts[r]
            grid, cgrid, _, _ = tpart._slab_grids(
                slab, pp["part"].halo_nrm[r], resolution=pp["resolution"],
                trange=pp["trange"], coarse_trange=pp["coarse_trange"],
                fine_kernel=pp["fine_kernel"])
            slabs[f"{tag[len('9b partition 10M '):]}, rank {r}"] = (
                (None, (grid, cgrid, pp["part"].halo_nrm[r]),
                 pp["resolution"]), slab.cpu().numpy(), slab)
        del pp
    gap14 = _pose_gap(results[1].transform, results[MESH_RANKS].transform,
                      src[::10])
    print(f"[9b partition 10M] 1 rank against {MESH_RANKS} ranks: "
          f"registration error {gap14:.3e} m over every 10th point",
          flush=True)
    check(results[1].iterations == results[MESH_RANKS].iterations,
          "9b: 1 and 4 ranks differ in iterations")
    check(gap14 <= 1e-4, f"9b: 1 and 4 ranks differ by {gap14} m")
    paths["mesh_partition"] = by_part
    _hold_unheld("9b partition 10M", by_part, measured, spec, slabs,
                 torch.as_tensor(data10["src_local"][:4 * PART_REPAIR_BUDGET],
                                 device=dev), tgt_dev)
    del tree, slabs, nrm_ref, tgt_dev

    # (c) the tie combine and the collective repair on every query
    rng = np.random.default_rng(7)
    base_c = rng.uniform(-50, 50, (1000, 3))
    B = np.array([[+1.0, 0.0, 200.0]])  # original index 1000, slab 1
    A = np.array([[-1.0, 0.0, 200.0]])  # original index 1001, slab 0
    two = make_mesh(devices=[card] * 2)
    part = tpart.build_partition(np.concatenate([base_c, B, A]),
                                 two.devices, 1e-3)
    qt = torch.tensor([[0.0, 0.0, 200.0]], device=dev)

    def tie_rank(comm):
        r = comm.rank
        state = (part.halo_pts[r], part.halo_idx[r], None,
                 torch.tensor(part.x_lo[r], dtype=torch.float32, device=dev),
                 torch.tensor(part.x_hi[r], dtype=torch.float32, device=dev),
                 None, None)
        nn = tpart._partitioned_nn(comm, state, local_search="brute",
                                   with_normals=False, repair_budget=64,
                                   repair_passes=2)
        return nn(qt.clone(), None, None)

    tie = two.run(tie_rank)
    exact = all(torch.equal(mm.cpu(), torch.tensor(B, dtype=torch.float32))
                for mm, _ in tie)
    print(f"[9c tie] two ranks, B (index 1000, slab 1) and A (index 1001, "
          f"slab 0) equidistant from the query: matched "
          f"{[mm.cpu().tolist() for mm, _ in tie]}, distances "
          f"{[float(dd) for _, dd in tie]}; exactly B on both ranks: {exact}",
          flush=True)
    check(exact, "the cross-rank tie did not resolve to B")

    cdata = make_data(dict(n=REPAIR_ALL_N, seed=9, noise_sigma=0.02,
                           kind="terrain", extent=100.0))
    lift = np.eye(4)
    lift[2, 3] = REPAIR_ALL_LIFT
    four.reset_stats()
    sk.reset_launches()
    store, restore = _spy_repair()
    try:
        t0 = time.perf_counter()
        icp_register_partitioned(
            cdata["src"], cdata["tgt"], mesh=four, halo=1e-4,
            local_search="brute", initial_transform=lift, max_iterations=1,
            repair_budget=2048, repair_passes=4, return_registered=False)
        wall = time.perf_counter() - t0
    finally:
        restore()
    by_rep = dict(sk.LAUNCH_SHAPES)
    queries = sum(s["repair_queries"] for s in four.stats)
    tgt_dev = torch.as_tensor(cdata["tgt_local"], device=dev)
    same = True
    for r in range(MESH_RANKS):
        q, mm, dd, _, _ = store[r]
        bi, bd = nn_bruteforce(q, tgt_dev)
        same &= torch.equal(mm, tgt_dev[bi]) and torch.equal(dd, bd)
    print(f"[9c repair] {REPAIR_ALL_N} queries lifted {REPAIR_ALL_LIFT} m "
          f"above the target, halo 1e-4, {MESH_RANKS} ranks, brute local "
          f"search: {queries} queries repaired collectively in {wall:.4f} s "
          f"({four.stats[0]['repair_passes']} passes); every winner and "
          f"distance the plain brute force's over the whole target (first "
          f"minimum in target order), bit for bit: {same}; launches "
          f"{dict(sk.LAUNCHES)}", flush=True)
    check(queries == REPAIR_ALL_N, f"9c: {queries} queries repaired")
    check(same, "9c: a collective repair winner differs from brute force")
    paths["mesh_repair"] = by_rep
    _hold_unheld("9c repair", by_rep, measured, spec, {},
                 torch.as_tensor(cdata["src_local"], device=dev), tgt_dev)
    del store

    # (d) the pose graph over the mesh
    small = strip_scans(**GRAPH_SMALL)
    skw = dict(GRAPH_KW, crop_margin=0.0, reuse_device=False)
    by_graph = {}
    for partition in (False, True):
        tag = f"9d graph {'partition' if partition else 'dp'}"
        stats = {}
        sk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = register_scans(small, mesh=four, partition=partition,
                           device=DEVICE, stats=stats, **skw)
        wall = time.perf_counter() - t0
        for k, c in sk.LAUNCH_SHAPES.items():
            by_graph[k] = by_graph.get(k, 0) + c
        per_edge = [(er.iterations, er.stop_reason) for er in g.edge_results]
        ref_edge = [(er.iterations, er.stop_reason)
                    for er in small_cpu.edge_results]
        gap = max(_pose_gap(a, b, s) for a, b, s in zip(g.poses,
                                                        small_cpu.poses,
                                                        small))
        print(f"[{tag}] {MESH_RANKS} ranks on the card, edges "
              f"{detect_overlap_edges(small)}: {per_edge} in {wall:.3f} s "
              f"(CPU, one device: {ref_edge}); GN {g.iterations} iterations "
              f"(CPU {small_cpu.iterations}); stats {stats}; max pose "
              f"registration error against the CPU {gap:.3e} m", flush=True)
        check(per_edge == ref_edge, f"{tag}: edges differ from the CPU's")
        check(gap <= 1e-4, f"{tag}: {gap} m from the CPU")
        if partition:
            check(stats.get("partitions_built") == 3, f"{tag}: {stats}")
    paths["mesh_graph"] = by_graph
    pool = torch.as_tensor(np.concatenate(small).astype(np.float32),
                           device=dev)
    _hold_unheld("9d graph", by_graph, measured, spec, {}, pool, pool)

    poses = [np.eye(4)] + [random_rigid_transform(seed=11 + s)
                           for s in range(1, 5)]
    g_edges = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1])
               for i in range(4)]
    g_edges.append((0, 4, np.linalg.inv(poses[0]) @ poses[4]))
    bad = np.linalg.inv(poses[1]) @ poses[3]
    bad[:3, 3] += np.array([2.0, -1.5, 1.0])
    g_edges.append((1, 3, bad))
    gkw = dict(n_poses=5, robust="tukey", max_iterations=40)
    g1 = optimize_pose_graph(g_edges, device=DEVICE, **gkw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g4 = optimize_pose_graph_sharded(g_edges, mesh=four, **gkw)
    gn_ms = (time.perf_counter() - t0) * 1e3
    gap = float(np.abs(g4.poses - g1.poses).max())
    print(f"[9d gn] tukey, edges split over {MESH_RANKS} ranks: "
          f"{g4.iterations} iterations in {gn_ms:.3f} ms (one device "
          f"{g1.iterations}); max |sharded - one device| {gap:.3e} (f64)",
          flush=True)
    check(gap <= 1e-9 and g4.iterations == g1.iterations,
          f"sharded GN against one device: {gap}")

    # (e) the product surface: --parallel on the card's one-rank mesh
    by_prod = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        src_las, tgt_las = d / "src.las", d / "tgt.las"
        _cli("synth", src_las, tgt_las, "--n", PRODUCT_N, "--seed", 7,
             "--noise", 0.02)
        src, _ = read_las(src_las)
        tgt, _ = read_las(tgt_las)
        cfg = ICPConfig(max_iterations=20, nn_backend="pallas")
        lib_kw = dict(max_iterations=cfg.max_iterations,
                      tolerance=cfg.tolerance,
                      sigma_multiplier=cfg.sigma_multiplier, mode=cfg.mode,
                      nn_backend=cfg.nn_backend, estimator=cfg.estimator,
                      robust=cfg.robust,
                      grid_resolution=cfg.grid_resolution or None,
                      cell_capacity=cfg.cell_capacity, device=DEVICE)
        for mode in ("dp", "partition"):
            sk.reset_launches()
            t0 = time.perf_counter()
            _, out = _cli("run", src_las, tgt_las, "-o", d / "reg.las",
                          "--multiscale", "--nn-backend", "pallas",
                          "--max-iterations", 20, "--parallel", mode)
            wall = time.perf_counter() - t0
            for k, c in sk.LAUNCH_SHAPES.items():
                by_prod[k] = by_prod.get(k, 0) + c
            T_cli = np.asarray(json.loads(
                (d / "reg_transform.json").read_text())["transform"])
            lib = icp_register_multiscale(
                src, tgt, mesh=make_mesh(device=DEVICE),
                fine_path="partitioned" if mode == "partition" else "auto",
                **lib_kw).final
            same = np.array_equal(lib.transform, T_cli)
            print(f"[9e icp-torch run --parallel {mode}] {wall:.4f} s; "
                  f"{[ln for ln in out.splitlines() if 'mesh' in ln]}; "
                  f"library call {lib.iterations} iterations, "
                  f"{lib.message!r}; transform bit-equal: {same}", flush=True)
            check(same, f"run --parallel {mode}: not the library call's")
        paths_l = [d / f"strip{s}.las" for s in range(len(small))]
        for p, sc in zip(paths_l, small):
            write_las(p, sc)
        sk.reset_launches()
        _, out = _cli("graph", *paths_l, "--edges", "auto",
                      "--max-iterations", 20, "--tolerance", 0.0,
                      "--parallel", "dp", "--poses", d / "poses.json")
        for k, c in sk.LAUNCH_SHAPES.items():
            by_prod[k] = by_prod.get(k, 0) + c
        got = np.asarray(json.loads((d / "poses.json").read_text())["poses"])
        decoded = [read_las(p)[0] for p in paths_l]
        lib = register_scans(decoded, edges=detect_overlap_edges(decoded),
                             max_iterations=20, tolerance=0.0,
                             device=DEVICE, mesh=make_mesh(device=DEVICE))
        same = np.array_equal(got, lib.poses)
        print(f"[9e icp-torch graph --parallel dp] poses bit-equal to "
              f"register_scans(mesh=make_mesh()) on the decoded clouds: "
              f"{same}", flush=True)
        check(same, "graph --parallel dp: not the library call's poses")
    paths["mesh_product"] = by_prod
    slabs = {}
    if any(nm != "brute_nn" for nm, _ in _unheld(by_prod, measured)):
        pp = tpart.prepare_partition(tgt, mesh=make_mesh(device=DEVICE),
                                     n_queries_hint=len(src))
        slab = pp["part"].halo_pts[0]
        grid, cgrid, _, _ = tpart._slab_grids(
            slab, None, resolution=pp["resolution"], trange=pp["trange"],
            coarse_trange=pp["coarse_trange"], fine_kernel=pp["fine_kernel"])
        slabs["rank 0"] = ((None, (grid, cgrid, None), pp["resolution"]),
                    slab.cpu().numpy(), slab)
    pool = torch.as_tensor(tgt - center_offset(tgt), dtype=torch.float32,
                           device=dev)
    _hold_unheld("9e product", by_prod, measured, spec, slabs,
                 torch.as_tensor(src - center_offset(tgt), dtype=torch.float32,
                                 device=dev), pool)
    print(f"[9] phase 9 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def phase_across_cards(data, data10):
    """``--across-cards``: phase 9a and 9b's runs on ``make_mesh()``, one
    rank per visible card, and on one process per card over NCCL, against
    one device and a 1-rank mesh; see the module docstring."""
    import tempfile

    from iterativeclosestpoint_tpu_torch import (
        icp_register,
        icp_register_multiscale,
    )
    from iterativeclosestpoint_tpu_torch.parallel import (
        icp_register_partitioned,
        icp_register_sharded,
        make_mesh,
        prepare_partition,
    )
    from iterativeclosestpoint_tpu_torch.runtime.timing import collect

    cards = make_mesh()
    check(cards.size > 1, f"--across-cards needs several cards: {cards}")
    one = make_mesh(devices=["cuda:0"])

    def synced():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    kw = dict(HEADLINE_KW, device=DEVICE)
    src, tgt = data["src"], data["tgt"]
    base = None
    for label, mesh in (("one device", None), ("1 rank", one),
                        (f"{cards.size} cards", cards)):
        tag = f"cards 9a dp, {label}"
        mkw = dict(kw, mesh=mesh) if mesh is not None else kw
        icp_register_multiscale(src, tgt, **mkw)  # warm-up
        walls = []
        for _ in range(3):
            synced()
            t0 = time.perf_counter()
            res = icp_register_multiscale(src, tgt, **mkw).final
            walls.append(time.perf_counter() - t0)
        if base is None:
            base = res
        gap = _pose_gap(res.transform, base.transform, src)
        print(f"[{tag}] wall best {min(walls):.4f} s of "
              f"{[round(w, 4) for w in walls]}; {res.iterations} iterations, "
              f"{res.message!r}; registration error against one device "
              f"{gap:.3e} m", flush=True)
        _breakdown(tag, data, mkw)
        check((res.iterations, res.stop_reason)
              == (base.iterations, base.stop_reason) and gap <= 1e-4,
              f"{tag}: differs from one device")
    # A mesh over several processes runs the fine level on the host path
    # (the coarse pose applied to the source in f64 on the host): its
    # references are that path's, on one device and on the thread mesh.
    T_coarse = icp_register_multiscale(src, tgt, **kw).levels[-2][1].transform
    fine_kw = {k: v for k, v in HEADLINE_KW.items()
               if k not in ("coarse_max_points", "coarse_iterations")}
    host1 = icp_register(src, tgt, initial_transform=T_coarse, device=DEVICE,
                         **fine_kw)
    host_cards = icp_register_sharded(src, tgt, mesh=cards,
                                      initial_transform=T_coarse, **fine_kw)
    tmp = tempfile.TemporaryDirectory()
    n = cards.size
    try:
        tag = f"cards 9a dp, {n} processes (NCCL)"
        _, _, got = _reap("cards-dp", _spawn("cards-dp", n, tmp.name),
                          CARDS_TIMEOUT_S)
        g = got[0]
        T_g = _unhexed(g["transform"]).reshape(4, 4)
        gap = _pose_gap(T_g, host1.transform, src)
        same = all(_same_bits(x, _result_json(host_cards)) for x in got)
        print(f"[{tag}] wall best {min(g['walls']):.4f} s of "
              f"{[round(w, 4) for w in g['walls']]} (process 0; the others "
              f"{[round(min(x['walls']), 4) for x in got[1:]]}); fine "
              f"{g['fine_ms']:.4f} ms/iteration (synced run); "
              f"{g['iterations']} iterations, {g['message']!r}; every "
              f"process bit-equal to the thread mesh on the host path: "
              f"{same}; registration error against one device on the host "
              f"path {gap:.3e} m ({host1.iterations} iterations, "
              f"{host1.message!r}), against one device's multiscale run "
              f"{_pose_gap(T_g, base.transform, src):.3e} m", flush=True)
        check(all(_unhexed(x["coarse"]).tolist()
                  == np.asarray(T_coarse).ravel().tolist() for x in got),
              f"{tag}: the coarse level differs from one device's")
        check(same, f"{tag}: differs from the thread mesh's bits")
        check((g["iterations"], g["stop_reason"])
              == (host1.iterations, int(host1.stop_reason)) and gap <= 1e-4,
              f"{tag}: differs from one device")
    finally:
        tmp.cleanup()

    src, tgt = data10["src"], data10["tgt"]
    ladder = icp_register_multiscale(src, tgt, device=DEVICE,
                                     **PART_LADDER_KW).final
    synced()
    t0 = time.perf_counter()
    ref = icp_register(src, tgt, initial_transform=ladder.transform,
                       nn_backend="pallas", device=DEVICE, **PART_KW)
    print(f"[cards 9b partition 10M, one device without slabs] "
          f"{time.perf_counter() - t0:.4f} s, {ref.iterations} iterations, "
          f"{ref.message!r}", flush=True)
    for label, mesh in (("1 rank", one), (f"{cards.size} cards", cards)):
        tag = f"cards 9b partition 10M, {label}"
        synced()
        t0 = time.perf_counter()
        pp = prepare_partition(tgt, mesh=mesh, estimator="plane",
                               n_queries_hint=len(src))
        synced()
        t_prep = time.perf_counter() - t0
        with collect(sync=True) as col:
            t0 = time.perf_counter()
            res = icp_register_partitioned(
                src, tgt, mesh=mesh, prepared_partition=pp,
                initial_transform=ladder.transform, **PART_KW)
            synced()
            wall = time.perf_counter() - t0
        gap = _pose_gap(res.transform, ref.transform, src[::10])
        print(f"[{tag}] prep {t_prep:.4f} s; wall {wall:.4f} s; fine "
              f"{col.stages['loop'] * 1e3 / res.iterations:.4f} "
              f"ms/iteration; {res.iterations} iterations, {res.message!r}; "
              f"registration error against one device {gap:.3e} m",
              flush=True)
        check((res.iterations, res.stop_reason)
              == (ref.iterations, ref.stop_reason) and gap <= 1e-4,
              f"{tag}: differs from one device")
        del pp
    tmp = tempfile.TemporaryDirectory()
    n = cards.size
    try:
        tag = f"cards 9b partition 10M, {n} processes (NCCL)"
        _, _, got = _reap("cards-partition",
                          _spawn("cards-partition", n, tmp.name),
                          CARDS_TIMEOUT_S)
        g = got[0]
        gap = _pose_gap(_unhexed(g["transform"]).reshape(4, 4),
                        ref.transform, src[::10])
        print(f"[{tag}] prep {g['prep']:.4f} s; wall {g['wall']:.4f} s; "
              f"fine {g['fine_ms']:.4f} ms/iteration (process 0; the others "
              f"{[round(x['fine_ms'], 4) for x in got[1:]]}); "
              f"{g['iterations']} iterations, {g['message']!r}; "
              f"registration error against one device {gap:.3e} m; every "
              f"process the same bits: "
              f"{all(_same_bits(x, g) for x in got)}", flush=True)
        check(all(_same_bits(x, g) for x in got)
              and (g["iterations"], g["stop_reason"])
              == (ref.iterations, int(ref.stop_reason)) and gap <= 1e-4,
              f"{tag}: differs from one device")
    finally:
        tmp.cleanup()


# --- phase 10: the mesh over several processes ---------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hexed(a) -> str:
    return np.ascontiguousarray(np.asarray(a), np.float64).tobytes().hex()


def _unhexed(h: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(h), np.float64)


def _shapes_out():
    """This process's launches by kernel and shape, as JSON rows."""
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk

    return [[nm, list(sh), c] for (nm, sh), c in sk.LAUNCH_SHAPES.items()]


def _shapes_in(results) -> dict:
    """The launches of several processes' ``_shapes_out`` rows, summed."""
    by = {}
    for res in results:
        for nm, sh, c in res["shapes"]:
            key = (nm, tuple(sh))
            by[key] = by.get(key, 0) + c
    return by


def _spawn(job, nproc, outdir, *extra):
    """``nproc`` copies of this script as workers of ``job`` (one process
    group, a fresh port), started together and waited for; each writes
    its output to ``outdir/<job>.<pid>.log`` and its result to
    ``<job>.<pid>.json``. Returns what ``_reap`` waits on."""
    from pathlib import Path

    port = _free_port()
    logs = [Path(outdir) / f"{job}.{pid}.log" for pid in range(nproc)]
    files = [open(p, "wb") for p in logs]
    t_start = time.time()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", job, str(pid), str(nproc),
         str(port), str(outdir), *map(str, extra)],
        stdout=f, stderr=subprocess.STDOUT) for pid, f in enumerate(files)]
    return procs, files, logs, t_start


def _reap(job, spawned, timeout, expect_ok=True):
    """Wait for ``_spawn``'s workers, killing any that outlives
    ``timeout`` seconds from the start; (return codes, outputs,
    results)."""
    import json as _json
    from pathlib import Path

    procs, files, logs, t_start = spawned
    try:
        for p in procs:
            left = max(t_start + timeout - time.time(), 1.0)
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p, f in zip(procs, files):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    rcs = [p.returncode for p in procs]
    outs = [p.read_bytes().decode(errors="replace") for p in logs]
    results = []
    for pid, log in enumerate(logs):
        path = Path(str(log)[:-4] + ".json")
        results.append(_json.loads(path.read_text()) if path.exists()
                       else None)
    if expect_ok:
        for pid, (rc, out) in enumerate(zip(rcs, outs)):
            check(rc == 0 and results[pid] is not None,
                  f"{job} worker {pid} exited {rc}:\n{out[-4000:]}")
    return rcs, outs, results


def _worker_mesh(pid, nproc, port, devices, backend=None):
    from iterativeclosestpoint_tpu_torch.parallel import init_multihost

    return init_multihost(f"127.0.0.1:{port}", nproc, pid,
                          heartbeat_timeout_seconds=MP_HEARTBEAT_S,
                          local_devices=devices, backend=backend)


def _dp_run(mesh, data, reps):
    """The headline through ``icp_register_multiscale(mesh=)``: a warm-up,
    ``reps`` timed runs (launches and collective bytes of the last) and a
    synced breakdown. Returns a JSON-able result."""
    from iterativeclosestpoint_tpu_torch import icp_register_multiscale
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.runtime.timing import collect

    dev = mesh.local_devices[0]
    kw = dict(HEADLINE_KW, device=dev, mesh=mesh)
    src, tgt = data["src"], data["tgt"]
    icp_register_multiscale(src, tgt, **kw)  # warm-up
    walls = []
    for _ in range(reps):
        mesh.reset_stats()
        sk.reset_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ms = icp_register_multiscale(src, tgt, **kw)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    shapes, launches = _shapes_out(), dict(sk.LAUNCHES)
    res = ms.final
    it = max(res.iterations, 1)
    per_rank = [mesh.stats[r]["bytes_sent"] / it for r in mesh.local_ranks]
    with collect(sync=True) as col:
        icp_register_multiscale(src, tgt, **kw)
    return dict(
        coarse=_hexed(ms.levels[-2][1].transform),
        transform=_hexed(res.transform),
        history=_hexed(res.history_transform),
        rmse=_hexed(res.history_rmse), iterations=res.iterations,
        stop_reason=int(res.stop_reason), message=res.message, walls=walls,
        fine_ms=col.stages["fine/loop"] * 1e3 / it, bytes=per_rank,
        launches=launches, shapes=shapes)


def _ingest_sequence(mesh, sp, tp, device, spy=False, **repair):
    """``icp-torch run --parallel partition --ingest --estimator plane
    --max-iterations 20 --tolerance 0``'s library sequence on ``mesh``:
    one strided sample pass per file, the walls, the sampled grid
    parameters, the coarse carry, the streamed loaders and the
    partitioned plane run (``repair``: its repair budget and passes, the
    CLI's defaults if empty). Returns (result, timings and stats, the
    state, the spy's store or None)."""
    from iterativeclosestpoint_tpu_torch.io.las import read_header
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.parallel import ingest as ting
    from iterativeclosestpoint_tpu_torch.parallel import (
        icp_register_partitioned,
    )
    from iterativeclosestpoint_tpu_torch.utils.config import ICPConfig

    cfg = ICPConfig(max_iterations=PART_KW["max_iterations"],
                    tolerance=PART_KW["tolerance"],
                    estimator=PART_KW["estimator"])
    sk.reset_launches()
    mesh.reset_stats()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    hdr_t, hdr_s = read_header(tp), read_header(sp)
    offset = ting.header_center(hdr_t)
    halo = 0.02 * float(np.max(np.asarray(hdr_t.bounds_max, np.float64)
                               - np.asarray(hdr_t.bounds_min, np.float64)))
    s_tgt, _ = ting.sample_points(tp, header=hdr_t)
    s_src, _ = ting.sample_points(sp, header=hdr_s)
    walls = np.quantile(s_tgt[:, 0], np.linspace(0, 1, mesh.size + 1))
    walls[0], walls[-1] = -np.inf, np.inf
    carry = ting.coarse_carry_from_files(
        sp, tp, mode=cfg.mode, tolerance=max(min(cfg.tolerance, 1e-5), 1e-9),
        samples=(s_src, s_tgt), device=device)
    gp = ting.estimate_partition_grid_params(
        tp, walls, halo, header=hdr_t, n_queries_hint=hdr_s.point_count,
        sample=s_tgt)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    tstats, sstats = {}, {}
    part, walls = ting.load_las_partitioned_target(
        tp, mesh, halo=halo, offset=offset, walls=walls, batch_size=MP_BATCH,
        stats=tstats)
    src_g = ting.load_las_partitioned_source(
        sp, mesh, walls=walls, offset=offset, batch_size=MP_BATCH,
        stats=sstats)
    torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    store, restore = _spy_repair() if spy else (None, lambda: None)
    try:
        res = icp_register_partitioned(
            None, None, mesh=mesh, partition_state=part, source_global=src_g,
            offset=offset, grid_params=gp, resume_carry=carry,
            max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
            sigma_multiplier=cfg.sigma_multiplier, mode=cfg.mode,
            estimator=cfg.estimator, robust=cfg.robust,
            return_registered=False, **repair)
        torch.cuda.synchronize(device)
    finally:
        restore()
    t3 = time.perf_counter()
    info = dict(prep=t1 - t0, ingest=t2 - t1, loop=t3 - t2,
                target=tstats, source=sstats, grid_params=gp,
                launches=dict(sk.LAUNCHES), shapes=_shapes_out(),
                coarse_tgt=s_tgt[::max(1, len(s_tgt) // 150_000)],
                offset=offset)
    return res, info, part, store


def _result_json(res) -> dict:
    return dict(transform=_hexed(res.transform),
                history=_hexed(res.history_transform),
                rmse=_hexed(res.history_rmse), iterations=res.iterations,
                stop_reason=int(res.stop_reason), message=res.message)


def _worker_ingest(mesh, outdir):
    """10b's worker: the ingest sequence on this process's ranks, a
    seeded sample of each rank's last matches saved for the parent's
    cKDTree check, and each sampled winner's normal (rows the repair did
    not touch) held against its rank's slab normal."""
    from pathlib import Path

    from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import nn_exact
    from iterativeclosestpoint_tpu_torch.parallel import (
        fill_partition_normals,
    )

    d = Path(outdir)
    dev = mesh.local_devices[0]
    res, info, part, store = _ingest_sequence(
        mesh, d / "src.las", d / "tgt.las", dev, spy=True, **MP_REPAIR)
    part = fill_partition_normals(
        part, resolution=info["grid_params"]["normals_resolution"])
    checked = {}
    for r in mesh.local_ranks:
        q, m, _, nrm, bad = store[r]
        gen = torch.Generator(device=dev).manual_seed(7 + r)
        rows = torch.randperm(q.shape[0], generator=gen, device=dev)[
            :SAMPLE_10M // mesh.size]
        np.savez(d / f"ingest_nn.{r}.npz", q=q[rows].cpu().numpy(),
                 m=m[rows].cpu().numpy(), bad=bad[rows].cpu().numpy())
        keep = rows[~bad[rows]]
        li, ld = nn_exact(m[keep].contiguous(), part.halo_pts[r])
        checked[r] = dict(
            most=store[("most", r)],
            rows=int(keep.numel()), repaired=int(rows.numel() - keep.numel()),
            on_slab=bool((ld == 0).all()),
            normals=bool(torch.equal(nrm[keep],
                                     part.halo_nrm[r][li].to(nrm.dtype))))
    info.pop("coarse_tgt")
    info.pop("offset")
    return dict(_result_json(res), **info, checked=checked)


def _failure_worker(mode, pid, nproc, port, outdir):
    """10c's worker (``tests/_torch_failure_worker.py`` on the card):
    "run" runs the segmented registration uninterrupted, then again with
    a rolling checkpoint (process 0) while process 1 SIGKILLs itself at
    iteration ``MP_KILL_AT``; "resume2" continues from the checkpoint on
    fresh processes."""
    import os
    import signal
    from pathlib import Path

    from iterativeclosestpoint_tpu_torch.parallel import (
        RankFailed,
        icp_register_sharded,
    )
    from iterativeclosestpoint_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
        resume_arguments,
        save_checkpoint,
    )
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    mesh = _worker_mesh(pid, nproc, port, ["cuda:0"], "gloo")
    ckpt = Path(outdir) / "fail_ckpt.json"
    src, tgt, _ = make_registration_pair(**MP_FAIL)
    kw = dict(MP_FAIL_KW, device="cuda:0")
    if mode == "resume2":
        patch = resume_arguments(load_checkpoint(ckpt),
                                 MP_FAIL_KW["max_iterations"])
        res = icp_register_sharded(src, tgt, mesh=mesh, **{**kw, **patch})
        return _result_json(res)
    out = dict(uninterrupted=_result_json(
        icp_register_sharded(src, tgt, mesh=mesh, **kw)))

    def segment_cb(state):
        if pid == 0:
            save_checkpoint(
                ckpt, iteration=state["iteration"],
                transform=state["transform"], rmse_history=[],
                prev_error=state["prev_error"],
                no_improve=state["no_improve"],
                transform_local=state["transform_local"],
                center_offset=state["offset"])
        elif state["iteration"] >= MP_KILL_AT:
            print(f"SELF_SIGKILL {time.time()!r}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    try:
        icp_register_sharded(src, tgt, mesh=mesh, segment_callback=segment_cb,
                             **kw)
    except RankFailed as e:
        out["detected"] = [time.time(), str(e)]
        Path(outdir, f"fail-run.{pid}.json").write_text(json.dumps(out))
        print(f"DETECTED {e}", flush=True)
        return None  # the exit code says the run failed
    out["completed"] = True
    return out


def _partition_cards_run(mesh, data10):
    """9b's recipe on a mesh of one process per card: the ladder on this
    process's card, then the partitioned plane run (prep, wall and the
    fine loop's ms/iteration)."""
    from iterativeclosestpoint_tpu_torch import icp_register_multiscale
    from iterativeclosestpoint_tpu_torch.parallel import (
        icp_register_partitioned,
        prepare_partition,
    )
    from iterativeclosestpoint_tpu_torch.runtime.timing import collect

    dev = mesh.local_devices[0]
    src, tgt = data10["src"], data10["tgt"]
    ladder = icp_register_multiscale(src, tgt, device=dev,
                                     **PART_LADDER_KW).final
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    pp = prepare_partition(tgt, mesh=mesh, estimator="plane",
                           n_queries_hint=len(src))
    torch.cuda.synchronize(dev)
    t_prep = time.perf_counter() - t0
    with collect(sync=True) as col:
        t0 = time.perf_counter()
        res = icp_register_partitioned(
            src, tgt, mesh=mesh, prepared_partition=pp,
            initial_transform=ladder.transform, **PART_KW)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return dict(_result_json(res), prep=t_prep, wall=wall,
                fine_ms=col.stages["loop"] * 1e3 / max(res.iterations, 1))


def worker(argv) -> int:
    """``chip_smoke.py --worker JOB PID NPROC PORT OUTDIR``: one process
    of a phase-10 (or ``--across-cards``) process group; writes its result
    to ``OUTDIR/JOB.PID.json``."""
    from pathlib import Path

    job, pid, nproc, port, outdir = (argv[0], int(argv[1]), int(argv[2]),
                                     argv[3], argv[4])
    if job.startswith("fail-"):
        out = _failure_worker(job[len("fail-"):], pid, nproc, port, outdir)
        if out is None:
            return 1
    elif job == "dp":
        mesh = _worker_mesh(pid, nproc, port, ["cuda:0"], "gloo")
        out = _dp_run(mesh, make_data(HEADLINE), 1)
    elif job == "ingest":
        mesh = _worker_mesh(pid, nproc, port, ["cuda:0"], "gloo")
        out = _worker_ingest(mesh, outdir)
    elif job == "cards-dp":
        mesh = _worker_mesh(pid, nproc, port, [f"cuda:{pid}"])
        out = _dp_run(mesh, make_data(HEADLINE), 3)
    elif job == "cards-partition":
        mesh = _worker_mesh(pid, nproc, port, [f"cuda:{pid}"])
        out = _partition_cards_run(mesh, make_data(PLANE_10M))
    else:
        print(f"chip_smoke: unknown worker job {job!r}", file=sys.stderr)
        return 2
    Path(outdir, f"{job}.{pid}.json").write_text(json.dumps(out))
    import torch.distributed as dist

    if dist.is_initialized():
        # Every process leaves together: process 0 holds the group's
        # store, and exiting under a peer still using it can abort it.
        dist.barrier()
        dist.destroy_process_group()
    return 0


def _same_bits(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in ("transform", "history", "rmse",
                                      "iterations", "stop_reason"))


def phase_multiprocess(data, data10, measured, spec):
    """Phase 10, the mesh over several processes on this one card; see
    the module docstring. Returns {path: launches by shape}."""
    import tempfile
    from pathlib import Path

    from scipy.spatial import cKDTree

    from iterativeclosestpoint_tpu_torch import (
        icp_register,
        icp_register_multiscale,
    )
    from iterativeclosestpoint_tpu_torch.io.las import read_las, write_las
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_nn_device,
    )
    from iterativeclosestpoint_tpu_torch.parallel.ingest import header_center
    from iterativeclosestpoint_tpu_torch.parallel import (
        fill_partition_normals,
        icp_register_sharded,
        make_mesh,
    )
    from iterativeclosestpoint_tpu_torch.parallel import partition as tpart
    from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    card = torch.device("cuda", 0)
    local2 = make_mesh(devices=[card] * MP_PROCESSES)
    paths = {}
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    try:
        # (a) dp over 2 processes sharing the card (gloo)
        spawned = _spawn("dp", MP_PROCESSES, d)
        kw = dict(HEADLINE_KW, device=DEVICE)
        src, tgt = data["src"], data["tgt"]
        base = icp_register_multiscale(src, tgt, **kw)
        _, _, got = _reap("dp", spawned, MP_TIMEOUT_S)
        T_coarse = base.levels[-2][1].transform
        check(all(_unhexed(g["coarse"]).tolist()
                  == np.asarray(T_coarse).ravel().tolist() for g in got),
              "10a: the coarse level differs from one device's")
        fine_kw = {k: v for k, v in HEADLINE_KW.items()
                   if k not in ("coarse_max_points", "coarse_iterations")}
        ref = icp_register_sharded(src, tgt, mesh=local2,
                                   initial_transform=T_coarse,
                                   device=DEVICE, **fine_kw)
        same = all(_same_bits(g, _result_json(ref)) for g in got)
        # The host path on one device: a process mesh's own reference
        # (its source posed in f64 on the host, not on the card).
        fine = icp_register(src, tgt, initial_transform=T_coarse,
                            device=DEVICE, **fine_kw)
        T_g = _unhexed(got[0]["transform"]).reshape(4, 4)
        gap = _pose_gap(T_g, fine.transform, src)
        for pid, g in enumerate(got):
            print(f"[10a mp dp] process {pid} of {MP_PROCESSES} (1 rank each, "
                  f"gloo on {card}): wall {g['walls'][0]:.4f} s; fine "
                  f"{g['fine_ms']:.4f} ms/iteration (synced run); collective "
                  f"bytes per iteration per rank {g['bytes']}; launches "
                  f"{g['launches']}", flush=True)
        print(f"[10a mp dp] {got[0]['iterations']} iterations, "
              f"{got[0]['message']!r} (one device {fine.iterations}, "
              f"{fine.message!r}); transform and history bit-equal to 1 "
              f"process of {MP_PROCESSES} ranks: {same}; registration error "
              f"against one device on the host path {gap:.3e} m, against "
              f"one device's multiscale run "
              f"{_pose_gap(T_g, base.final.transform, src):.3e} m",
              flush=True)
        check(same, "10a: 2 processes differ from 1 process of 2 ranks")
        check((got[0]["iterations"], got[0]["stop_reason"])
              == (fine.iterations, int(fine.stop_reason)) and gap <= 1e-4,
              "10a: differs from one device")
        check(all(g["launches"]["colsweep_fused"] > 0
                  and g["launches"]["brute_nn"] > 0 for g in got),
              "10a: K1 or K3 never launched in a process")
        paths["mp_dp"] = _shapes_in(got)
        _hold_unheld("10a mp dp", paths["mp_dp"], measured, spec, {},
                     torch.as_tensor(data["src_local"], device=dev),
                     torch.as_tensor(data["tgt_local"], device=dev))

        # (b) the streamed ingest at 10M on 2 processes sharing the card
        t0 = time.perf_counter()
        sp, tp = d / "src.las", d / "tgt.las"
        write_las(sp, data10["src"])
        write_las(tp, data10["tgt"])
        print(f"[10b mp ingest] wrote phase 4d's pair as LAS "
              f"({time.perf_counter() - t0:.3f} s)", flush=True)
        spawned = _spawn("ingest", MP_PROCESSES, d)
        # The ingested frame: the decoded (LAS-quantized) target centred
        # on its header's bounds.
        tgt_dec, hdr = read_las(tp)
        tree = cKDTree((tgt_dec - header_center(hdr)).astype(np.float32)
                       .astype(np.float64))
        del tgt_dec
        _, _, got = _reap("ingest", spawned, MP_TIMEOUT_S)
        for pid, g in enumerate(got):
            ts, ss = g["target"], g["source"]
            print(f"[10b mp ingest] process {pid}: prep {g['prep']:.4f} s "
                  f"(samples, walls, grid parameters {g['grid_params']}, "
                  f"coarse carry); ingest {g['ingest']:.4f} s (kept "
                  f"{ts['retained_rows']} of {ts['total_rows']} target and "
                  f"{ss['retained_rows']} of {ss['total_rows']} source "
                  f"rows, largest batch {ts['peak_batch_rows']}); loop "
                  f"{g['loop']:.4f} s, {g['iterations']} iterations, "
                  f"{g['message']!r}; launches {g['launches']}", flush=True)
            check(ts["retained_rows"] < ts["total_rows"]
                  and ss["retained_rows"] < ss["total_rows"]
                  and ts["peak_batch_rows"] <= MP_BATCH,
                  f"10b: process {pid} kept the whole cloud or a batch "
                  "past its size")
            cap = MP_REPAIR["repair_budget"] * MP_REPAIR["repair_passes"]
            for r, c in g["checked"].items():
                print(f"[10b mp ingest] rank {r}: most rows sent to the "
                      f"collective repair in one iteration {c['most']} "
                      f"(covered: {cap}); {c['rows']} sampled rows the "
                      f"repair did not touch ({c['repaired']} it did): "
                      f"winners on the rank's slab {c['on_slab']}, normals "
                      f"the winners' slab normals {c['normals']}",
                      flush=True)
                check(c["most"] <= cap,
                      f"10b: rank {r} sent more rows than the repair covers")
                check(c["on_slab"] and c["normals"],
                      f"10b: rank {r}'s normals are not its winners'")
        res2, info2, part2, _ = _ingest_sequence(local2, sp, tp, card,
                                                 **MP_REPAIR)
        same = all(_same_bits(g, _result_json(res2)) for g in got)
        print(f"[10b mp ingest] 1 process of {MP_PROCESSES} ranks: prep "
              f"{info2['prep']:.4f} s, ingest {info2['ingest']:.4f} s, loop "
              f"{info2['loop']:.4f} s; {MP_PROCESSES} processes bit-equal "
              f"to it: {same}", flush=True)
        check(same, "10b: 2 processes differ from 1 process of 2 ranks")
        q, m, bad = [], [], []
        for f in sorted(d.glob("ingest_nn.*.npz")):
            z = np.load(f)
            q.append(z["q"])
            m.append(z["m"])
            bad.append(z["bad"])
        qh = np.concatenate(q).astype(np.float64)
        mh = np.concatenate(m).astype(np.float64)
        d_ref, _ = tree.query(qh, workers=-1)
        d0, _ = tree.query(mh, workers=-1)
        wgap = float(np.abs(np.linalg.norm(mh - qh, axis=1) - d_ref).max())
        print(f"[10b mp ingest] last iteration's NN on {len(qh)} sampled "
              f"rows ({int(np.concatenate(bad).sum())} repaired): matched "
              f"rows are target points: {not d0.any()}; winners' f64 "
              f"distance - cKDTree {wgap:.3e} m", flush=True)
        check(not d0.any() and wgap <= 1e-9,
              "10b: a match is not a nearest neighbour")
        del tree, q, m, qh, mh
        paths["mp_ingest"] = _shapes_in(got)
        # The shapes' grids: each rank's slab grids (the 1-process run's
        # slabs are the processes' own) and the coarse sample's.
        gp = info2["grid_params"]
        part2 = fill_partition_normals(part2,
                                       resolution=gp["normals_resolution"])
        slabs = {}
        for r in range(MP_PROCESSES):
            slab = part2.halo_pts[r]
            grid, cgrid, _, _ = tpart._slab_grids(
                slab, part2.halo_nrm[r], resolution=gp["resolution"],
                trange=gp["trange"], coarse_trange=gp["coarse_trange"],
                fine_kernel=gp["fine_kernel"])
            slabs[f"ingest rank {r}"] = (
                (None, (grid, cgrid, part2.halo_nrm[r]), gp["resolution"]),
                slab.cpu().numpy(), slab)
        ct = info2["coarse_tgt"]
        ct_local = (ct - center_offset(ct)).astype(np.float32)
        ct_dev = torch.as_tensor(ct_local, device=dev)
        slabs["coarse sample"] = (
            make_pallas_nn_device(ct_local, target_dev=ct_dev,
                                  with_normals=True),
            ct_local, ct_dev)
        _hold_unheld("10b mp ingest", paths["mp_ingest"], measured,
                     spec, slabs,
                     torch.as_tensor(data10["src_local"][:1 << 16],
                                     device=dev),
                     torch.as_tensor(data10["tgt_local"], device=dev))
        del slabs, part2
        # icp-torch on the same files, one rank in this process, against
        # the library sequence on the same mesh.
        res1, info1, _, _ = _ingest_sequence(make_mesh(device=DEVICE), sp,
                                             tp, dev)
        t0 = time.perf_counter()
        _, out = _cli("--device", "cuda", "run", sp, tp, "--parallel",
                      "partition", "--ingest", "--estimator", "plane",
                      "--max-iterations", PART_KW["max_iterations"],
                      "--tolerance", PART_KW["tolerance"],
                      "--checkpoint", d / "ck.json")
        wall = time.perf_counter() - t0
        T_cli = np.asarray(json.loads((d / "ck.json").read_text())[
            "transform"])
        same = np.array_equal(T_cli, res1.transform)
        stages = [ln for ln in out.splitlines()
                  if ln.startswith(("ingest-partitioned", "coarse sample",
                                    "streamed ingest", "iterations:"))]
        print(f"[10b icp-torch run --parallel partition --ingest] {wall:.4f}"
              f" s; {stages}; the library sequence on 1 rank (prep "
              f"{info1['prep']:.4f} s, ingest {info1['ingest']:.4f} s, loop "
              f"{info1['loop']:.4f} s, {res1.iterations} iterations): "
              f"transform bit-equal: {same}", flush=True)
        check(same, "10b: icp-torch --ingest differs from the library")
        for path in (sp, tp):
            path.unlink()

        # (c) a lost process on the card, and the resume
        spawned = _spawn("fail-run", MP_PROCESSES, d)
        rcs, outs, got = _reap("fail-run", spawned, MP_TIMEOUT_S,
                               expect_ok=False)
        killed = [ln for ln in outs[1].splitlines()
                  if ln.startswith("SELF_SIGKILL ")]
        check(rcs[1] == -9 and killed,
              f"10c: process 1 did not SIGKILL itself: {outs[1][-3000:]}")
        g = got[0]
        check(rcs[0] not in (0, None) and g is not None
              and "detected" in g and "completed" not in g,
              f"10c: the survivor did not fail: {outs[0][-3000:]}")
        seen = g["detected"][0] - float(killed[0].split()[1])
        print(f"[10c mp failure] process 1 killed at iteration {MP_KILL_AT}; "
              f"process 0 exited {rcs[0]} {seen:.3f} s later: "
              f"{g['detected'][1][:300]}", flush=True)
        check(0.0 <= seen < MP_DETECT_S
              and "mesh process 1 (ranks [1]) was lost" in g["detected"][1],
              "10c: the survivor did not name the lost process in time")
        ck = json.loads((d / "fail_ckpt.json").read_text())
        check(ck["iteration"] == MP_KILL_AT, f"10c: checkpoint at {ck}")
        spawned = _spawn("fail-resume2", MP_PROCESSES, d)
        _, _, res_r = _reap("fail-resume2", spawned, MP_TIMEOUT_S)
        u = g["uninterrupted"]
        tail = _unhexed(u["rmse"])[MP_KILL_AT:].tolist()
        same = all(_unhexed(r["rmse"]).tolist() == tail
                   and r["transform"] == u["transform"] for r in res_r)
        print(f"[10c mp failure] two fresh processes resumed from the "
              f"iteration-{MP_KILL_AT} checkpoint: tail and transform "
              f"bit-equal to the uninterrupted run: {same}", flush=True)
        check(same, "10c: the resume differs from the uninterrupted run")
    finally:
        tmp.cleanup()
    print(f"[10] phase 10 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def phase_bench(measured, spec, head_rmse):
    """Phase 11a, ``icp-torch bench`` in a subprocess on the card; see the
    module docstring. Returns its launches by shape (the subprocess's own
    tally, which it logs)."""
    import os
    import re

    from iterativeclosestpoint_tpu_torch.bench import parity_pair

    torch.cuda.empty_cache()  # the subprocess needs the card's memory
    env = {**os.environ, "BENCH_REPS": str(BENCH_REPS),
           "BENCH_SMOKE": "0", "BENCH_BASELINE_N": str(BENCH_BASELINE_N)}
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "iterativeclosestpoint_tpu_torch.cli",
         "--device", DEVICE, "bench"],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S, env=env)
    wall = time.perf_counter() - t0
    err = r.stderr
    print(f"[11a bench] icp-torch bench (BENCH_REPS={BENCH_REPS}, "
          f"BENCH_SMOKE=0, BENCH_BASELINE_N={BENCH_BASELINE_N}: the native "
          f"baseline at a quarter of N) exited {r.returncode} after "
          f"{wall:.1f} s", flush=True)
    check(r.returncode == 0,
          f"11a: icp-torch bench exited {r.returncode}: {err[-6000:]}")
    keep = ("card:", "nn-slab-sweep", "reject+moments:", "terrain:",
            "breakdown:", "volume:", "nn-zcol", "plane:", "baseline:",
            "parity:", "launches:", "total:")
    for ln in err.splitlines():
        if ln.startswith(keep) and not ln.startswith("launch shapes:"):
            print(f"[11a bench] {ln}", flush=True)
    out_lines = r.stdout.strip().splitlines()
    check(bool(out_lines), "11a: bench printed no JSON line")
    line = json.loads(out_lines[-1])
    print(f"[11a bench] JSON: {out_lines[-1]}", flush=True)
    row_keys = {"blended_pts_per_s", "seconds", "rmse",
                "fine_loop_pts_per_s", "fine_ms_per_iter"}
    check(set(line) == {"metric", "value", "unit", "vs_baseline", "rows"}
          and set(line["rows"]) == {"terrain", "volume", "plane"}
          and all(set(v) == row_keys for v in line["rows"].values()),
          f"11a: the JSON line's keys or rows differ: {line}")
    m = re.search(r"^terrain: .*rmse=([^,]+), fine iterations (\d+)\)$",
                  err, re.M)
    check(m is not None, "11a: no terrain line")
    rmse, iters = float(m.group(1)), int(m.group(2))
    print(f"[11a bench] terrain: {iters} fine iterations, rmse {rmse!r} "
          f"against phase 4's {head_rmse!r}: bit-equal {rmse == head_rmse}",
          flush=True)
    check(iters == HEADLINE_KW["max_iterations"],
          f"11a: terrain ran {iters} fine iterations")
    check(rmse == head_rmse, "11a: the terrain rmse differs from phase 4's")
    check(isinstance(line["vs_baseline"], (int, float))
          and line["vs_baseline"] > 0, "11a: vs_baseline is not a number")
    p = re.search(r"^parity: reference iters=(\d+) .*transform error vs "
                  r"reference = (\S+) m", err, re.M)
    check(p is not None and float(p.group(2)) < 1e-4,
          "11a: parity above 1e-4 m")
    launches = json.loads(re.search(r"^launches: (.*)$", err,
                                    re.M).group(1))
    for name in ("colsweep_fused", "colsweep", "brute_nn"):
        check(launches[name] > 0, f"11a: {name} never launched")
    shapes = json.loads(re.search(r"^launch shapes: (.*)$", err,
                                  re.M).group(1))
    by_shape = {(nm, tuple(sh)): c for nm, sh, c in shapes}
    dev = torch.device(DEVICE)
    psrc, ptgt = parity_pair()
    _hold_unheld("11a bench", by_shape, measured, spec, {},
                 torch.as_tensor(psrc.astype(np.float32), device=dev),
                 torch.as_tensor(ptgt.astype(np.float32), device=dev))
    return by_shape


def phase_oracle():
    """Phase 11b, the card's f64 trajectories against the port's f64
    oracle; see the module docstring."""
    from iterativeclosestpoint_tpu_torch import icp_register
    from iterativeclosestpoint_tpu_torch.utils.oracle import oracle_icp
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    for seed in (0, 3):
        src, tgt, _ = make_registration_pair(n=ORACLE_N, seed=seed,
                                             noise_sigma=0.02)
        for mode in ("gui", "cli"):
            t0 = time.perf_counter()
            res = icp_register(src, tgt, dtype=torch.float64, mode=mode,
                               max_iterations=30, center=False,
                               nn_backend="bruteforce", device=DEVICE)
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = oracle_icp(src, tgt, max_iterations=30, mode=mode)
            t_oracle = time.perf_counter() - t0
            check(res.iterations == len(ref.history)
                  and res.message == ref.message,
                  f"11b seed {seed} {mode}: {res.iterations} iterations "
                  f"({res.message}) against the oracle's "
                  f"{len(ref.history)} ({ref.message})")
            t_gap = max(float(np.abs(res.history_transform[i]
                                     - h.transform).max())
                        for i, h in enumerate(ref.history))
            r_gap = max(abs(res.history_rmse[i] - h.rmse) / h.rmse
                        for i, h in enumerate(ref.history))
            same_valid = all(res.history_valid[i] == h.valid_points
                             for i, h in enumerate(ref.history))
            print(f"[11b oracle] seed {seed} {mode}: {res.iterations} "
                  f"iterations ({res.message}) on the card in {t_card:.3f} s"
                  f", the oracle in {t_oracle:.3f} s; max |T - T_oracle| "
                  f"over every iteration {t_gap:.3e}, rmse {r_gap:.3e} "
                  f"relative; inlier counts equal: {same_valid}", flush=True)
            check(t_gap <= 1e-9 and r_gap <= 1e-9 and same_valid,
                  f"11b seed {seed} {mode}: off the oracle")


def phase_f64_pallas(measured, spec):
    """Phase 11b's f64 pallas case: ``nn_backend="pallas"`` at f64 on a
    pair whose uncertified queries reach the sweep's brute tiers, which
    run the plain f64 brute force (``nn_exact``), point and plane, 10
    iterations, on the card against the CPU: the brute tier fires at f64,
    the same iterations and stop code, every iteration's transform within
    1e-9 (point) and the final one within 1e-8 (plane)."""
    from iterativeclosestpoint_tpu_torch import icp_register
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops import sweep_nn
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    src, tgt, _ = make_registration_pair(**F64_PALLAS)
    exact = sweep_nn.nn_exact
    calls = []

    def counted(query, target):
        calls.append((str(query.dtype), query.shape[0], target.shape[0]))
        return exact(query, target)

    kept, restore = _spy_pallas_grids()
    by_shape = {}
    runs = {}
    try:
        for est in ("point", "plane"):
            kw = dict(dtype=torch.float64, nn_backend="pallas",
                      estimator=est, max_iterations=10)
            sweep_nn.nn_exact = counted
            sk.reset_launches()
            t0 = time.perf_counter()
            card = icp_register(src, tgt, device=DEVICE, **kw)
            t_card = time.perf_counter() - t0
            sweep_nn.nn_exact = exact
            for key, n in sk.LAUNCH_SHAPES.items():
                by_shape[key] = by_shape.get(key, 0) + n
            t0 = time.perf_counter()
            cpu = icp_register(src, tgt, device="cpu", **kw)
            runs[est] = (card, t_card, cpu, time.perf_counter() - t0,
                         list(calls), dict(sk.LAUNCHES))
            del calls[:]
    finally:
        restore()
        sweep_nn.nn_exact = exact
    for est, tol in (("point", 1e-9), ("plane", 1e-8)):
        card, t_card, cpu, t_cpu, brute, launches = runs[est]
        gap_all = float(np.abs(card.history_transform
                               - cpu.history_transform).max())
        gap = float(np.abs(card.transform - cpu.transform).max())
        print(f"[11b f64 pallas] {est}, {len(src)} points: card "
              f"{card.iterations} iterations ({card.message}, stop "
              f"{card.stop_reason}) in {t_card:.3f} s, cpu "
              f"{cpu.iterations} ({cpu.message}, stop {cpu.stop_reason}) "
              f"in {t_cpu:.3f} s; brute-tier calls on the card "
              f"{len(brute)} {sorted(set(brute))}; kernel launches "
              f"{launches}; max |T_card - T_cpu| over every iteration "
              f"{gap_all:.3e}, final {gap:.3e}", flush=True)
        check(brute and all(c[0] == "torch.float64" for c in brute),
              f"11b f64 pallas {est}: no brute tier, or one below f64")
        check((card.iterations, card.stop_reason)
              == (cpu.iterations, cpu.stop_reason),
              f"11b f64 pallas {est}: iterations or stop code differ")
        held = gap_all if est == "point" else gap
        check(held <= tol,
              f"11b f64 pallas {est}: card and cpu differ by {held}")
    _hold_small_runs("11b f64 pallas", by_shape, measured, spec, kept)


def _one_f32_ulp(ours, ref):
    """The largest distance in f32 ulps between the entries of ``ours``
    and ``ref``; entries both within 1e-12 of the scale of 0 (f64
    round-off of an exact zero) count as equal."""
    scale = float(np.abs(ref).max())
    tiny = (np.abs(ref) <= 1e-12 * scale) & (np.abs(ours) <= 1e-12 * scale)
    a = np.where(tiny, 0, ours).astype(np.float32).view(np.int32)
    b = np.where(tiny, 0, ref).astype(np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _margin_gap(q, t, chunk=512):
    """Per query, the explicit d² (f64) from its best target point to the
    best one at other coordinates, on ``q``'s device in chunks."""
    from iterativeclosestpoint_tpu_torch.ops.bruteforce import sq_dist

    q, t = q.double(), t.double()
    out = []
    for q0 in range(0, q.shape[0], chunk):
        d2 = sq_dist(q[q0:q0 + chunk], t)
        best, arg = d2.min(dim=1)
        same = (t[None, :, :] == t[arg][:, None, :]).all(dim=-1)
        other = torch.where(same, torch.full_like(d2, float("inf")), d2)
        out.append(other.min(dim=1).values - best)
    return torch.cat(out)


def phase_options(measured, spec):
    """Phase 12, the JAX package's last public options on the card; see
    the module docstring."""
    from iterativeclosestpoint_tpu_torch.ops.bruteforce import (
        _matmul_d2,
        _norm2,
        nn_bruteforce,
        winner_dist,
    )
    from iterativeclosestpoint_tpu_torch.ops.kabsch import (
        kabsch,
        kabsch_masked,
    )
    from iterativeclosestpoint_tpu_torch.runtime.profiling import (
        nn_kernel_report,
    )
    from iterativeclosestpoint_tpu_torch.utils.oracle import (
        best_fit_transform,
    )

    dev = torch.device(DEVICE)
    d = make_data(OPTIONS_PAIR)
    src, tgt = d["src_local"], d["tgt_local"]
    mask = np.random.default_rng(12).uniform(size=len(src)) > 0.3
    bad = src.copy()
    bad[13, 1] = np.nan  # phase 6's non-finite coordinate

    def fit(fn, device, s=src):
        st = torch.as_tensor(s, device=device)
        tt = torch.as_tensor(tgt, device=device)
        if fn == "kabsch":
            return kabsch(st, tt, torch.float64).cpu().numpy()
        return kabsch_masked(st, tt, torch.as_tensor(mask, device=device),
                             torch.float64).cpu().numpy()

    for fn in ("kabsch", "kabsch_masked"):
        card, cpu = fit(fn, dev), fit(fn, "cpu")
        sel = slice(None) if fn == "kabsch" else mask
        oracle = best_fit_transform(src[sel].astype(np.float64),
                                    tgt[sel].astype(np.float64))
        gap = float(np.abs(card[:3] - cpu[:3]).max())
        ulp = _one_f32_ulp(card, oracle.astype(np.float32))
        nan = fit(fn, dev, bad)
        print(f"[12 options] {fn}(accum_dtype=float64) on {len(src)} f32 "
              f"points: result {card.dtype}; max |R, t card - cpu| {gap:.3e}"
              f"; max ulp from the f64 oracle's fit in f32 {ulp}; NaN source "
              f"row: R and t all NaN {bool(np.isnan(nan[:3]).all())}, last "
              f"row {nan[3].tolist()}", flush=True)
        check(card.dtype == np.float32 and gap <= 1e-12 and ulp <= 1,
              f"12 {fn} with f64 sums: card - cpu {gap}, oracle ulp {ulp}")
        check(bool(np.isnan(nan[:3]).all())
              and nan[3].tolist() == [0, 0, 0, 1],
              f"12 {fn} with f64 sums: a NaN source is not the NaN "
              "transform")

    rows = slice(0, MATMUL_QUERIES)
    q64 = d["src"][rows] - d["offset"]
    t64 = d["tgt"] - d["offset"]
    for dt, q, t in (("float64", q64, t64),
                     ("float32", src[rows], tgt)):
        qc, tc = (torch.as_tensor(x, device=dev) for x in (q, t))
        qh, th = torch.as_tensor(q), torch.as_tensor(t)
        ms, (ci, cd) = cuda_ms(lambda: nn_bruteforce(qc, tc, use_matmul=True),
                               reps=3)
        ems, (ei, _) = cuda_ms(lambda: nn_bruteforce(qc, tc), reps=3)
        hi, hd = nn_bruteforce(qh, th, use_matmul=True)
        # The ranking d² of the first 512 queries on both devices.
        d2 = [_matmul_d2(x[:512], _norm2(x[:512]), y).cpu()
              for x, y in ((qc, tc), (qh, th))]
        exact = torch.equal(cd, winner_dist(qc, tc, ci))
        ci, cd, ei = ci.cpu(), cd.cpu(), ei.cpu()
        c2 = max(float((qc.double() ** 2).sum(1).max()),
                 float((tc.double() ** 2).sum(1).max()))
        margin = 4 * c2 * torch.finfo(qc.dtype).eps
        sure = (_margin_gap(qc, tc) > margin).cpu()
        differ = ci != ei
        print(f"[12 options] nn_bruteforce(use_matmul=True) {dt}, "
              f"{len(q)} x {len(t)} centred: card {ms:.4f} ms, explicit "
              f"form {ems:.4f} ms (CUDA-event median of 3); rows whose "
              f"index differs from the explicit form's {int(differ.sum())}"
              f", rows inside the margin 4·|c|²·eps = {margin:.4e} "
              f"{int((~sure).sum())}, differing rows outside it "
              f"{int((differ & sure).sum())}; card = cpu: d² of the first "
              f"512 rows {torch.equal(*d2)}, indices {torch.equal(ci, hi)}, "
              f"distances differing {int((cd != hd).sum())} (max "
              f"{float((cd - hd).abs().max()):.3e}; the two devices' "
              "square roots)", flush=True)
        check(exact, f"12 use_matmul {dt}: a distance is not the explicit "
              "one to its winner")
        check(torch.equal(ci, hi) and torch.equal(ci[sure], ei[sure]),
              f"12 use_matmul {dt}: an index differs from the cpu's, or "
              "from the explicit form's outside the margin")

    # The roofline of phase 3's K1 launch on the 1M terrain's fine grid:
    # the launch's own report (live pairs, the bytes it moves) and the
    # every-lane model of nn_kernel_report beside it.
    e = min(measured["colsweep_fused"][(4, 768)], key=lambda x: x["tiles"])
    rep = launch_report(f"K1 {e['shape']}", e["ms"], e["pairs"],
                        e["bytes"], spec)
    lanes = nn_kernel_report(e["tiles"] * 128, 128, 4, 768, e["ms"] / 1e3,
                             spec, name="nn_kernel_report, every lane")
    print(f"[12 options] {rep.line()}", flush=True)
    print(f"[12 options] {lanes.line()}", flush=True)
    print(f"[12 options] K1 1M: sol {rep.sol:.4f}, bound "
          f"{rep.bound_s * 1e3:.4f} ms ({rep.bound_by}); phase 3's Bound ms "
          f"{e['bound_ms']:.4f}", flush=True)
    check(rep.bound_s * 1e3 == e["bound_ms"] and rep.sol == max(
        rep.sol_compute, rep.sol_memory),
          "12: the K1 report's bound is not phase 3's")


def _sweep_ft(results, label, win, tgt_t, slabs, trange, fused, replaces,
              spec, plain_reps=5):
    """A sweep's first-tie form against its plain version on one window
    (all its tiles): rows 0-7 bit for bit, row 7 all 1, and rows 0-6 the
    default form's wherever that one is unique. Keyed as the default
    form's launches (K1: (slabs, trange); K2: (tiles, slabs, trange))."""
    from iterativeclosestpoint_tpu_torch.ops.sweep_kernels import (
        colsweep,
        colsweep_plain,
        sweep_splits,
    )

    t = win.base.shape[0]
    args = (win.base, win.q32, tgt_t)
    kw = dict(slabs=slabs, trange=trange, fused=fused, slack=win.slack,
              first_tie=True)
    default = colsweep(*args, **dict(kw, first_tie=False))

    def compare_ft(out_k, out_p):
        check(torch.equal(out_k, out_p),
              f"13 {label}: the first-tie form differs from plain")
        check(bool((out_k[:, 7] == 1.0).all()), f"13 {label}: row 7 not 1")
        unique = (default[:, 7] == 1.0)[:, None, :].expand(-1, 7, -1)
        check(torch.equal(out_k[:, 0:7][unique], default[:, 0:7][unique]),
              f"13 {label}: a winner differs from the default form's "
              "unique one")
        return 0.0, (f", rows where the default form ties "
                     f"{int((default[:, 7] != 1.0).sum())}")

    if fused:
        v = win.slack.long()
        pairs = int(torch.clamp(torch.minimum(v >> 7, trange - (v & 127)),
                                min=0).sum()) * 128
        name, key, extra = "colsweep_fused_ft", (slabs, trange), dict(tiles=t)
        shape = f"{t} tiles x {slabs} slots, trange {trange}"
    else:
        pairs = _distinct_rows(win.base, trange) * 128
        splits = sweep_splits(t, slabs, trange, tgt_t.device)
        name, key, extra = "colsweep_ft", (t, slabs, trange), dict(
            splits=splits)
        shape = f"{t} tiles x {slabs} slabs, trange {trange}"
    entry = _timed_pair(
        f"{name} {label}, {shape}", lambda: colsweep(*args, **kw),
        lambda: colsweep_plain(*args, **kw), compare_ft, pairs,
        t * 128 * 12 + t * slabs * (8 if fused else 4)
        + (tgt_t.shape[1] - trange) * 12 + t * 8 * 128 * 4, spec,
        plain_reps=plain_reps, tag="13 first-tie")
    entry.update(shape=shape, replaces=replaces, **extra)
    _record(results, name, key, entry)
    return entry


def _fine_dispatches():
    """Record the ICP loop's dispatches of ≥ ``AUTO_SEGMENT_POINTS`` rows:
    (rows, iterations) per ``icp_core`` call. Returns (calls, restore)."""
    from iterativeclosestpoint_tpu_torch.models import icp as ticp

    orig = ticp.icp_core
    calls = []

    def spy(source, *a, **kw):
        if source.shape[0] >= ticp.AUTO_SEGMENT_POINTS:
            calls.append((source.shape[0], kw["max_iterations"]))
        return orig(source, *a, **kw)

    ticp.icp_core = spy

    def restore():
        ticp.icp_core = orig

    return calls, restore


def phase_first_tie(data, measured, spec):
    """Phase 13, the JAX package's last left-out surface on the card; see
    the module docstring. Returns the launches by shape of its paths
    (``first_tie``, ``host_factory``, ``autoseg_one``, ``autoseg``)."""
    from iterativeclosestpoint_tpu_torch import icp_register_multiscale
    from iterativeclosestpoint_tpu_torch.models import icp as ticp
    from iterativeclosestpoint_tpu_torch.models.prep import prepare_level
    from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
    from iterativeclosestpoint_tpu_torch.ops.normals import (
        estimate_normals_cellpca_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
        build_grid,
        build_pallas_grid,
        grouped_tile_order,
        grouped_tile_order_device,
    )
    from iterativeclosestpoint_tpu_torch.ops.sweep_nn import (
        make_pallas_brute,
        make_pallas_nn,
        make_pallas_nn_device,
        nn_colsweep,
    )

    dev = torch.device(DEVICE)
    tpu = "iterativeclosestpoint_tpu/ops/pallas_nn.py"
    paths = {}
    t_phase = time.perf_counter()

    # (a) and (b): the sweep calls of the first-tie path, each a tile
    # layout, a grid and its (resolution, slabs, trange, fused).
    rng = np.random.default_rng(13)
    base = rng.normal(size=(FT_TRIPLE, 3)) * 10.0
    trip = np.repeat(base, 3, axis=0)
    q_trip = base + rng.normal(0, 0.05, base.shape)
    cases = []
    for trange, fused in ((768, True), (1536, False)):
        g = build_pallas_grid(trip, 16, trange=trange, device=dev)
        rows, _ = grouped_tile_order(q_trip, g, 16)
        cases.append((f"triplicated {len(trip)} points", torch.as_tensor(
            q_trip[rows], dtype=torch.float32, device=dev), g, 16, 4, trange,
                      fused))
    tgt_dev = torch.as_tensor(data["tgt_local"], device=dev)
    fn_d, state_d, R = make_pallas_nn_device(data["tgt_local"],
                                             target_dev=tgt_dev)
    grid = state_d[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    q = tgt_dev + 0.02 * torch.randn(tgt_dev.shape, generator=gen,
                                     device=dev)
    rows, _ = grouped_tile_order_device(q, grid.origin, grid.cell_size,
                                        resolution=R)
    ql = q[rows].contiguous()
    m = tgt_dev.shape[0]
    check(grid.tgt_t.shape[1] - m == 768, "13: the 1M fine grid's trange")
    cases.append(("1M terrain fine grid", ql, grid, R, 4, 768, True))
    g1536 = build_grid(tgt_dev, grid.origin, grid.cell_size, resolution=R,
                       trange=1536)
    cases.append(("1M terrain, the 10M base's trange", ql, g1536, R, 4, 1536,
                  False))
    stride = -(-len(data["src"]) // HEADLINE_KW["coarse_max_points"])
    c_src = torch.as_tensor(np.ascontiguousarray(data["src_local"][::stride]),
                            device=dev)
    c_tgt = data["tgt_local"][::stride]
    brute_fn, cell1 = make_pallas_brute(c_tgt, device=dev)
    tr1 = cell1.tgt_t.shape[1] - len(c_tgt)
    cases.append((f"one-cell grid of the coarse target", c_src, cell1, 1, 1,
                  tr1, False))

    sk.reset_launches()
    outs = [nn_colsweep(qq, g, resolution=r, slabs=s, trange=tr, fused=f,
                        first_tie=True) for _, qq, g, r, s, tr, f in cases]
    b_m, b_d = brute_fn(c_src, None, cell1)
    torch.cuda.synchronize()
    paths["first_tie"] = dict(sk.LAUNCH_SHAPES)
    launches = dict(sk.LAUNCHES)
    print(f"[13 first-tie] path launches {launches}", flush=True)
    check(launches["colsweep_fused_ft"] > 0 and launches["colsweep_ft"] > 0
          and launches["brute_nn"] > 0,
          "13: a first-tie form or K3 did not launch")
    for (label, qq, g, r, s, tr, f), out in zip(cases, outs):
        check(r == 1 or bool(out[3].any()), f"13 {label}: nothing certified")
        n = -(-qq.shape[0] // 128) * 128
        qp = torch.cat([qq, qq[-1:].expand(n - qq.shape[0], 3)])
        win = _hold_window(measured, f"13 {label}", "slab", qp, g, dict(
            resolution=r, tile_q=128, slabs=s, trange=tr, fused=f), spec)
        e = _sweep_ft(measured, label, win, g.tgt_t, s, tr, f,
                      f"{tpu}:{1272 if f else 1103}", spec)
        if r == 1:
            ft_entry = e
    # (b) make_pallas_brute's K3 and K2's first-tie form on one cell.
    one = outs[-1]
    check(torch.equal(b_m, one[0]) and torch.equal(b_d, one[2]),
          "13: make_pallas_brute (K3) and the one-cell first-tie sweep "
          "disagree")
    k3 = measured["brute_nn"][(len(c_tgt), len(c_tgt))][0]
    print(f"[13 first-tie] make_pallas_brute on the {len(c_tgt)}-point "
          f"coarse target: every winner and distance equal to K2's first-"
          f"tie form on its one-cell grid ({tr1} rows); K3 {k3['ms']:.4f} "
          f"ms (launch step; wrapper {k3['wrapper_ms']:.4f} ms, phase 3) "
          f"against K2 first-tie {ft_entry['ms']:.4f} ms; chunked "
          f"torch.cdist + argmin {k3['library_ms']:.4f} ms (phase 3, the "
          "same inputs)", flush=True)
    ft_entry["library_ms"] = k3["library_ms"]

    # (c) make_pallas_nn's nn_fn against the device factory's, both as
    # icp_register's nn_fn on the same rows in the same order, so that
    # the two runs' sums agree and only the factories differ. The rows:
    # the source in the device grid's x-group order (whose cells nest in
    # the host grid's) at the pose the headline's coarse level reaches,
    # without the layout's padding. A nn_fn caller's source keeps its
    # order, and past 300,000 target points neither factory has the
    # global fallback: its tiles must be compact for the sweeps to
    # certify within the brute tiers' budget.
    off = data["offset"]
    kw = dict(HEADLINE_KW, device=dev)
    T_c = icp_register_multiscale(data["src"], data["tgt"],
                                  **kw).levels[0][1].transform
    fn_h, state_h, R_h = make_pallas_nn(data["tgt"] - off, device=dev)

    def at_pose(T, pts):
        return torch.as_tensor(pts @ T[:3, :3].T + T[:3, 3] - off,
                               dtype=torch.float32, device=dev)

    rows_o, w_o = grouped_tile_order_device(
        at_pose(T_c, data["src"]), grid.origin, grid.cell_size,
        resolution=R)
    src_o = data["src"][rows_o[w_o > 0].cpu().numpy()]

    def inexact(T):
        """Rows of src_o at pose T whose distance from each nn_fn is not
        K3's over the whole target."""
        q_T = at_pose(T, src_o)
        exact = sk.nn_brute(q_T, tgt_dev)[1]
        return [int((f(q_T, tgt_dev, st)[1] != exact).sum())
                for f, st in ((fn_h, state_h), (fn_d, state_d))]

    fine = dict(max_iterations=HEADLINE_KW["max_iterations"],
                tolerance=HEADLINE_KW["tolerance"], return_registered=False,
                initial_transform=T_c, device=dev)
    sk.reset_launches()
    t0 = time.perf_counter()
    host = ticp.icp_register(src_o, data["tgt"], nn_fn=fn_h,
                             nn_state=state_h, **fine)
    wall_h = time.perf_counter() - t0
    paths["host_factory"] = dict(sk.LAUNCH_SHAPES)
    launches = dict(sk.LAUNCHES)
    t0 = time.perf_counter()
    ref = ticp.icp_register(src_o, data["tgt"], nn_fn=fn_d,
                            nn_state=state_d, **fine)
    wall_d = time.perf_counter() - t0
    gap = _pose_gap(host.transform, ref.transform, data["src"])
    wrong = [inexact(T_c), inexact(host.transform)]
    print(f"[13 host factory] make_pallas_nn on the 1M terrain (R={R_h}, "
          f"trange {state_h[0].tgt_t.shape[1] - m}, 6 slabs, coarse R="
          f"{max(R_h // 4, 8)} trange 16384) as nn_fn from the coarse "
          f"level's pose: {host.iterations} iterations, stop "
          f"{host.stop_reason}, {wall_h:.4f} s, launches {launches}; the "
          f"device factory's nn_fn on the same rows: {ref.iterations}, stop "
          f"{ref.stop_reason}, {wall_d:.4f} s; registration gap {gap:.3e} "
          f"m (transforms bit for bit "
          f"{np.array_equal(host.transform, ref.transform)}); rows not "
          f"exact (host, device factory) at the start {wrong[0]}, at the "
          f"host run's end {wrong[1]}", flush=True)
    check((host.iterations, host.stop_reason)
          == (ref.iterations, ref.stop_reason) and gap <= 1e-4
          and wrong == [[0, 0], [0, 0]],
          "13: make_pallas_nn's run differs from the device factory's, or "
          "a distance is not K3's")
    check(host.nn_resolution is None, "13: the host factory's run built a "
          "grid of its own")
    if _unheld(paths["host_factory"], measured):
        _hold_slab_grids(measured, "13 host factory 1M", (fn_h, state_h, R_h),
                         data["tgt_local"], tgt_dev,
                         np.random.default_rng(9), spec, full=False,
                         library=False, slabs=6, fine_tiles=[
                             sh for nm, sh in paths["host_factory"]
                             if nm == "colsweep"])
    left = _unheld(paths["host_factory"], measured)
    check(not left, f"13 host factory: unheld {left}")
    del fn_h, state_h

    # (d) the ≥2M auto-segmentation: a progress callback slices the fine
    # level into max(2, 8,000,000 // n) iterations. One coarse level
    # (the headline's 30,000-point cap would add a middle level at 2M).
    d2 = make_data(AUTOSEG_PAIR)
    kw = dict(kw, coarse_max_points=AUTOSEG_COARSE)
    calls, restore = _fine_dispatches()
    recs, carries = [], []
    try:
        sk.reset_launches()
        t0 = time.perf_counter()
        one_run = icp_register_multiscale(d2["src"], d2["tgt"], **kw)
        wall_one = time.perf_counter() - t0
        paths["autoseg_one"] = dict(sk.LAUNCH_SHAPES)
        launch_one = dict(sk.LAUNCHES)
        one_calls = list(calls)
        calls.clear()
        sk.reset_launches()
        t0 = time.perf_counter()
        seg = icp_register_multiscale(d2["src"], d2["tgt"],
                                      progress_callback=recs.append,
                                      segment_callback=carries.append, **kw)
        wall_seg = time.perf_counter() - t0
        paths["autoseg"] = dict(sk.LAUNCH_SHAPES)
        launch_seg = dict(sk.LAUNCHES)
    finally:
        restore()
    it = seg.final.iterations
    slice_n = max(2, ticp.AUTO_SEGMENT_BUDGET // len(d2["src"]))
    print(f"[13 autoseg] {len(d2['src'])}-point terrain: without callbacks "
          f"fine dispatches {one_calls}, {wall_one:.4f} s; with a progress "
          f"callback {calls}, {wall_seg:.4f} s (one run each, the first "
          f"after phase 13's other runs), records {len(recs)}, carries at "
          f"{[c['iteration'] for c in carries]}; transforms equal "
          f"{np.array_equal(one_run.transform, seg.transform)}; launches "
          f"without callbacks {launch_one}, with {launch_seg}", flush=True)
    check(len(one_calls) == 1
          and one_calls[0][1] == HEADLINE_KW["max_iterations"]
          and [c[1] for c in calls]
          == [min(slice_n, HEADLINE_KW["max_iterations"] - k)
              for k in range(0, len(calls) * slice_n, slice_n)]
          and [r["iteration"] for r in recs] == list(range(1, it + 1))
          and [c["iteration"] for c in carries]
          == sorted(set(range(slice_n, it, slice_n)) | {it}),
          "13: the ≥2M auto-segmentation's slices or records")
    check(np.array_equal(one_run.transform, seg.transform)
          and all(np.array_equal(getattr(one_run.final, f),
                                 getattr(seg.final, f))
                  for f in ("history_rmse", "history_transform")),
          "13: the auto-segmented run is not the one-dispatch run")
    both = {**paths["autoseg_one"], **paths["autoseg"]}
    if _unheld(both, measured):
        _, prep2, _, _ = prepare_level(d2["src"], d2["tgt"], dev,
                                       nn_backend="pallas",
                                       estimator=kw.get("estimator", "point"))
        tgt2 = torch.as_tensor(d2["tgt_local"], device=dev)
        _hold_slab_grids(measured, "13 autoseg 2M", prep2, d2["tgt_local"],
                         tgt2, np.random.default_rng(9), spec, full=False,
                         library=False)
        stride2 = -(-len(d2["src"]) // AUTOSEG_COARSE)
        _hold_k3(measured, torch.as_tensor(np.ascontiguousarray(
            d2["src_local"][::stride2]), device=dev), torch.as_tensor(
                np.ascontiguousarray(d2["tgt_local"][::stride2]),
                device=dev), spec, f"{tpu}:1103", full=False, library=False)
        del prep2, tgt2
    check(not _unheld(both, measured),
          f"13 autoseg: unheld {_unheld(both, measured)}")
    del d2

    # (e) mask_far on the card against the CPU: far rows appended to the
    # 1M target.
    org = grid.origin
    cell = grid.cell_size
    pad = torch.cat([tgt_dev, torch.full((MASK_FAR_PADS, 3), 1.0e6,
                                         device=dev)])
    plain_n = estimate_normals_cellpca_device(tgt_dev, org, cell,
                                              resolution=R)
    ms, card = cuda_ms(lambda: estimate_normals_cellpca_device(
        pad, org, cell, resolution=R, mask_far=True), reps=3)
    cpu = estimate_normals_cellpca_device(pad.cpu(), org.cpu(), cell.cpu(),
                                          resolution=R, mask_far=True)
    cos = (card.cpu().double() * cpu.double()).sum(dim=1).abs()[:m]
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    print(f"[13 mask_far] {m} + {MASK_FAR_PADS} far rows, R={R}: real rows "
          f"equal to the build without them {torch.equal(card[:m], plain_n)}"
          f", far rows +z {bool((card[m:] == up).all())}; card against cpu:"
          f" rows equal {int((card.cpu() == cpu).all(dim=1).sum())}, share "
          f"|cos| >= 0.9999 {float((cos >= 0.9999).double().mean()):.6f}, "
          f"min {float(cos.min()):.6f}; {ms:.4f} ms (CUDA-event median of "
          "3)", flush=True)
    check(torch.equal(card[:m], plain_n) and bool((card[m:] == up).all())
          and bool((cpu[m:] == up.cpu()).all())
          and float((cos >= 0.9999).double().mean()) >= 0.999,
          "13: mask_far on the card")
    print(f"[13] phase 13 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def phase_library_times(data10):
    """``--library-times``: the library yardstick (chunked ``torch.cdist``
    + argmin, one call each) at ``LIBRARY_SHAPES``, on the first rows of
    the 10M pair (the time depends on the shape only)."""
    dev = torch.device(DEVICE)
    for n_q, n_t in LIBRARY_SHAPES:
        q = torch.as_tensor(data10["src_local"][:n_q], device=dev)
        t = torch.as_tensor(data10["tgt_local"][:n_t], device=dev)
        # 16,384 queries a call: 32,768 × a 65,536-row chunk is 2³¹
        # distances, which cdist refuses as a launch configuration.
        ms, _ = cuda_ms(lambda: cdist_argmin(q, t, q_chunk=16_384), reps=1,
                        warmup=False)
        print(f"[library] K3 shape {n_q} x {n_t}: chunked torch.cdist + "
              f"argmin {ms:.2f} ms (one call)", flush=True)
        del q, t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "drives the port on an NVIDIA card", file=sys.stderr)
        return 1
    from iterativeclosestpoint_tpu_torch.utils.device import resolve_device

    if sys.argv[1:2] == ["--worker"]:
        return worker(sys.argv[2:])
    t_start = time.perf_counter()
    resolve_device(None)
    name, smi, spec = phase_device()
    phase_build()
    if sys.argv[1:] == ["--library-times"]:
        phase_library_times(make_data(PLANE_10M))
        print(f"[t] total {time.perf_counter() - t_start:.3f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--across-cards"]:
        phase_across_cards(make_data(HEADLINE), make_data(PLANE_10M))
        print(f"[t] total {time.perf_counter() - t_start:.3f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    def stamp(phase):
        print(f"[t] phase {phase} done at {time.perf_counter() - t_start:.1f}"
              " s", flush=True)

    data = make_data(HEADLINE)
    vdata = make_data(VOLUME)
    data10 = make_data(PLANE_10M)
    stamp("data")
    measured = phase_kernels(data, vdata, data10, spec)
    stamp(3)
    paths = {}
    rmse = {}
    for path, tag, d, zcol, kw in (
            ("headline", "4 main path", data, False, HEADLINE_KW),
            ("volume", "4b volume", vdata, True, HEADLINE_KW),
            ("plane", "4c plane", data, False, PLANE_KW)):
        paths[path], res = phase_main_path(tag, d, measured, zcol, kw)
        rmse[path] = res.final.rmse
        stamp(tag.split()[0])
    paths["plane_10m"] = phase_plane_10m(data10, measured)
    stamp("4d")
    phase_repair()
    stamp(5)
    phase_card_vs_cpu(data)
    phase_nonfinite(measured, spec)
    stamp(6)
    paths["product"] = phase_product(measured, spec)
    stamp(7)
    paths["graph"], paths["backends"], small_cpu = phase_graph(measured,
                                                              spec)
    stamp(8)
    paths.update(phase_mesh(data, data10, measured, spec, small_cpu))
    stamp(9)
    paths.update(phase_multiprocess(data, data10, measured, spec))
    del data10
    stamp(10)
    paths["bench"] = phase_bench(measured, spec, rmse["headline"])
    stamp("11a")
    phase_oracle()
    phase_f64_pallas(measured, spec)
    stamp("11b")
    phase_options(measured, spec)
    stamp(12)
    paths.update(phase_first_tie(data, measured, spec))
    stamp(13)

    table = [
        ("colsweep_fused", "colsweep_fused.cu", 1165),
        ("colsweep", "colsweep.cu", 1025),
        ("colsweep_fused_ft", "colsweep_fused.cu", 1272),
        # The first_tie=True branch: on a real grid (K2's first-tie form),
        # on the one-cell grid (K3).
        ("colsweep_ft", "colsweep.cu", 1103),
        ("brute_nn", "brute_nn.cu", 1103),
        # No TPU kernel: the XLA ops around the sweep's pallas_call.
        ("slab_window", "sweep_window.cu", 1429),
        ("zcol_window", "sweep_window.cu", 1692),
    ]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "floor_ms",
            "max_abs_err", "library_ms")
    entries = []

    def owner(held, shape):
        """The entry a launch belongs to: K1's entries of one key differ
        in their layout's tile count."""
        return next((e for e in held if e.get("tiles") == shape[0]),
                    held[0])

    for name_k, src_file, line in table:
        # Each shape held in phase 3, with its launches in each main path;
        # the entry's own numbers are those of its most launched shape.
        shapes = []
        for key, held in measured[name_k].items():
            for k in held:
                per_path = {
                    p: sum(c for (nm, sh), c in by_shape.items()
                           if nm == name_k and _shape_key(nm, sh) == key
                           and owner(held, sh) is k)
                    for p, by_shape in paths.items()}
                shapes.append(dict(
                    shape=k["shape"], replaces=k["replaces"],
                    launches=sum(per_path.values()),
                    launches_by_path=per_path, **{f: k[f] for f in keys},
                    **{f: k[f] for f in ("splits", "wrapper_ms", "pairs")
                       if f in k}))
        # K3's phase-9 10M slab shapes carry no library time (_hold_k3):
        # the line's numbers come from the most launched shape with one.
        # So do K2's first-tie form's: its one-cell shape has one.
        # Among equally launched shapes, the one with the most pairs.
        top = max(shapes, key=lambda e: (
            e["library_ms"] is not None
            or name_k not in ("brute_nn", "colsweep_ft"), e["launches"],
            e["pairs"]))
        entries.append({
            "name": name_k, "route": "cuda",
            "source": f"iterativeclosestpoint_tpu_torch/csrc/{src_file}",
            "replaces": f"iterativeclosestpoint_tpu/ops/pallas_nn.py:{line}",
            "launches": sum(e["launches"] for e in shapes),
            **{f: top[f] for f in keys}, "shape": top["shape"],
            "shapes": shapes, "passed": True,
        })
    print(f"[t] total {time.perf_counter() - t_start:.3f} s")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
