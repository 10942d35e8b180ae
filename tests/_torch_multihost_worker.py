"""Subprocess worker for tests/test_torch_multihost.py.

One of N processes of a ``torch.distributed`` gloo group on the CPU
(``parallel.mesh.init_multihost`` with ``local_devices=["cpu"] * 2``):
the 2-D (host × chip) mesh of the port, the counterpart of
``tests/_multihost_worker.py``. It runs the data-parallel paths (point
and plane), the sharded ingest, the partitioned ingest (brute and with
sampled grid parameters), the edge-sharded pose graph, and prints each
result as one ``TAG {json}`` line with every float array as the hex of
its bytes; the pytest parent holds them against a 1-process mesh, one
device and the JAX package (this process imports no JAX: the card's
machine has none).

    python tests/_torch_multihost_worker.py PID NPROC PORT LAS_DIR
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RANKS_PER_PROCESS = 2
N, SEED, HALO, BATCH = 1001, 50, 2.0, 500


def payload(res, **extra) -> str:
    """An ICPResult's trajectory, bit for bit, as JSON."""
    import numpy as np

    def hexed(a):
        return np.ascontiguousarray(a, np.float64).tobytes().hex()

    d = {
        "iterations": int(res.iterations),
        "message": res.message,
        "rmse": hexed(res.history_rmse),
        "valid": np.asarray(res.history_valid).astype(int).tolist(),
        "transform": hexed(res.transform),
        "history_transform": hexed(res.history_transform),
    }
    if res.source_registered is not None:
        d["registered"] = hexed(res.source_registered)
    d.update(extra)
    return json.dumps(d)


def run_all(mesh, las_dir, emit) -> None:
    """Every section, on ``mesh`` (the parent runs it in process on a
    1-process mesh of as many ranks, for the bit-for-bit comparison)."""
    import numpy as np
    import torch

    from iterativeclosestpoint_tpu_torch.io.las import read_header
    from iterativeclosestpoint_tpu_torch.parallel import (
        estimate_partition_grid_params,
        header_center,
        icp_register_partitioned,
        icp_register_sharded,
        load_las_partitioned_source,
        load_las_partitioned_target,
        load_las_sharded,
        optimize_pose_graph_sharded,
    )
    from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    f64 = torch.float64
    src, tgt, _ = make_registration_pair(n=N, seed=SEED, noise_sigma=0.02)

    mesh.reset_stats()
    res = icp_register_sharded(src, tgt, mesh=mesh, dtype=f64,
                               max_iterations=12, return_registered=True)
    per_it = [st["bytes_sent"] / max(res.iterations, 1)
              for st in (mesh.stats[r] for r in mesh.local_ranks)]
    emit("DP_POINT", payload(res, bytes_per_iteration=per_it))

    mesh.reset_stats()
    res = icp_register_sharded(src, tgt, mesh=mesh, dtype=f64,
                               max_iterations=8, estimator="plane",
                               return_registered=False)
    per_it = [st["bytes_sent"] / max(res.iterations, 1)
              for st in (mesh.stats[r] for r in mesh.local_ranks)]
    emit("DP_PLANE", payload(res, bytes_per_iteration=per_it))

    # The sharded ingest: each process decodes only its ranks' rows.
    src_path = os.path.join(las_dir, "src.las")
    tgt_path = os.path.join(las_dir, "tgt.las")
    stats = {}
    shards, weights, n_rows, _ = load_las_sharded(
        src_path, mesh, offset=center_offset(tgt), dtype=f64, stats=stats)
    shard_rows = next(s for s in shards if s is not None).shape[0]
    res = icp_register_sharded(
        None, tgt, mesh=mesh, dtype=f64, max_iterations=12,
        source_global=(shards, weights, n_rows), return_registered=True)
    emit("INGEST", payload(res, shard_rows=shard_rows, n_rows=n_rows,
                           **stats))

    # The partitioned ingest: walls from a file sample, each process
    # keeping only its ranks' slabs and shards.
    offset = header_center(read_header(tgt_path))
    tstats, sstats = {}, {}
    part, walls = load_las_partitioned_target(
        tgt_path, mesh, halo=HALO, offset=offset, dtype=f64,
        batch_size=BATCH, stats=tstats)
    src_g = load_las_partitioned_source(
        src_path, mesh, walls=walls, offset=offset, dtype=f64,
        batch_size=BATCH, stats=sstats)
    res = icp_register_partitioned(
        None, None, mesh=mesh, partition_state=part, source_global=src_g,
        offset=offset, dtype=f64, max_iterations=12,
        return_registered=False)
    emit("PARTITION", payload(res, target=tstats, source=sstats,
                              walls=[float(w) for w in walls]))

    # Sampled grid parameters turn on the per-slab sweep chain (f32).
    gp = estimate_partition_grid_params(tgt_path, walls, halo=HALO,
                                        grid_resolution=8)
    part32, _ = load_las_partitioned_target(
        tgt_path, mesh, halo=HALO, offset=offset, walls=walls,
        batch_size=BATCH)
    src32 = load_las_partitioned_source(src_path, mesh, walls=walls,
                                        offset=offset, batch_size=BATCH)
    res = icp_register_partitioned(
        None, None, mesh=mesh, partition_state=part32, source_global=src32,
        offset=offset, max_iterations=12, return_registered=False,
        grid_params=gp)
    emit("PARTITION_PALLAS", payload(res, grid_params=gp))

    # The edge-sharded pose graph: a 5-pose chain with a loop closure.
    rng = np.random.default_rng(SEED)
    edges = []
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4), (1, 3)]:
        Z = np.eye(4)
        Z[:3, 3] = rng.normal(0.0, 1.0, 3)
        edges.append((i, j, Z))
    g = optimize_pose_graph_sharded(edges, n_poses=5, mesh=mesh,
                                    max_iterations=10)
    emit("GRAPH", json.dumps({
        "poses": np.ascontiguousarray(g.poses, np.float64).tobytes().hex(),
        "iterations": int(g.iterations)}))


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # before any operation (tests/_torch_threads.py)
    pid, nproc, port, las_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])

    from iterativeclosestpoint_tpu_torch.parallel import init_multihost

    mesh = init_multihost(f"127.0.0.1:{port}", nproc, pid,
                          local_devices=["cpu"] * RANKS_PER_PROCESS)
    assert mesh.axis_names == ("host", "chip"), mesh.axis_names
    assert mesh.shape == (nproc, RANKS_PER_PROCESS), mesh.shape
    assert list(mesh.local_ranks) == [pid * 2, pid * 2 + 1], mesh

    def emit(tag, text):
        print(f"{tag} {text}", flush=True)

    run_all(mesh, las_dir, emit)

    from iterativeclosestpoint_tpu_torch.models.posegraph import (
        register_scans,
    )

    try:
        register_scans([np.zeros((8, 3))] * 2, mesh=mesh, device="cpu")
    except ValueError as e:
        print(f"REGISTER_SCANS_REFUSED {e}", flush=True)

    from iterativeclosestpoint_tpu_torch.parallel import RankFailed

    # A collective whose shape differs across processes, then a rank of
    # process 1 that raises before its collective: every process fails
    # the run with the same diagnosis, and the group stays usable.
    def mismatch(comm):
        return comm.psum(torch.zeros(2 if comm.rank < 2 else 3))

    def raises(comm):
        if comm.rank == 3:
            raise ValueError("rank 3 fails")
        return comm.psum(torch.ones(1))

    for tag, fn in (("MISMATCH", mismatch), ("RAISED", raises)):
        try:
            mesh.run(fn)
        except RankFailed as e:
            print(f"{tag}_FAILED {e}", flush=True)
    total = mesh.run(lambda comm: comm.psum(torch.ones(1)))
    print(f"GROUP_USABLE {float(total[mesh.local_ranks[0]])}", flush=True)
    print(f"MULTIHOST_OK {pid}", flush=True)
    # Every process leaves together: process 0 holds the group's store,
    # and exiting under a peer still using it can abort the peer.
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
