"""Port parity: the mesh over several processes
(``parallel.mesh.init_multihost``), mechanically tested on the CPU with
two ``torch.distributed`` gloo processes of 2 ranks each, section by
section as ``tests/test_multihost.py`` tests the JAX package.

Tolerances and why:

* 2 processes × 2 ranks against 1 process × 4 ranks: bit for bit (every
  ``psum`` folds in global rank order whatever the process layout, and
  every process builds the same NN state from the same inputs), for the
  data-parallel paths, both ingests, the pose graph and the resume after
  a lost process; and both processes hold the same bits;
* against the JAX package's ``icp_register_sharded`` on 4 virtual
  devices (f64, brute force, n=1001, seed 50): history rtol 1e-12,
  transform atol 1e-12, registered cloud atol 1e-10, point and plane (the
  JAX multi-host test's own bounds; the sums differ in order only);
* the ingests against one device: 1e-12 with the brute local search (the
  JAX worker's bound), and the per-slab sweep chain (f32, sampled grid
  parameters) within 1e-5 of the f64 brute-force run, as in the JAX
  worker (``_multihost_worker.py:186-204``);
* the pose graph against the single-device solve: 1e-9 (f64);
* a SIGKILLed peer: the survivor exits non-zero within 30 s of the kill
  with the port's diagnostic naming the lost process, never completing.

About 35 s alone on one worker (the JAX side's compiles and six
subprocess starts take most of it).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_multihost_worker import N, SEED, run_all
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.parallel.mesh import make_mesh as jax_mesh
from iterativeclosestpoint_tpu.parallel.sharded import (
    icp_register_sharded as jax_sharded,
)
from iterativeclosestpoint_tpu.utils.synth import (
    make_registration_pair as jax_pair,
)
from iterativeclosestpoint_tpu_torch import icp_register
from iterativeclosestpoint_tpu_torch.io.las import read_las, write_las
from iterativeclosestpoint_tpu_torch.models.posegraph import (
    optimize_pose_graph,
)
from iterativeclosestpoint_tpu_torch.parallel import make_mesh
from iterativeclosestpoint_tpu_torch.utils.synth import (
    make_registration_pair,
)

HERE = Path(__file__).parent
TRAJECTORY = ("iterations", "message", "rmse", "valid", "transform",
              "history_transform", "registered", "poses")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(script, args_of, nproc, logs: Path, timeout=240):
    """Start ``nproc`` workers together, each writing to a file in
    ``logs`` (a pipe read after another worker's could fill and stall
    its writer); (return codes, outputs)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    paths = [logs / f"{Path(script).stem}.{len(list(logs.iterdir()))}.{pid}"
             for pid in range(nproc)]
    files = [open(p, "wb") for p in paths]
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / script), *map(str, args_of(pid))],
        stdout=f, stderr=subprocess.STDOUT, env=env)
        for pid, f in enumerate(files)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p, f in zip(procs, files):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    return ([p.returncode for p in procs],
            [p.read_bytes().decode(errors="replace") for p in paths])


def _tagged(out: str) -> dict:
    """``TAG {json}`` lines of a worker's output."""
    got = {}
    for line in out.splitlines():
        tag, _, rest = line.partition(" ")
        if rest.startswith("{"):
            got[tag] = json.loads(rest)
    return got


def _f64(hexed: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(hexed), np.float64)


def _trajectory(d: dict) -> dict:
    return {k: v for k, v in d.items() if k in TRAJECTORY}


def _held(d: dict, res, rtol, atol, registered=None):
    """A worker's payload against an ICPResult within the bounds."""
    assert d["iterations"] == res.iterations
    assert d["message"] == res.message
    assert d["valid"] == np.asarray(res.history_valid).astype(int).tolist()
    np.testing.assert_allclose(_f64(d["rmse"]), res.history_rmse, rtol=rtol)
    np.testing.assert_allclose(_f64(d["transform"]).reshape(4, 4),
                               res.transform, atol=atol)
    if registered is not None:
        np.testing.assert_allclose(
            _f64(d["registered"]).reshape(-1, 3), res.source_registered,
            atol=registered)


def test_two_process_gloo_cpu(tmp_path):
    src, tgt, _ = make_registration_pair(n=N, seed=SEED, noise_sigma=0.02)
    j_src, j_tgt, _ = jax_pair(n=N, seed=SEED, noise_sigma=0.02)
    np.testing.assert_array_equal(src, j_src)
    np.testing.assert_array_equal(tgt, j_tgt)
    write_las(tmp_path / "src.las", src)
    write_las(tmp_path / "tgt.las", tgt)

    port = _free_port()
    rcs, outs = _launch("_torch_multihost_worker.py",
                        lambda pid: (pid, 2, port, tmp_path), 2, tmp_path)
    for pid, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"process {pid} failed:\n{out}"
        assert f"MULTIHOST_OK {pid}" in out, out
        assert "REGISTER_SCANS_REFUSED" in out, out
        # A mismatch or a failed rank fails every process, which names
        # the ranks; then the group still runs a collective.
        assert "MISMATCH_FAILED" in out and (
            "collective mismatch across processes: rank 0 psum #0 (2,) "
            "torch.float32, rank 2 psum #0 (3,)") in out, out
        assert {0: "RAISED_FAILED mesh rank 3 (process 1) failed",
                1: "RAISED_FAILED mesh rank 3 failed: ValueError('rank 3 "
                   "fails')"}[pid] in out, out
        assert "GROUP_USABLE 4.0" in out, out
    procs = [_tagged(o) for o in outs]
    assert set(procs[0]) == {"DP_POINT", "DP_PLANE", "INGEST", "PARTITION",
                             "PARTITION_PALLAS", "GRAPH"}
    for tag in procs[0]:
        assert _trajectory(procs[0][tag]) == _trajectory(procs[1][tag]), tag

    # One process of four ranks: the same bits.
    local = {}
    run_all(make_mesh(devices=["cpu"] * 4), str(tmp_path),
            lambda tag, text: local.__setitem__(tag, json.loads(text)))
    got = procs[0]
    for tag in got:
        assert _trajectory(got[tag]) == _trajectory(local[tag]), tag
    for tag in ("DP_POINT", "DP_PLANE"):
        # Each rank's collective bytes per iteration, whatever the layout
        # (f64: the f32 payload's floats at 8 B).
        want = local[tag]["bytes_per_iteration"]
        assert len(set(want)) == 1 and want[0] < 1024, want
        assert got[tag]["bytes_per_iteration"] == want[:2], got[tag]

    # The JAX package on 4 virtual devices.
    jres = jax_sharded(src, tgt, mesh=jax_mesh(4), dtype=jnp.float64,
                       max_iterations=12, nn_backend="bruteforce")
    _held(got["DP_POINT"], jres, 1e-12, 1e-12, registered=1e-10)
    jres = jax_sharded(src, tgt, mesh=jax_mesh(4), dtype=jnp.float64,
                       max_iterations=8, estimator="plane",
                       return_registered=False)
    _held(got["DP_PLANE"], jres, 1e-12, 1e-12)

    # The sharded ingest: no decode, nor this process's total, reached
    # the whole cloud; the trajectory is the decoded cloud's.
    ing = got["INGEST"]
    assert ing["peak_rows"] <= ing["shard_rows"], ing
    assert ing["total_rows"] <= 2 * ing["shard_rows"], ing
    assert ing["total_rows"] < ing["n_rows"] == N, ing
    src_dec, _ = read_las(tmp_path / "src.las")
    tgt_dec, _ = read_las(tmp_path / "tgt.las")
    one = icp_register(src_dec, tgt, dtype=torch.float64,
                       nn_backend="bruteforce", max_iterations=12,
                       device="cpu")
    _held(ing, one, 1e-12, 1e-12, registered=1e-10)

    # The partitioned ingest: each process kept part of each file.
    for pid in (0, 1):
        part = procs[pid]["PARTITION"]
        for side in ("target", "source"):
            st = part[side]
            assert st["retained_rows"] < st["total_rows"] == N, (pid, st)
        assert part["target"]["peak_batch_rows"] <= 500
    one = icp_register(src_dec, tgt_dec, dtype=torch.float64,
                       nn_backend="bruteforce", max_iterations=12,
                       return_registered=False, device="cpu")
    _held(got["PARTITION"], one, 1e-12, 1e-12)
    assert got["PARTITION_PALLAS"]["grid_params"]["local_search"] == "pallas"
    _held(got["PARTITION_PALLAS"], one, 1e-5, 1e-5)

    # The edge-sharded pose graph against one device.
    rng = np.random.default_rng(SEED)
    edges = []
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4), (1, 3)]:
        Z = np.eye(4)
        Z[:3, 3] = rng.normal(0.0, 1.0, 3)
        edges.append((i, j, Z))
    g1 = optimize_pose_graph(edges, n_poses=5, max_iterations=10,
                             device="cpu")
    assert got["GRAPH"]["iterations"] == g1.iterations
    np.testing.assert_allclose(_f64(got["GRAPH"]["poses"]).reshape(5, 4, 4),
                               g1.poses, atol=1e-9)


def _payload(out, tag):
    line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")][0]
    d = json.loads(line.split(" ", 1)[1])
    return (np.array([float.fromhex(h) for h in d["rmse"]]),
            np.array([float.fromhex(h) for h in d["transform"]]))


def test_failure_injection_sigkill_detect_and_resume(tmp_path):
    """SIGKILL one of two processes mid-registration (between segments):
    the survivor's next collective fails at once with ``RankFailed``
    naming the lost process (gloo sees the peer's sockets close), it
    exits non-zero without completing, and the rolling checkpoint holds
    the full carry at iteration 6. Two fresh processes, and one process
    of 4 ranks, resume to the uninterrupted tail and transform bit for
    bit."""
    from _torch_failure_worker import KILL_AT_ITERATION, MAX_ITERATIONS

    ckpt = tmp_path / "rolling_ckpt.json"
    port = _free_port()
    rcs, outs = _launch("_torch_failure_worker.py",
                        lambda pid: ("run", ckpt, pid, 2, port), 2,
                        tmp_path)
    assert rcs[1] == -9, (rcs[1], outs[1])
    assert "SELF_SIGKILL" in outs[1], outs[1]
    assert rcs[0] != 0, outs[0]
    assert "UNEXPECTED_COMPLETION" not in outs[0], outs[0]
    detected = [ln for ln in outs[0].splitlines()
                if ln.startswith("DETECTED ")]
    assert detected, outs[0]
    assert "mesh process 1 (ranks [2, 3]) was lost" in detected[0], outs[0]
    t_kill = float(outs[1].split("SELF_SIGKILL ")[1].split()[0])
    t_seen = float(detected[0].split()[1])
    assert 0.0 <= t_seen - t_kill < 30.0, (t_kill, t_seen)
    ck = json.loads(ckpt.read_text())
    assert ck["iteration"] == KILL_AT_ITERATION, ck
    assert "transform_local" in ck and "prev_error" in ck, sorted(ck)
    u_rmse, u_T = _payload(outs[0], "UNINTERRUPTED")
    assert len(u_rmse) == MAX_ITERATIONS

    port = _free_port()
    rcs, routs = _launch("_torch_failure_worker.py",
                         lambda pid: ("resume2", ckpt, pid, 2, port), 2,
                         tmp_path)
    for pid, (rc, out) in enumerate(zip(rcs, routs)):
        assert rc == 0, f"resume2 process {pid} failed:\n{out}"
    r_rmse, r_T = _payload(routs[0], "RESUMED")
    np.testing.assert_array_equal(r_rmse, u_rmse[KILL_AT_ITERATION:])
    np.testing.assert_array_equal(r_T, u_T)

    rcs, souts = _launch("_torch_failure_worker.py",
                         lambda pid: ("resume", ckpt), 1, tmp_path)
    assert rcs[0] == 0, souts[0]
    s_rmse, s_T = _payload(souts[0], "RESUMED")
    np.testing.assert_array_equal(s_rmse, u_rmse[KILL_AT_ITERATION:])
    np.testing.assert_array_equal(s_T, u_T)


@pytest.mark.parametrize("env", [{}, {"RANK": "0", "WORLD_SIZE": "2"}])
def test_init_multihost_without_cluster_raises(monkeypatch, env):
    """A heartbeat and no process count read the cluster from the
    environment; without it (or with part of it) init_multihost raises,
    never falling back to one process."""
    from iterativeclosestpoint_tpu_torch.parallel import init_multihost

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="describes no cluster"):
        init_multihost(heartbeat_timeout_seconds=5, local_devices=["cpu"])
    mesh = init_multihost(local_devices=["cpu"] * 2)
    assert mesh.axis_names == ("dp",) and mesh.size == 2
    assert mesh.process_count == 1
