"""Failure-injection worker for tests/test_torch_multihost.py, the
counterpart of ``tests/_failure_worker.py`` on the port's process mesh
(gloo on the CPU, 2 ranks per process, 4 in all).

mode "run" (2 processes):
  1. Both processes run an uninterrupted segmented registration (12
     iterations in segments of 3); process 0 prints its trajectory.
  2. The same registration again with a rolling checkpoint written by
     process 0 at each segment boundary; process 1 SIGKILLs itself at
     the boundary of iteration 6, with no cleanup. Process 0's next
     collective fails: the run raises ``RankFailed`` naming the lost
     process, and the worker prints it with the time and exits 1.
     Reaching the end of the run prints ``UNEXPECTED_COMPLETION``.

mode "resume2" (two fresh processes, the same layout) and mode "resume"
(one process of 4 ranks): load the checkpoint and continue; process 0
prints the resumed trajectory, which must equal the uninterrupted tail
bit for bit in both (the fold order of every ``psum`` is global rank
order, whatever the process layout).

    python tests/_torch_failure_worker.py run|resume2 CKPT PID NPROC PORT
    python tests/_torch_failure_worker.py resume CKPT
"""

import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RANKS = 4
KILL_AT_ITERATION = 6
MAX_ITERATIONS = 12
SEGMENT_ITERATIONS = 3
HEARTBEAT_SECONDS = 10


def _traj_payload(res) -> str:
    import numpy as np

    return json.dumps({
        "rmse": [float(r).hex() for r in np.asarray(res.history_rmse)],
        "transform": [float(v).hex()
                      for v in np.asarray(res.transform).ravel()],
        "iterations": int(res.iterations),
        "message": res.message,
    })


def _leave_group() -> None:
    """Every process leaves together: process 0 holds the group's store,
    and exiting under a peer still using it can abort the peer."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def main() -> int:
    import torch

    torch.set_num_threads(1)  # before any operation (tests/_torch_threads.py)
    mode, ckpt_path = sys.argv[1], sys.argv[2]

    from iterativeclosestpoint_tpu_torch.parallel import (
        RankFailed,
        icp_register_sharded,
        init_multihost,
        make_mesh,
    )
    from iterativeclosestpoint_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
        resume_arguments,
        save_checkpoint,
    )
    from iterativeclosestpoint_tpu_torch.utils.synth import (
        make_registration_pair,
    )

    if mode == "resume":
        pid = 0
        mesh = make_mesh(devices=["cpu"] * RANKS)
    else:
        pid, nproc, port = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
        mesh = init_multihost(
            f"127.0.0.1:{port}", nproc, pid,
            heartbeat_timeout_seconds=HEARTBEAT_SECONDS,
            local_devices=["cpu"] * (RANKS // nproc))
    assert mesh.size == RANKS, mesh

    src, tgt, _ = make_registration_pair(n=1001, seed=50, noise_sigma=0.02)
    kwargs = dict(dtype=torch.float64, nn_backend="bruteforce",
                  max_iterations=MAX_ITERATIONS,
                  segment_iterations=SEGMENT_ITERATIONS,
                  return_registered=False)

    if mode in ("resume", "resume2"):
        ckpt = load_checkpoint(ckpt_path)
        assert ckpt["iteration"] == KILL_AT_ITERATION, ckpt["iteration"]
        patch = resume_arguments(ckpt, MAX_ITERATIONS)
        assert "resume_carry" in patch, patch  # the full carry
        res = icp_register_sharded(src, tgt, mesh=mesh,
                                   **{**kwargs, **patch})
        if pid == 0:
            print("RESUMED " + _traj_payload(res), flush=True)
        _leave_group()
        return 0

    # 1. The uninterrupted reference on the same mesh.
    res_u = icp_register_sharded(src, tgt, mesh=mesh, **kwargs)
    if pid == 0:
        print("UNINTERRUPTED " + _traj_payload(res_u), flush=True)

    # 2. The failure run.
    def segment_cb(state):
        if pid == 0:
            save_checkpoint(
                ckpt_path, iteration=state["iteration"],
                transform=state["transform"], rmse_history=[],
                prev_error=state["prev_error"],
                no_improve=state["no_improve"],
                transform_local=state["transform_local"],
                center_offset=state["offset"])
            print(f"CHECKPOINT {state['iteration']}", flush=True)
        elif state["iteration"] >= KILL_AT_ITERATION:
            print(f"SELF_SIGKILL {time.time()!r}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    try:
        icp_register_sharded(src, tgt, mesh=mesh,
                             segment_callback=segment_cb, **kwargs)
    except RankFailed as e:
        print(f"DETECTED {time.time()!r} {e}", flush=True)
        return 1
    print("UNEXPECTED_COMPLETION", flush=True)
    return 3


if __name__ == "__main__":
    sys.exit(main())
