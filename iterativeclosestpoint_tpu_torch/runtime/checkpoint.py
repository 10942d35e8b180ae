"""Checkpoint / resume for registration runs.

The reference has no compute checkpointing (SURVEY.md §5: settings-only
persistence, an empty restoreLastSession stub at mainwindow.cpp:145-152);
its per-iteration transform history is a de-facto resumable record. Here
that becomes explicit: the resumable state is the small pytree the ICP
loop actually carries — ``(T_cumulative, prev_error, no_improve)``, the
same ``prev_error``/``no_improvement_count`` locals the reference keeps at
icpengine.cpp:156-157 — plus the iteration count and rmse trail.

Because the loop recomputes the current source from the pristine source
and the carried cumulative transform every iteration (composed apply,
models/icp.py), feeding this carry back via ``resume_carry`` makes the
resumed trajectory **bit-identical** to the uninterrupted run
(tests/test_segmented.py::test_checkpoint_resume_bit_identical).

Version-1 checkpoints (transform only) remain loadable; they resume via
``initial_transform`` with a reset convergence state machine —
trajectory-equivalent but not bit-pinned.

The port's own copy of the JAX package's ``runtime/checkpoint.py``: the
same JSON (version 2, with the carry), so a checkpoint written by either
package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np


def save_checkpoint(
    path: str | Path,
    *,
    iteration: int,
    transform: np.ndarray,
    rmse_history,
    prev_error: Optional[float] = None,
    no_improve: Optional[int] = None,
    transform_local: Optional[np.ndarray] = None,
    center_offset: Optional[np.ndarray] = None,
    config: Optional[dict] = None,
    source_path: str = "",
    target_path: str = "",
) -> None:
    payload = {
        "version": 2,
        "iteration": int(iteration),
        "transform": np.asarray(transform, np.float64).tolist(),
        "rmse_history": [float(r) for r in rmse_history],
        "config": config or {},
        "source_path": source_path,
        "target_path": target_path,
    }
    if prev_error is not None and no_improve is not None:
        payload["prev_error"] = float(prev_error)
        payload["no_improve"] = int(no_improve)
    if transform_local is not None and center_offset is not None:
        # Exact loop state in the centered local frame (JSON floats
        # round-trip f64 exactly): the bit-identical resume path.
        payload["transform_local"] = np.asarray(
            transform_local, np.float64
        ).tolist()
        payload["center_offset"] = np.asarray(
            center_offset, np.float64
        ).tolist()
    p = Path(path)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(payload, indent=1))
    tmp.replace(p)  # atomic on POSIX


def load_checkpoint(path: str | Path) -> dict:
    d = json.loads(Path(path).read_text())
    d["transform"] = np.asarray(d["transform"], np.float64)
    for key in ("transform_local", "center_offset"):
        if key in d:
            d[key] = np.asarray(d[key], np.float64)
    return d


def resume_arguments(ckpt: dict, max_iterations: int) -> dict:
    """kwargs patch for icp_register to continue a checkpointed run.

    With a full convergence carry in the checkpoint (version 2 written at
    a segment boundary) the patch uses ``resume_carry`` — the continued
    run is bit-identical to the uninterrupted one. Older / carry-less
    checkpoints fall back to ``initial_transform`` (exact pose, reset
    convergence counters)."""
    remaining = max(1, max_iterations - ckpt["iteration"])
    if "prev_error" in ckpt and "no_improve" in ckpt:
        return {
            "resume_carry": {
                "transform": ckpt["transform"],
                "prev_error": ckpt["prev_error"],
                "no_improve": ckpt["no_improve"],
                "transform_local": ckpt.get("transform_local"),
                "offset": ckpt.get("center_offset"),
            },
            "max_iterations": remaining,
        }
    return {
        "initial_transform": ckpt["transform"],
        "max_iterations": remaining,
    }
