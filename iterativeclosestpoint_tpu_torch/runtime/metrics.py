"""Structured per-iteration metrics + console progress lines.

Equivalent of the reference's observability stack (SURVEY.md §5): the
``logMessage``/``iterationCompleted``/``progressUpdated`` signal chain
(icpengine.h:72-75 → registrationservice.cpp:24 → timestamped console,
registrationpage.cpp:229-233) plus the per-iteration results table. Metric
definitions (RMSE over inliers, valid/outlier counts, cumulative rotation
angle from the trace formula, translation norm) are kept identical to the
reference records (icpengine.cpp:349-362). Output: JSONL records + the
same human console lines.

The port's own copy of the JAX package's ``runtime/metrics.py``: the
same records, report text and history JSON.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional, TextIO


class MetricsWriter:
    """JSONL metric stream + optional timestamped console echo."""

    def __init__(
        self,
        jsonl_path: Optional[str | Path] = None,
        console: bool = True,
        stream: TextIO = sys.stderr,
    ):
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._console = console
        self._stream = stream

    def log(self, message: str) -> None:
        """Timestamped console line (registrationpage.cpp:229-233 style)."""
        if self._console:
            ts = time.strftime("%H:%M:%S")
            print(f"[{ts}] {message}", file=self._stream, flush=True)

    def event(self, kind: str, **fields) -> None:
        rec = {"ts": time.time(), "kind": kind, **fields}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()

    def iteration(self, it: dict, total: int) -> None:
        """Per-iteration record (iterationCompleted payload analog)."""
        self.event("iteration", **{k: v for k, v in it.items() if k != "transform"})
        self.log(
            f"  iteration {it['iteration']}/{total}: "
            f"RMSE = {it['rmse']:.6f} "
            f"(valid: {it['valid_points']}, outliers: {it['outlier_points']}, "
            f"rot: {it['rotation_angle_deg']:.4f} deg, "
            f"trans: {it['translation_norm']:.4f} m)"
        )

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


def write_transform_report(
    path: str | Path, result, include_history: bool = True
) -> None:
    """Human-readable transform report — content parity with the CLI's
    ``icp_transformation.txt`` (icp_registration.cpp:625-695): the formula,
    per-iteration R/t, final R, t and homogeneous 4x4."""
    T = result.transform
    lines = [
        "ICP registration transform parameters",
        "=====================================",
        "",
        "Transform mapping the source cloud into the target frame:",
        "  P_target = R * P_source + t",
        "",
    ]
    if include_history and result.iterations:
        lines += ["=====================================",
                  "Per-iteration transforms",
                  "=====================================", ""]
        for i in range(result.iterations):
            Ti = result.history_transform[i]
            lines.append(f"--- iteration {i + 1} ---")
            lines.append("rotation R:")
            for r in range(3):
                lines.append(
                    "  [" + ", ".join(f"{Ti[r, c]:.10g}" for c in range(3)) + "]"
                )
            lines.append("translation t:")
            lines.append(
                "  [" + ", ".join(f"{Ti[r, 3]:.10g}" for r in range(3)) + "]"
            )
            lines.append("")
    lines += ["=====================================",
              "Final transform",
              "=====================================", "",
              "rotation R (3x3):"]
    for r in range(3):
        lines.append("  [" + ", ".join(f"{T[r, c]:.10g}" for c in range(3)) + "]")
    lines += ["", "translation t (3x1):",
              "  [" + ", ".join(f"{T[r, 3]:.10g}" for r in range(3)) + "]",
              "", "homogeneous 4x4:"]
    for r in range(4):
        lines.append("  [" + ", ".join(f"{T[r, c]:.10g}" for c in range(4)) + "]")
    Path(path).write_text("\n".join(lines) + "\n")


def write_history_json(path: str | Path, result) -> None:
    """Machine-readable run record: full per-iteration history (drives the
    viewer-style replay, pointcloudviewer.cpp:86-116)."""
    payload = {
        "success": bool(result.success),
        "message": result.message,
        "iterations": int(result.iterations),
        "stop_reason": int(result.stop_reason),
        "rmse": float(result.rmse),
        "transform": result.transform.tolist(),
        "history": [
            {**{k: v for k, v in rec.items() if k != "transform"},
             "transform": rec["transform"].tolist()}
            for rec in result.iteration_records()
        ],
    }
    Path(path).write_text(json.dumps(payload, indent=1))


def read_history_json(path: str | Path) -> dict:
    import numpy as np

    d = json.loads(Path(path).read_text())
    d["transform"] = np.asarray(d["transform"])
    for rec in d["history"]:
        rec["transform"] = np.asarray(rec["transform"])
    return d
