"""Headless visualization export (C8 PointCloudViewer equivalent).

The reference renders interactively with immediate-mode OpenGL
(widgets/pointcloudviewer.cpp) — orbit camera, source/target coloring,
iteration replay. The framework equivalent is headless: render the two
clouds (and any replay state) to PNG with three orthographic projections
plus the per-iteration RMSE curve; the *replay* itself is the pure
function session.replay(k) (pointcloudviewer.cpp:86-116 semantics).

The port's own copy of the JAX package's ``runtime/viz.py``. matplotlib
is imported only when a PNG is rendered; where it is missing, use the
HTML viewer (runtime/htmlviz.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def render_registration_png(
    path: str | Path,
    source: np.ndarray,
    target: np.ndarray,
    rmse_history: Optional[np.ndarray] = None,
    title: str = "",
    max_points: int = 100_000,
    point_size: float = 0.5,
) -> None:
    """Three orthographic views (XY / XZ / YZ) + RMSE curve → PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def sub(c):
        if len(c) > max_points:
            idx = np.random.default_rng(0).choice(len(c), max_points, False)
            return c[idx]
        return c

    s = sub(np.asarray(source))
    t = sub(np.asarray(target))

    fig, axes = plt.subplots(2, 2, figsize=(11, 9))
    views = [((0, 1), "X", "Y"), ((0, 2), "X", "Z"), ((1, 2), "Y", "Z")]
    for ax, ((a, b), la, lb) in zip(axes.flat, views):
        ax.scatter(t[:, a], t[:, b], s=point_size, c="#2266cc", alpha=0.5,
                   linewidths=0, label="target")
        ax.scatter(s[:, a], s[:, b], s=point_size, c="#cc3322", alpha=0.5,
                   linewidths=0, label="source")
        ax.set_xlabel(la)
        ax.set_ylabel(lb)
        ax.set_aspect("equal")
        ax.legend(markerscale=8, fontsize=8)

    ax = axes.flat[3]
    if rmse_history is not None and len(rmse_history):
        ax.plot(np.arange(1, len(rmse_history) + 1), rmse_history, "o-")
        ax.set_xlabel("iteration")
        ax.set_ylabel("RMSE")
        ax.set_yscale("log")
        ax.grid(True, alpha=0.3)
    else:
        ax.axis("off")

    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
