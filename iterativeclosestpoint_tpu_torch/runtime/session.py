"""RegistrationSession: the orchestration layer (C6 RegistrationService).

Counterpart of the JAX package's ``runtime/session.py``. Mirrors the
reference service's responsibilities
(``services/registrationservice.h:30-106``): owns source/target clouds,
keeps a pristine copy of the source for iteration replay
(registrationservice.cpp:92-99), runs registration, accumulates a history
of runs (registrationservice.cpp:243-254) and saves artifacts. Where the
reference offloads to Qt worker threads, ``run_async`` runs the
registration on a Python thread (the card's kernels and torch's
operators release the GIL) and returns the thread.

Every run goes to ``device`` (None: the card, raising without CUDA;
"cpu": the kernels' plain versions). The host I/O is timed as the stages
``load_source``, ``load_target``, ``write_las``, ``report`` and ``html``
(runtime/timing.py: no-ops unless a collector is active). The multi-device
modes (``parallel="dp"`` / ``"partition"``) run over a mesh of one rank per
visible card (``parallel/``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from iterativeclosestpoint_tpu_torch.io.las import read_las, write_las
from iterativeclosestpoint_tpu_torch.models.icp import (
    ICPResult,
    icp_register,
)
from iterativeclosestpoint_tpu_torch.models.multiscale import (
    icp_register_multiscale,
)
from iterativeclosestpoint_tpu_torch.runtime.checkpoint import save_checkpoint
from iterativeclosestpoint_tpu_torch.runtime.metrics import (
    MetricsWriter,
    write_history_json,
    write_transform_report,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import stage
from iterativeclosestpoint_tpu_torch.utils.config import (
    AppSettings,
    ICPConfig,
)


@dataclasses.dataclass
class RunRecord:
    """One row of the run-history table (dashboardpage.cpp:150-173)."""

    timestamp: float
    source_points: int
    target_points: int
    iterations: int
    rmse: float
    success: bool
    message: str
    duration_s: float


class RegistrationSession:
    """Owns clouds + config, runs registrations, keeps history and replay
    state."""

    def __init__(self, settings: Optional[AppSettings] = None,
                 metrics: Optional[MetricsWriter] = None, device=None):
        self.settings = settings or AppSettings()
        self.metrics = metrics or MetricsWriter(console=False)
        self.device = device
        self.source: Optional[np.ndarray] = None
        self.target: Optional[np.ndarray] = None
        self.source_header = None
        self.target_header = None
        # Pristine copy for replay (registrationservice.cpp:92-99).
        self.original_source: Optional[np.ndarray] = None
        self.result: Optional[ICPResult] = None
        self.history: List[RunRecord] = []
        self._running = False
        self._stop_event = threading.Event()

    # -- loading (C11 DataManager verbs) ---------------------------------

    def load_source(self, path: str | Path, max_points: int = 0,
                    stride: int = 1) -> int:
        with stage("load_source"):
            self.source, self.source_header = read_las(
                path, max_points=max_points, stride=stride
            )
        self.original_source = self.source.copy()
        self.metrics.log(f"source cloud: {len(self.source)} points from {path}")
        return len(self.source)

    def load_target(self, path: str | Path, max_points: int = 0,
                    stride: int = 1) -> int:
        with stage("load_target"):
            self.target, self.target_header = read_las(
                path, max_points=max_points, stride=stride
            )
        self.metrics.log(f"target cloud: {len(self.target)} points from {path}")
        return len(self.target)

    def set_clouds(self, source: np.ndarray, target: np.ndarray) -> None:
        self.source = np.asarray(source, np.float64)
        self.target = np.asarray(target, np.float64)
        self.original_source = self.source.copy()

    # -- registration ----------------------------------------------------

    def run(
        self,
        config: Optional[ICPConfig] = None,
        multiscale: bool = False,
        parallel: str = "none",
        checkpoint_path: Optional[str | Path] = None,
        initial_transform=None,
        live_every: int = 0,
        live_html: Optional[str | Path] = None,
        iteration_base: int = 0,
        **overrides,
    ) -> ICPResult:
        """Run registration (blocking). Mirrors startRegistration →
        ICPEngine::runICP (registrationservice.cpp:186-213).

        ``live_every`` > 0 runs the loop in slices of that many
        iterations: per-iteration records stream to the metrics log as
        they happen (the reference's iterationCompleted signal), a
        ``checkpoint_path`` is rewritten at every slice boundary with the
        exact convergence carry, and ``request_stop()`` takes effect at
        slice boundaries (the reference's cooperative m_shouldStop,
        icpengine.cpp:160-164).

        ``live_html``: with ``live_every`` > 0, (re-)export the
        interactive viewer at every segment boundary with the history so
        far and a 3 s auto-refresh; the caller's final export replaces it
        without the refresh.

        ``parallel``: "none" (one device), "dp" (the source split over a
        mesh of one rank per visible card, ``parallel.sharded``) or
        "partition" (the target split into x-slabs over that mesh,
        ``parallel.partition``); with ``device="cpu"`` the mesh is one CPU
        rank.
        ``overrides`` go to the registration call as keyword arguments
        (e.g. ``resume_carry``, ``device``)."""
        if self.source is None or self.target is None:
            raise RuntimeError("load source and target clouds first")
        if parallel not in ("none", "dp", "partition"):
            raise ValueError(f"unknown parallel mode {parallel!r}")
        if self._running:
            raise RuntimeError("a registration is already running")
        self._running = True
        self._stop_event.clear()
        cfg = (config or self.settings.icp).validate()
        try:
            kwargs = dict(
                max_iterations=cfg.max_iterations,
                tolerance=cfg.tolerance,
                sigma_multiplier=cfg.sigma_multiplier,
                mode=cfg.mode,
                nn_backend=cfg.nn_backend,
                estimator=cfg.estimator,
                robust=cfg.robust,
                # grid_resolution 0 = data-adaptive auto sizing.
                grid_resolution=cfg.grid_resolution or None,
                cell_capacity=cfg.cell_capacity,
                initial_transform=initial_transform,
                device=self.device,
            )
            kwargs.update(overrides)
            live = live_every and live_every > 0
            if live:
                kwargs.setdefault("segment_iterations", live_every)
                rmse_trail = []
                live_records = []

                def on_iteration(rec):
                    if iteration_base:
                        rec = {**rec,
                               "iteration": rec["iteration"] + iteration_base}
                    self.metrics.iteration(rec, cfg.max_iterations)
                    rmse_trail.append(rec["rmse"])
                    if live_html:
                        live_records.append(rec)

                def on_segment(seg):
                    if live_html and live_records:
                        from iterativeclosestpoint_tpu_torch.runtime import (
                            htmlviz,
                        )

                        htmlviz.export_interactive_html(
                            live_html, self.original_source, self.target,
                            history=live_records,
                            title=f"live — iteration "
                                  f"{live_records[-1]['iteration']}",
                            refresh_s=3.0,
                        )
                    if checkpoint_path:
                        # Rolling mid-run checkpoint at segment boundaries:
                        # carries the exact convergence state, so --resume
                        # continues bit-identically (runtime/checkpoint.py).
                        save_checkpoint(
                            checkpoint_path,
                            iteration=seg["iteration"] + iteration_base,
                            transform=seg["transform"],
                            rmse_history=rmse_trail,
                            prev_error=seg["prev_error"],
                            no_improve=seg["no_improve"],
                            transform_local=seg.get("transform_local"),
                            center_offset=seg.get("offset"),
                            config=dataclasses.asdict(cfg),
                        )

                kwargs.setdefault("progress_callback", on_iteration)
                kwargs.setdefault("segment_callback", on_segment)
                kwargs.setdefault("stop_event", self._stop_event)
            self.metrics.log("========== starting ICP registration ==========")
            self.metrics.log(f"source: {len(self.source)} points")
            self.metrics.log(f"target: {len(self.target)} points")
            mesh = None
            if parallel != "none":
                from iterativeclosestpoint_tpu_torch.parallel.mesh import (
                    make_mesh,
                )

                mesh = make_mesh(device=kwargs.get("device"))
                self.metrics.log(
                    f"parallel={parallel}: {mesh.size}-rank mesh")
            t0 = time.perf_counter()
            if multiscale or mesh is not None:
                # One entry for every mesh run: a single level (stride 1)
                # unless ``multiscale``; the fine level runs over the mesh.
                ms_kw = dict(kwargs)
                if mesh is not None:
                    ms_kw["mesh"] = mesh
                if parallel == "partition":
                    ms_kw["fine_path"] = "partitioned"
                if not multiscale:
                    ms_kw["strides"] = (1,)
                result = icp_register_multiscale(
                    self.source, self.target, **ms_kw).final
            else:
                result = icp_register(self.source, self.target, **kwargs)
            dt = time.perf_counter() - t0

            if not live:
                for rec in result.iteration_records():
                    self.metrics.iteration(rec, cfg.max_iterations)
            if result.nn_resolution is not None:
                self.metrics.log(
                    f"nn grid resolution: {result.nn_resolution} cells/axis"
                )
            self.metrics.log("========== registration finished ==========")
            self.metrics.log(
                f"iterations: {result.iterations}  final RMSE: {result.rmse:.6f}"
                f"  ({result.message}, {dt:.2f}s)"
            )
            self.metrics.event(
                "run", success=result.success, message=result.message,
                iterations=result.iterations, rmse=result.rmse, duration_s=dt,
            )

            self.result = result
            if result.source_registered is not None:
                self.source = result.source_registered
            self.history.append(
                RunRecord(
                    timestamp=time.time(),
                    source_points=len(self.source),
                    target_points=len(self.target),
                    iterations=result.iterations,
                    rmse=result.rmse,
                    success=result.success,
                    message=result.message,
                    duration_s=dt,
                )
            )
            if checkpoint_path:
                save_checkpoint(
                    checkpoint_path,
                    iteration=result.iterations + iteration_base,
                    transform=result.transform,
                    rmse_history=result.history_rmse,
                    prev_error=result.carry_prev_error,
                    no_improve=result.carry_no_improve,
                    transform_local=result.carry_transform_local,
                    center_offset=result.center_offset,
                    config=dataclasses.asdict(cfg),
                )
            return result
        finally:
            self._running = False

    def run_async(self, **kwargs) -> threading.Thread:
        """Worker-thread launch (QtConcurrent::run analog,
        registrationservice.cpp:211): join() the returned thread or poll
        is_running(). A worker exception is recorded in ``self.error``
        (the reference surfaces it via the registrationError signal)."""
        self.error: Optional[BaseException] = None

        def worker():
            try:
                self.run(**kwargs)
            except BaseException as e:  # surfaced to the poller
                self.error = e
                self.metrics.log(f"registration failed: {e}")

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        return th

    def is_running(self) -> bool:
        return self._running

    def request_stop(self) -> None:
        """Cooperative stop (stopRegistration analog,
        registrationservice.cpp:215-220). Takes effect at the next segment
        boundary of a ``live_every`` run; the partial result is kept with
        stop reason 'stopped by user'."""
        self._stop_event.set()

    # -- replay (C8/C13) -------------------------------------------------

    def replay(self, k: int) -> np.ndarray:
        """Source cloud as of iteration k (1-based; 0 = original) — the
        viewer's setCurrentIteration (pointcloudviewer.cpp:86-116): apply
        the recorded cumulative transform of iteration k to the pristine
        source."""
        if self.original_source is None:
            raise RuntimeError("no source loaded")
        if k == 0 or self.result is None or self.result.iterations == 0:
            return self.original_source.copy()
        k = min(k, self.result.iterations)
        T = self.result.history_transform[k - 1]
        return self.original_source @ T[:3, :3].T + T[:3, 3]

    # -- artifacts (C11 save / C15 report) -------------------------------

    def save_result(self, path: str | Path, rebase: bool = False):
        """Write the registered source as LAS. Default preserves the
        source file's scale/offset (the CLI policy the reference author
        marks as the fix, icp_registration.cpp:766-773)."""
        if self.source is None:
            raise RuntimeError("nothing to save")
        scale = offset = None
        if self.source_header is not None and not rebase:
            scale = self.source_header.scale
            offset = self.source_header.offset
        with stage("write_las"):
            return write_las(path, self.source, scale=scale, offset=offset,
                             rebase=rebase)

    def save_report(self, txt_path=None, json_path=None) -> None:
        if self.result is None:
            raise RuntimeError("no registration result yet")
        with stage("report"):
            if txt_path:
                write_transform_report(txt_path, self.result)
            if json_path:
                write_history_json(json_path, self.result)

    def export_html(self, path: str | Path, max_points: int = 400_000):
        """Standalone interactive viewer (orbit/pan/zoom + iteration
        replay slider over this run's history); see runtime/htmlviz.py."""
        from iterativeclosestpoint_tpu_torch.runtime.htmlviz import (
            export_interactive_html,
        )

        if self.original_source is None or self.target is None:
            raise RuntimeError("load source and target first")
        history = self.result.iteration_records() if self.result else None
        with stage("html"):
            export_interactive_html(
                path, self.original_source, self.target, history=history,
                max_points=max_points,
            )
