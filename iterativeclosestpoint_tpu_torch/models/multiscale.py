"""Coarse-to-fine multiscale ICP (single device).

Counterpart of the JAX package's ``models/multiscale.py``
(``icp_register_multiscale`` :50, ``_run_level`` :293). A coarse pass on a
stride subsample estimates the bulk of the SE(3) with exact brute-force
NN; the full-resolution pass then starts inside the fine grid's cell size,
so its iterations stay on the certified slab sweep. Coarse levels run the
point estimator whatever the fine level's.

Two-stage boosted fine level (plane mode): when the surface boost is
refused by the 32 points-per-cell occupancy gate but the target still
clears a 16 points-per-cell floor, the boosted grid is safe once the pose
has converged (the gate protects the ladder's handoff, not the kernel).
The fine level then runs ``_BOOST2_PRE_ITERATIONS`` plane iterations on
the base grid and continues on the boosted grid through ``resume_carry``
(the exact convergence carry) and ``layout_transform`` (the query layout
rebuilt at the stage-boundary pose; the source stays raw): one logical
registration whose histories concatenate and whose callbacks see
consecutive iteration numbers. Point mode keeps one stage: its pose on
smooth terrain stalls above the boosted cell size.

The JAX package enqueued the coarse inputs before the bulk uploads and
deferred the fine grid build behind the coarse loop, working around a
FIFO host-to-device queue on the TPU host (``multiscale.py:143-235``).
That ordering is left out on purpose: here the fine level's upload,
grid estimate and grid build simply run after the coarse level, and the
``overlap_device_prep`` option that switched it is accepted and changes
nothing.

With a ``mesh`` the coarse levels run on one device and the fine level
runs data-parallel over the mesh (``parallel.sharded``), from the same
device-side fine inputs (grids, and the source moved by the coarse pose
on its device), so a 1-rank mesh is the single-device run bit for bit;
the two-stage boosted level is a single-device refinement and stays off
under a mesh, as in the JAX package. On a mesh over several processes
the fine level takes the host path (its source moved by the coarse pose
on the host; JAX ``multiscale.py:119``). ``fine_path="partitioned"`` runs the
fine level with the target split into x-slabs over the mesh
(``parallel.partition``), with the coarse transform as its initial
pose; ``nn_backend`` maps onto its local search.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from iterativeclosestpoint_tpu_torch.models.icp import (
    MAX_ITERATIONS,
    ICPResult,
    icp_register,
)
from iterativeclosestpoint_tpu_torch.models.prep import (
    nn_backend_for,
    prepare_level,
)
from iterativeclosestpoint_tpu_torch.runtime.timing import (
    registration_call,
    scope,
    stage,
)
from iterativeclosestpoint_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class MultiscaleResult:
    """Fine-level result plus the per-level trail."""

    final: ICPResult
    levels: list  # [(stride, ICPResult), ...] coarse → fine

    @property
    def transform(self) -> np.ndarray:
        return self.final.transform

    @property
    def rmse(self) -> float:
        return self.final.rmse

    @property
    def success(self) -> bool:
        return self.final.success


def _prepare_fine(source, target, fine_kwargs, dev, two_stage=True):
    """The fine level's ``prepare_level`` in f32 with the slab sweep, its
    spans outside the ``fine`` scope: (device_data, prepared_nn,
    prepared_nn2), the last the two-stage level's boosted grid or None
    (its gate refuses, or ``two_stage`` is false: a mesh's fine level)."""
    device_data, nn, nn2, _ = prepare_level(
        source, target, dev, center=fine_kwargs.get("center", True),
        nn_backend="pallas", estimator=fine_kwargs.get("estimator", "point"),
        grid_resolution=fine_kwargs.get("grid_resolution"),
        two_stage=two_stage)
    return device_data, nn, nn2


@registration_call
def icp_register_multiscale(
    source,
    target,
    *,
    strides: Optional[Sequence[int]] = None,
    coarse_max_points: int = 30_000,
    coarse_iterations: int = 20,
    coarse_tolerance: float = 1e-4,
    dtype=torch.float32,
    mesh=None,
    fine_path: str = "auto",
    initial_transform: Optional[np.ndarray] = None,
    coarse_nn_backend: str = "auto",
    overlap_device_prep: bool = True,
    device=None,
    **fine_kwargs,
) -> MultiscaleResult:
    """Register via a stride pyramid; the fine level gets every point.

    ``strides``: explicit pyramid, e.g. (16, 4, 1); default = one coarse
    level with stride ceil(N / coarse_max_points) (plus sqrt-spaced levels
    for very large clouds) then full resolution. ``device``: None means the
    card; "cpu" runs the plain versions; the coarse levels and the fine
    level's device inputs live there. ``mesh`` (``parallel.make_mesh``)
    runs the fine level over its ranks: data-parallel with
    ``fine_path="auto"``, the target split into x-slabs with
    ``fine_path="partitioned"`` (a mesh of one rank on ``device`` when
    ``mesh`` is None). ``coarse_nn_backend`` ("auto",
    "bruteforce", "pallas", "cellblock" or "hashgrid") is the coarse
    levels' NN backend.
    ``overlap_device_prep`` is the JAX package's TPU upload ordering; it is
    accepted and changes nothing here (see the module docstring).
    ``fine_kwargs`` go to the final full-resolution ``icp_register``
    (nn_backend, max_iterations, tolerance, mode, ...); with a caller's
    ``nn_fn`` (and ``nn_state``) the fine level builds no grids.
    """
    if fine_path not in ("auto", "partitioned"):
        raise ValueError(f"unknown fine_path {fine_path!r}")
    # Checked before any level runs, not by the first coarse level.
    if coarse_nn_backend not in ("auto", "bruteforce", "pallas",
                                 "cellblock", "hashgrid"):
        raise ValueError(f"unknown coarse_nn_backend {coarse_nn_backend!r}")
    del overlap_device_prep  # the TPU upload ordering; see the docstring
    dev = resolve_device(device)
    source = np.asarray(source, np.float64)
    target = np.asarray(target, np.float64)
    n = len(source)

    if strides is None:
        s = max(1, -(-n // coarse_max_points))
        # Deep pyramids for very large clouds: sqrt-spaced levels keep each
        # level's residual misalignment below the next level's cell size.
        ladder = [s]
        while ladder[-1] > 64:
            ladder.append(max(2, int(round(ladder[-1] ** 0.5))))
        strides = tuple(ladder) + (1,) if s > 1 else (1,)
    if strides[-1] != 1:
        strides = tuple(strides) + (1,)

    fine_backend = fine_kwargs.get("nn_backend", "auto")
    prepare = (
        len(strides) > 1
        and fine_path != "partitioned"  # builds its own per-slab grids
        # The prepared grids are one process's device state: a mesh over
        # several processes takes the host build path.
        and (mesh is None or mesh.process_count == 1)
        and dtype == torch.float32
        and fine_kwargs.get("nn_fn") is None  # a caller's NN: no grids
        and nn_backend_for(fine_backend, n, len(target)) == "pallas"
    )
    T = (np.asarray(initial_transform, np.float64)
         if initial_transform is not None else None)
    levels = []
    for li, stride in enumerate(strides):
        last = li == len(strides) - 1
        if not last:
            with scope(f"coarse{li}" if li else "coarse"):
                res = icp_register(
                    source[::stride], target[::stride], dtype=dtype,
                    initial_transform=T, max_iterations=coarse_iterations,
                    tolerance=coarse_tolerance,
                    nn_backend=coarse_nn_backend,
                    mode=fine_kwargs.get("mode", "gui"),
                    return_registered=False, device=dev,
                )
        else:
            device_data = prepared_nn = prepared_nn2 = None
            if prepare:
                device_data, prepared_nn, prepared_nn2 = _prepare_fine(
                    source, target, fine_kwargs, dev, mesh is None)
                fine_kwargs.setdefault("nn_backend", "pallas")
            with scope("fine"):
                if fine_path == "partitioned":
                    res = _run_partitioned(source, target, T, dtype, dev,
                                           mesh, fine_kwargs)
                elif mesh is not None:
                    res = _run_sharded(source, target, T, dtype, mesh,
                                       fine_kwargs, device_data, prepared_nn)
                else:
                    res = _run_fine(source, target, T, dtype, dev,
                                    fine_kwargs, device_data, prepared_nn,
                                    prepared_nn2)
        levels.append((stride, res))
        T = res.transform
        if not res.success:
            break
    return MultiscaleResult(final=levels[-1][1], levels=levels)


def _run_partitioned(source, target, T, dtype, dev, mesh, fine_kwargs):
    """The fine level with the target split over ``mesh`` (one rank on
    ``dev`` when None); ``nn_backend`` picks the local search."""
    from iterativeclosestpoint_tpu_torch.parallel.partition import (
        icp_register_partitioned,
        partitioned_kwargs,
    )

    return icp_register_partitioned(source, target, mesh=mesh, dtype=dtype,
                                    initial_transform=T, device=dev,
                                    **partitioned_kwargs(fine_kwargs))


def _run_sharded(source, target, T, dtype, mesh, fine_kwargs, device_data,
                 prepared_nn):
    """The fine level data-parallel over ``mesh``, from the prepared
    device inputs (``T`` applied to the source on its device) or from the
    host."""
    from iterativeclosestpoint_tpu_torch.parallel.sharded import (
        icp_register_sharded,
    )

    return icp_register_sharded(source, target, mesh=mesh, dtype=dtype,
                                initial_transform=T, device_data=device_data,
                                prepared_nn=prepared_nn, **fine_kwargs)


# Stage-1 length of the two-stage boosted fine level: enough plane
# iterations to converge the pose well inside the boosted cell size.
_BOOST2_PRE_ITERATIONS = 5


def _run_fine(source, target, T, dtype, dev, fine_kwargs, device_data,
              prepared_nn, prepared_nn2):
    """The full-resolution level: one ``icp_register``, or the two-stage
    boosted level when ``prepared_nn2`` is given and the iteration budget
    exceeds the first stage. An early stop in stage 1 is the result."""
    K = _BOOST2_PRE_ITERATIONS
    mi = fine_kwargs.get("max_iterations", 50)
    common = dict(dtype=dtype, device_data=device_data, device=dev)
    if prepared_nn2 is None or mi <= K:
        return icp_register(source, target, initial_transform=T,
                            prepared_nn=prepared_nn, **common, **fine_kwargs)

    fk1 = dict(fine_kwargs, max_iterations=K, return_registered=False)
    res1 = icp_register(source, target, initial_transform=T,
                        prepared_nn=prepared_nn, **common, **fk1)
    if res1.stop_reason != MAX_ITERATIONS:
        if fine_kwargs.get("return_registered", True):
            with stage("registered"):
                Tw = np.asarray(res1.transform)
                res1.source_registered = source @ Tw[:3, :3].T + Tw[:3, 3]
        return res1

    fk2 = dict(fine_kwargs, max_iterations=mi - K)
    pc = fine_kwargs.get("progress_callback")
    if pc is not None:
        fk2["progress_callback"] = (
            lambda rec: pc({**rec, "iteration": rec["iteration"] + K}))
    sc = fine_kwargs.get("segment_callback")
    if sc is not None:
        fk2["segment_callback"] = (
            lambda st: sc({**st, "iteration": st["iteration"] + K}))
    res2 = icp_register(
        source, target, prepared_nn=prepared_nn2,
        resume_carry={"transform": res1.transform,
                      "prev_error": res1.carry_prev_error,
                      "no_improve": res1.carry_no_improve},
        layout_transform=res1.transform, **common, **fk2,
    )
    res2.iterations += res1.iterations
    for f in dataclasses.fields(ICPResult):
        if f.name.startswith("history_"):
            setattr(res2, f.name, np.concatenate(
                [getattr(res1, f.name), getattr(res2, f.name)], axis=0))
    return res2
