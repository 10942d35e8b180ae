"""iterativeclosestpoint_tpu_torch — the PyTorch/CUDA port of
``iterativeclosestpoint_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference this port is held against; the
port imports none of it (nor JAX). Its exact-NN sweeps are CUDA kernels
written for Hopper (``csrc/``, built with nvcc at first use into
``build/kernels/``); every other step is plain PyTorch. Entry points take
``device=None`` (the card; raises without CUDA) or ``device="cpu"``, which
runs each kernel's plain PyTorch version.

- ``ops``     — SE(3), Kabsch, brute-force NN, the slab-sweep grid, its
                estimators, kernels and repair chain, normals, downsampling.
- ``models``  — pairwise ICP and coarse-to-fine multiscale ICP.
- ``io``      — LAS 1.2 read/write (host).
- ``runtime`` — the registration session, checkpoints, metrics and run
                records, viewers (HTML, PNG), the native host library,
                profiling, the kernel smoke check and stage timing.
- ``utils``   — settings, host reductions, synthetic fixtures, device
                choice, and the f64 NumPy oracle of the reference.
- ``cli``     — the ``icp-torch`` command (the JAX package's ``icp``
                twin; ``--device cpu`` runs the plain versions).
- ``bench``   — ``icp-torch bench``: the headline, volume and plane rows,
                the kernel reports, the native octree baseline and the
                parity check (the JAX package's root ``bench.py``).
- ``convert`` — moves grids and loop carries between the two packages.

The exports are the JAX package's.
"""

from iterativeclosestpoint_tpu_torch.utils.config import AppSettings, ICPConfig
from iterativeclosestpoint_tpu_torch.models.icp import ICPResult, icp_register
from iterativeclosestpoint_tpu_torch.models.multiscale import (
    icp_register_multiscale,
)
from iterativeclosestpoint_tpu_torch.models.posegraph import (
    optimize_pose_graph,
    register_scans,
)

__version__ = "0.1.0"

__all__ = [
    "AppSettings",
    "ICPConfig",
    "ICPResult",
    "icp_register",
    "icp_register_multiscale",
    "optimize_pose_graph",
    "register_scans",
    "__version__",
]
