"""iterativeclosestpoint_tpu_torch — the PyTorch/CUDA port of
``iterativeclosestpoint_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference this port is held against; the
port imports none of it (nor JAX). Its exact-NN sweeps are CUDA kernels
written for Hopper (``csrc/``, built with nvcc at first use into
``build/kernels/``); every other step is plain PyTorch. Entry points take
``device=None`` (the card; raises without CUDA) or ``device="cpu"``, which
runs each kernel's plain PyTorch version.

- ``ops``     — SE(3), Kabsch, brute-force NN, the slab-sweep grid, its
                estimators, kernels and repair chain.
- ``models``  — pairwise ICP and coarse-to-fine multiscale ICP.
- ``runtime`` — stage timing.
- ``utils``   — host reductions, synthetic fixtures, device choice.
- ``convert`` — moves grids and loop carries between the two packages.
"""

from iterativeclosestpoint_tpu_torch.models.icp import ICPResult, icp_register
from iterativeclosestpoint_tpu_torch.models.multiscale import (
    icp_register_multiscale,
)

__all__ = ["ICPResult", "icp_register", "icp_register_multiscale"]
