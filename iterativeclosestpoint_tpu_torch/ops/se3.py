"""SE(3) rigid-transform utilities on (4,4) homogeneous matrices.

Points are ``(N, 3)`` tensors; transforms are ``(4, 4)`` row-major
homogeneous matrices so that ``p' = R @ p + t`` with ``R = T[:3,:3]``,
``t = T[:3,3]`` (the reference's transform plumbing,
``PointCloudRegistration/core/pointcloud.cpp:73-105``). Counterpart of the
JAX package's ``ops/se3.py``; matmuls run in full f32 (no TF32, see
``utils/device.py``).
"""

from __future__ import annotations

import torch


def apply_transform(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (4,4) rigid transform to (..., 3) points: p' = R p + t."""
    return points @ T[:3, :3].T + T[:3, 3]


def registration_error(T_a, T_b, points) -> torch.Tensor:
    """Max displacement (metres) between the two maps evaluated at the cloud.

    The lever-arm-free parity metric: at UTM-scale coordinates raw matrix
    entries multiply rotation error by the ~1e6 m offset; the displacement
    of the actual points is the physically meaningful discrepancy.
    """
    pa = apply_transform(T_a, points)
    pb = apply_transform(T_b, points)
    return torch.linalg.vector_norm(pa - pb, dim=-1).max()
