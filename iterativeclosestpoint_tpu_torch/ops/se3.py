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


def _skew(w: torch.Tensor) -> torch.Tensor:
    """(3,) → (3,3) cross-product matrix [w]×."""
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([
        torch.stack([z, -w[2], w[1]]),
        torch.stack([w[2], z, -w[0]]),
        torch.stack([-w[1], w[0], z]),
    ])


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (3,) axis-angle → (3,3) rotation. Below θ² = 1e-14 the
    coefficients are their Taylor series, selected by ``where`` on the
    device (no host read)."""
    t2 = (w * w).sum()
    small = t2 < 1e-14
    t2s = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2s)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    W = _skew(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * W + B * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(6,) twist [v, w] → (4,4) transform (V-matrix form)."""
    v = xi[:3]
    w = xi[3:]
    t2 = (w * w).sum()
    small = t2 < 1e-14
    t2s = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2s)
    W = _skew(w)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / (t2s * theta))
    V = torch.eye(3, dtype=xi.dtype, device=xi.device) + B * W + C * (W @ W)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = so3_exp(w)
    T[:3, 3] = V @ v
    return T


def registration_error(T_a, T_b, points) -> torch.Tensor:
    """Max displacement (metres) between the two maps evaluated at the cloud.

    The lever-arm-free parity metric: at UTM-scale coordinates raw matrix
    entries multiply rotation error by the ~1e6 m offset; the displacement
    of the actual points is the physically meaningful discrepancy.
    """
    pa = apply_transform(T_a, points)
    pb = apply_transform(T_b, points)
    return torch.linalg.vector_norm(pa - pb, dim=-1).max()
