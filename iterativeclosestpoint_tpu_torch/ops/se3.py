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


def identity_transform(dtype=torch.float32, device=None) -> torch.Tensor:
    """(4,4) identity transform."""
    return torch.eye(4, dtype=dtype, device=device)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a (4,4) homogeneous transform from (3,3) R and (3,) t.

    Built out of place (no writes into an identity), so ``torch.func``
    can differentiate it under ``vmap``."""
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([torch.cat([R, t.to(R.dtype)[:, None]], dim=1), bottom])


def compose(T_new: torch.Tensor, T_old: torch.Tensor) -> torch.Tensor:
    """Accumulate: T_new @ T_old (apply T_old first, then T_new), the
    reference engine's ``T_cumulative = T * T_cumulative``."""
    return T_new @ T_old


def apply_transform(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (4,4) rigid transform to (..., 3) points: p' = R p + t."""
    return points @ T[:3, :3].T + T[:3, 3]


def rotation_angle_deg(T: torch.Tensor) -> torch.Tensor:
    """Rotation angle (degrees) of the transform, from the trace formula
    the reference records per iteration (icpengine.cpp:360-361):
    ``acos((trace(R) - 1) / 2)``, the argument clipped to [-1, 1] against
    round-off."""
    c = (torch.trace(T[:3, :3]) - 1.0) / 2.0
    return torch.rad2deg(torch.arccos(torch.clip(c, -1.0, 1.0)))


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of the translation part (icpengine.cpp:362)."""
    return torch.linalg.vector_norm(T[:3, 3])


def se3_from_euler(yaw_deg, pitch_deg, roll_deg, tx, ty, tz,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """An SE(3) transform from Z-Y-X Euler angles (degrees) and a
    translation, R = Rz(yaw) @ Ry(pitch) @ Rx(roll): the convention of the
    reference's test-data generator (``test_icp.cpp:165-189``)."""
    def rad(a):
        return torch.deg2rad(torch.as_tensor(a, dtype=dtype, device=device))

    yaw, pitch, roll = rad(yaw_deg), rad(pitch_deg), rad(roll_deg)
    cz, sz = torch.cos(yaw), torch.sin(yaw)
    cy, sy = torch.cos(pitch), torch.sin(pitch)
    cx, sx = torch.cos(roll), torch.sin(roll)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    Ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    t = torch.stack([torch.as_tensor(v, dtype=dtype, device=device)
                     for v in (tx, ty, tz)])
    return make_transform(Rz @ Ry @ Rx, t)


def invert_transform(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform: [Rᵀ, -Rᵀt]."""
    Rt = T[:3, :3].T
    return make_transform(Rt, -(Rt @ T[:3, 3]))


def transform_error(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """Scalar discrepancy of two rigid transforms: max|R_a − R_b| +
    max|t_a − t_b| (raw entries; ``registration_error`` is the lever-arm
    free metric at UTM scale)."""
    dR = (T_a[:3, :3] - T_b[:3, :3]).abs().max()
    dt = (T_a[:3, 3] - T_b[:3, 3]).abs().max()
    return dR + dt


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
    return make_transform(so3_exp(w), V @ v)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(3,3) rotation → (3,) axis-angle via atan2 (smooth at identity).

    Valid for θ well below π (pose-graph edges are small relative
    motions). Both branches are evaluated on safe inputs (the double
    ``where``), so forward-mode derivatives at θ = 0 stay finite."""
    s_vec = 0.5 * torch.stack(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s2 = (s_vec * s_vec).sum()  # sin²θ
    c = torch.clip((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    small = s2 < 1e-14
    sin_safe = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(sin_safe, c)
    # θ/sinθ: a series in sin²θ near 0.
    factor = torch.where(small, 1.0 + s2 / 6.0, theta / sin_safe)
    return factor * s_vec


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(4,4) transform → (6,) twist [v, w] (differentiable near identity)."""
    w = so3_log(T[:3, :3])
    t2 = (w * w).sum()
    small = t2 < 1e-14
    t2s = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2s)
    W = _skew(w)
    # V⁻¹ = I - W/2 + coef·W², coef = 1/θ² − (1+cosθ)/(2θ sinθ).
    sin_safe = torch.where(small, torch.ones_like(t2), torch.sin(theta))
    coef = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        1.0 / t2s - (1.0 + torch.cos(theta)) / (2.0 * theta * sin_safe))
    Vinv = torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * W \
        + coef * (W @ W)
    return torch.cat([Vinv @ T[:3, 3], w])


def registration_error(T_a, T_b, points) -> torch.Tensor:
    """Max displacement (metres) between the two maps evaluated at the cloud.

    The lever-arm-free parity metric: at UTM-scale coordinates raw matrix
    entries multiply rotation error by the ~1e6 m offset; the displacement
    of the actual points is the physically meaningful discrepancy.
    """
    pa = apply_transform(T_a, points)
    pb = apply_transform(T_b, points)
    return torch.linalg.vector_norm(pa - pb, dim=-1).max()
