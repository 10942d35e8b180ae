"""The plain reference of one registration step, in float64.

numpy and scipy's ``cKDTree`` (an exact nearest-neighbour search) only:
nothing of the program, of JAX or of the JAX package is imported, and
nothing the program derived is taken. From the host inputs of a
registration this module works out again the centring offset, the coarse
levels' subsamples, the target's normals, and then one step of the
reference engine's iteration (``icpengine.cpp:117-394``) from a given
pose:

  exact 1-NN of every source point at the pose -> population mean and
  sigma of the distances -> threshold mean + 3 sigma (a level's first
  step in "gui" mode: mean + max(3 sigma, mean / 2)) -> inlier mask ->
  RMSE over the inliers -> the pose update over the inliers: Kabsch from
  the pristine source to the matched targets (point mode), or one
  point-to-plane Gauss-Newton step with the damping 1e-6 tr(H) / 6 + 1e-12
  composed onto the pose (plane mode).

Poses are world-frame (4, 4) float64 matrices; the arithmetic runs in the
frame centred on the target's bounding-box centre, which is where the
point-to-plane linearisation is defined.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def center_offset(target: np.ndarray) -> np.ndarray:
    """The centre of the target's bounding box."""
    return (target.min(axis=0) + target.max(axis=0)) / 2.0


def level_strides(n: int, coarse_max_points: int) -> tuple:
    """The multiscale pyramid: one coarse level of stride
    ceil(n / coarse_max_points), square-root-spaced levels below it while
    the stride is over 64, then every point (stride 1)."""
    s = max(1, -(-n // coarse_max_points))
    if s == 1:
        return (1,)
    ladder = [s]
    while ladder[-1] > 64:
        ladder.append(max(2, int(round(ladder[-1] ** 0.5))))
    return tuple(ladder) + (1,)


def base_resolution(target_local: np.ndarray, occupancy: int = 128,
                    probe: int = 32) -> int:
    """The grid resolution the target's normals are estimated on: the
    power of two (8..512) whose occupied cells hold about ``occupancy``
    points, from the occupied-cell counts at two scales (the box
    dimension d, about 2 for a scanned surface and 3 for a volume). The
    counts are taken on the float32 cloud, from every point up to 2M and
    a strided sample above."""
    tgt = np.asarray(target_local, np.float32)
    tmin = tgt.min(axis=0).astype(np.float64)
    tmax = tgt.max(axis=0).astype(np.float64)
    extent = float((tmax - tmin).max()) or 1.0
    probe_pts = tgt[:: max(1, len(tgt) // 2_000_000)]
    r2 = 2 * probe
    c = np.clip((probe_pts - tmin) / (extent / r2), 0, r2 - 1).astype(
        np.int32)
    c2 = len(np.unique((c[:, 0] * r2 + c[:, 1]) * r2 + c[:, 2]))
    h = c >> 1
    c1 = len(np.unique((h[:, 0] * probe + h[:, 1]) * probe + h[:, 2]))
    d = min(max(np.log2(max(c2, 1) / max(c1, 1)), 1.0), 3.0)
    r = probe * (len(tgt) / (occupancy * max(c1, 1))) ** (1.0 / d)
    return int(1 << int(np.clip(np.round(np.log2(max(r, 1))), 3, 9)))


def cellpca_normals(target_local: np.ndarray, resolution: int,
                    min_points: int = 3) -> np.ndarray:
    """(m, 3) unit normals: the points grouped by their cell of the cubic
    ``resolution`` grid over the target's box (cell = longest extent /
    resolution), each cell's covariance giving the normal of its members
    (the eigenvector of the smallest eigenvalue, turned to +z); cells with
    fewer than ``min_points`` members get +z."""
    tgt = np.asarray(target_local, np.float64)
    m = len(tgt)
    tmin = tgt.min(axis=0)
    cell = max(float((tgt.max(axis=0) - tmin).max()) / resolution, 1e-9)
    co = np.clip(((tgt - tmin) / cell).astype(np.int64), 0, resolution - 1)
    cid = (co[:, 0] * resolution + co[:, 1]) * resolution + co[:, 2]
    cells, inv = np.unique(cid, return_inverse=True)
    k = len(cells)
    cnt = np.bincount(inv, minlength=k).astype(np.float64)
    # Cell-local coordinates keep the sums well conditioned.
    loc = tgt - (co * cell + tmin)
    mean = np.stack([np.bincount(inv, loc[:, a], k) for a in range(3)], 1)
    mean /= cnt[:, None]
    cen = loc - mean[inv]
    cov = np.empty((k, 3, 3))
    for a in range(3):
        for b in range(a, 3):
            cov[:, a, b] = cov[:, b, a] = np.bincount(
                inv, cen[:, a] * cen[:, b], k) / cnt
    _, vec = np.linalg.eigh(cov)
    nrm = vec[:, :, 0]
    nrm[nrm[:, 2] < 0] *= -1.0
    nrm[cnt < min_points] = (0.0, 0.0, 1.0)
    return nrm[inv]


def _skew(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """(6,) twist [v, w] -> (4, 4) rigid motion (Rodrigues' rotation and
    the V-matrix translation)."""
    v, w = xi[:3], xi[3:]
    t2 = float(w @ w)
    W = _skew(w)
    if t2 < 1e-14:
        A, B, C = 1.0 - t2 / 6.0, 0.5 - t2 / 24.0, 1.0 / 6.0 - t2 / 120.0
    else:
        th = np.sqrt(t2)
        A = np.sin(th) / th
        B = (1.0 - np.cos(th)) / t2
        C = (th - np.sin(th)) / (t2 * th)
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + A * W + B * (W @ W)
    T[:3, 3] = (np.eye(3) + B * W + C * (W @ W)) @ v
    return T


def kabsch(src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The rigid motion that best maps the weighted ``src`` rows onto
    ``dst``: centroids, cross-covariance, SVD, R = V U^T with V's third
    column flipped when det < 0 (``icpengine.cpp:76-115``)."""
    cnt = w.sum()
    cs = (w @ src) / cnt
    cd = (w @ dst) / cnt
    H = ((src - cs) * w[:, None]).T @ (dst - cd)
    U, _, Vh = np.linalg.svd(H)
    V = Vh.T
    if np.linalg.det(V @ U.T) < 0:
        V[:, 2] *= -1.0
    T = np.eye(4)
    T[:3, :3] = V @ U.T
    T[:3, 3] = cd - T[:3, :3] @ cs
    return T


def plane_increment(cur: np.ndarray, dst: np.ndarray, nrm: np.ndarray,
                    w: np.ndarray) -> np.ndarray:
    """One damped Gauss-Newton step of sum w ((R c + t - d) . n)^2
    linearised about the current points ``cur``, as a (4, 4) motion."""
    r0 = ((cur - dst) * nrm).sum(axis=1)
    J = np.concatenate([nrm, np.cross(cur, nrm)], axis=1)
    Jw = J * w[:, None]
    H = Jw.T @ J
    g = Jw.T @ r0
    lam = 1e-6 * np.trace(H) / 6.0 + 1e-12
    return se3_exp(np.linalg.solve(H + lam * np.eye(6), -g))


def to_local(T_world: np.ndarray, offset: np.ndarray) -> np.ndarray:
    T = np.array(T_world, np.float64)
    T[:3, 3] = T[:3, 3] + T[:3, :3] @ offset - offset
    return T


def to_world(T_local: np.ndarray, offset: np.ndarray) -> np.ndarray:
    T = np.array(T_local, np.float64)
    T[:3, 3] = T[:3, 3] - T[:3, :3] @ offset + offset
    return T


class Level:
    """One level of a registration: its source and target rows in the
    centred frame, the exact search over the target, and the target's
    normals in plane mode."""

    def __init__(self, source_local, target_local, normals=None):
        self.src = np.asarray(source_local, np.float64)
        self.tgt = np.asarray(target_local, np.float64)
        self.nrm = normals
        self.tree = cKDTree(self.tgt)
        lo, hi = self.src.min(axis=0), self.src.max(axis=0)
        self.corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                 for y in (lo[1], hi[1])
                                 for z in (lo[2], hi[2])])

    def step(self, T_local: np.ndarray, *, widen: bool, estimator: str,
             sigma: float = 3.0) -> dict:
        """One iteration from the pose ``T_local``: its statistics and
        the next pose (local frame)."""
        cur = self.src @ T_local[:3, :3].T + T_local[:3, 3]
        dist, idx = self.tree.query(cur, k=1, workers=-1)
        n = len(dist)
        mean = dist.sum() / n
        std = np.sqrt(((dist - mean) ** 2).sum() / n)
        thr = mean + (max(sigma * std, 0.5 * mean) if widen
                      else sigma * std)
        valid = dist <= thr
        cnt = int(valid.sum())
        rmse = np.sqrt((dist[valid] ** 2).sum() / max(cnt, 1))
        w = valid.astype(np.float64)
        dst = self.tgt[idx]
        if estimator == "plane":
            T_next = plane_increment(cur, dst, self.nrm[idx], w) @ T_local
        else:
            T_next = kabsch(self.src, dst, w)
        return {"mean": mean, "std": std, "thr": thr, "valid": cnt,
                "rmse": rmse, "T": T_next, "n": n}


def registration_levels(source: np.ndarray, target: np.ndarray, *,
                        coarse_max_points: int, estimator: str):
    """(offset, [(stride, Level), ...]) for one registration from its
    host inputs: the centring offset, every level's rows, and the full
    target's normals at its base resolution in plane mode (the coarse
    levels use the point update)."""
    offset = center_offset(target)
    src = source - offset
    tgt = target - offset
    levels = []
    for s in level_strides(len(source), coarse_max_points):
        normals = None
        if s == 1 and estimator == "plane":
            normals = cellpca_normals(tgt, base_resolution(tgt))
        levels.append((s, Level(src[::s], tgt[::s], normals)))
    return offset, levels


def fine_level(source: np.ndarray, target: np.ndarray, *, estimator: str,
               rows: int, rng) -> tuple:
    """(offset, Level) of the full-resolution level alone, its source cut
    to ``rows`` rows drawn by ``rng`` (every row where there are no more),
    the target whole, with its normals in plane mode."""
    offset = center_offset(target)
    src = source - offset
    tgt = target - offset
    if rows < len(src):
        src = src[np.sort(rng.choice(len(src), rows, replace=False))]
    normals = (cellpca_normals(tgt, base_resolution(tgt))
               if estimator == "plane" else None)
    return offset, Level(src, tgt, normals)


def pose_gap(T_a: np.ndarray, T_b: np.ndarray, corners: np.ndarray) -> float:
    """The largest distance between where two poses put a corner of the
    source's box: the largest displacement over the whole box."""
    pa = corners @ T_a[:3, :3].T + T_a[:3, 3]
    pb = corners @ T_b[:3, :3].T + T_b[:3, 3]
    return float(np.sqrt(((pa - pb) ** 2).sum(axis=1)).max())
