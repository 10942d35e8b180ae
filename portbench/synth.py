"""Tile pairs with a known rigid motion, made from the run's seed (numpy).

A frozen copy of the port's ``utils/synth.py`` (``make_cloud``,
``random_rigid_transform``, ``make_registration_pair``), so that a later
change to the program cannot move the yardstick. The default
perturbation envelope is the reference test generator's
(``test_icp.cpp:211-215``): yaw up to 10 degrees, pitch and roll up to 5,
2.5 m in x and y, 1 m in z. A mix that names ``motion`` draws in that
envelope instead; the ``*-near`` mixes name a narrower one, as stand-ins
for the reference's, in which the port is not exact.

``make_pool`` adds what a survey has and the copy lacks: each tile of the
pool is its own sample with its own perturbation, and each sits at its
own easting and northing, as LAS tiles do (hundreds of thousands and
millions of metres), so the program's f64 centring and f32 cast see real
offsets.
"""

from __future__ import annotations

import numpy as np


def make_cloud(n: int, seed: int = 0, kind: str = "terrain",
               extent: float = 50.0) -> np.ndarray:
    """An (n, 3) float64 cloud: "terrain" (a smooth heightfield with
    detail, like an airborne scan), "uniform" (a box filled uniformly, z
    squeezed to a fifth) or "sphere" (a noisy spherical shell)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pts = rng.uniform(-extent, extent, size=(n, 3))
        pts[:, 2] *= 0.2
        return pts
    if kind == "sphere":
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        r = extent * (1.0 + 0.02 * rng.normal(size=(n, 1)))
        return v * r
    if kind == "terrain":
        xy = rng.uniform(-extent, extent, size=(n, 2))
        x, y = xy[:, 0], xy[:, 1]
        z = (
            3.0 * np.sin(x * 0.11) * np.cos(y * 0.07)
            + 1.2 * np.sin(x * 0.43 + 1.0) * np.sin(y * 0.31)
            + 0.3 * np.sin(x * 1.7) * np.cos(y * 2.3)
            + 0.05 * rng.normal(size=n)
        )
        return np.stack([x, y, z], axis=1)
    raise ValueError(f"unknown cloud kind {kind!r}")


def random_rigid_transform(seed: int = 0, max_yaw_deg: float = 10.0,
                           max_pitch_roll_deg: float = 5.0,
                           max_txy: float = 2.5,
                           max_tz: float = 1.0) -> np.ndarray:
    """A random (4, 4) rigid motion within the reference's envelope."""
    rng = np.random.default_rng(seed)
    yaw = np.radians(rng.uniform(-max_yaw_deg, max_yaw_deg))
    pitch = np.radians(rng.uniform(-max_pitch_roll_deg, max_pitch_roll_deg))
    roll = np.radians(rng.uniform(-max_pitch_roll_deg, max_pitch_roll_deg))
    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
    Ry = np.array([[cy, 0, sy], [0, 1.0, 0], [-sy, 0, cy]])
    Rx = np.array([[1.0, 0, 0], [0, cx, -sx], [0, sx, cx]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = [rng.uniform(-max_txy, max_txy),
                rng.uniform(-max_txy, max_txy),
                rng.uniform(-max_tz, max_tz)]
    return T


def apply_transform_np(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def make_registration_pair(n: int, seed: int = 0, noise_sigma: float = 0.0,
                           outlier_frac: float = 0.0,
                           overlap_frac: float = 1.0, kind: str = "terrain",
                           extent: float = 50.0, motion=None):
    """(source, target, T_true): the target is the pristine cloud, the
    source the cloud (cropped to ``overlap_frac`` of its x-range) moved by
    T_true's inverse, plus Gaussian noise and a fraction of uniform
    outliers within 5 m of the target's box, so registering source onto
    target recovers T_true. ``motion`` holds ``random_rigid_transform``'s
    envelope (default: the reference's)."""
    rng = np.random.default_rng(seed + 1)
    target = make_cloud(n, seed=seed, kind=kind, extent=extent)
    T_true = random_rigid_transform(seed=seed, **(motion or {}))
    src_base = target.copy()
    if overlap_frac < 1.0:
        lo = np.quantile(src_base[:, 0], 1.0 - overlap_frac)
        src_base = src_base[src_base[:, 0] >= lo]
    Tinv = np.eye(4)
    Tinv[:3, :3] = T_true[:3, :3].T
    Tinv[:3, 3] = -T_true[:3, :3].T @ T_true[:3, 3]
    source = apply_transform_np(Tinv, src_base)
    if noise_sigma > 0:
        source = source + rng.normal(0, noise_sigma, size=source.shape)
    if outlier_frac > 0:
        n_out = int(len(source) * outlier_frac)
        idx = rng.choice(len(source), n_out, replace=False)
        lo, hi = target.min(axis=0), target.max(axis=0)
        source[idx] = rng.uniform(lo - 5, hi + 5, size=(n_out, 3))
    return source, target, T_true


def pair_seeds(seed: int, pool: int) -> list:
    """``pool`` distinct 31-bit seeds drawn from the run's seed (any
    non-negative integer, however large)."""
    ss = np.random.SeedSequence(int(seed))
    seeds = []
    for child in ss.spawn(4 * pool):
        s = int(child.generate_state(1)[0] & 0x7FFFFFFF)
        if s not in seeds:
            seeds.append(s)
        if len(seeds) == pool:
            return seeds
    raise RuntimeError("could not draw distinct pair seeds")


def pool_size(n: int, traffic: dict) -> int:
    """Pairs in the pool: ``pool_points`` worth of tiles of ``n`` points,
    at least ``pool_min``."""
    return max(traffic["pool_min"], traffic["pool_points"] // n)


def make_pool(n: int, seed: int, traffic: dict) -> list:
    """The run's pool of distinct tile pairs: a list of dicts with
    ``source``, ``target`` (world f64, the tile's UTM offset added),
    ``T_true`` (in the world frame) and ``seed``. Tile i sits at
    ``utm_offset + i * tile_step``."""
    offset0 = np.asarray(traffic["utm_offset"], np.float64)
    step = np.asarray(traffic["tile_step"], np.float64)
    pool = []
    for i, s in enumerate(pair_seeds(seed, pool_size(n, traffic))):
        src, tgt, T = make_registration_pair(
            n, seed=s, noise_sigma=traffic["noise_sigma"],
            outlier_frac=traffic.get("outlier_frac", 0.0),
            overlap_frac=traffic.get("overlap_frac", 1.0),
            kind=traffic["kind"], extent=traffic["extent"],
            motion=traffic.get("motion"))
        off = offset0 + i * step
        # The motion about the tile's own origin, moved to the world frame.
        Tw = T.copy()
        Tw[:3, 3] = T[:3, 3] + off - T[:3, :3] @ off
        pool.append({"source": src + off, "target": tgt + off,
                     "T_true": Tw, "seed": s})
    return pool


def schedule(seed: int, pool: int, count: int) -> list:
    """Indices into the pool for ``count`` registrations: the pool in an
    order drawn from the seed, repeated, so no pair follows itself."""
    order = np.random.default_rng(int(seed)).permutation(pool).tolist()
    return [order[i % pool] for i in range(count)]
