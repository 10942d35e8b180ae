"""The control: the reference step computed in bfloat16.

The configurations state float32 on the device. The port's float32 work
is element-wise and reductions (distances, statistics, moments), where
TF32 changes nothing, so the nearest precision below it is bfloat16. This
module runs ``icp_ref.Level.step``'s arithmetic with the centred
coordinates, the pose, the distances, the statistics and the moment sums
in bfloat16 (torch on the host). The nearest neighbour is searched exactly
over the bfloat16-rounded rows, and the 3x3 SVD and the 6x6 solve take the
bfloat16 sums in float32, since torch has no bfloat16 solver. Its output
is judged as the program's is: against the float64 reference at the same
pose.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from portbench.reference.icp_ref import se3_exp

BF16 = torch.bfloat16


def _bf(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64)).to(BF16)


class LowLevel:
    """A reference level with its rows rounded to bfloat16."""

    def __init__(self, level):
        self.src = _bf(level.src)
        self.tgt = _bf(level.tgt)
        self.nrm = None if level.nrm is None else _bf(level.nrm)
        self.tree = cKDTree(self.tgt.double().numpy())

    def step(self, T_local: np.ndarray, *, widen: bool, estimator: str,
             sigma: float = 3.0) -> dict:
        T = _bf(T_local)
        cur = self.src @ T[:3, :3].T + T[:3, 3]
        _, idx = self.tree.query(cur.double().numpy(), k=1, workers=-1)
        idx = torch.as_tensor(idx)
        dst = self.tgt[idx]
        diff = cur - dst
        dist = torch.sqrt((diff * diff).sum(dim=1))
        n = dist.shape[0]
        mean = dist.sum() / n
        std = torch.sqrt(((dist - mean) ** 2).sum() / n)
        spread = sigma * std
        if widen:
            spread = torch.maximum(spread, mean * 0.5)
        thr = mean + spread
        valid = dist <= thr
        cnt = int(valid.sum())
        w = valid.to(BF16)
        rmse = torch.sqrt((w * dist * dist).sum() / max(cnt, 1))
        if estimator == "plane":
            nrm = self.nrm[idx]
            r0 = (diff * nrm).sum(dim=1)
            J = torch.cat([nrm, torch.linalg.cross(cur, nrm, dim=1)], dim=1)
            Jw = J * w[:, None]
            H = (Jw.T @ J).float()
            g = (Jw.T @ r0).float()
            lam = 1e-6 * torch.trace(H) / 6.0 + 1e-12
            delta = torch.linalg.solve(H + lam * torch.eye(6), -g)
            T_next = se3_exp(delta.double().numpy()) @ T.double().numpy()
        else:
            c = w.sum()
            cs = (w @ self.src) / c
            cd = (w @ dst) / c
            H = (((self.src - cs) * w[:, None]).T @ (dst - cd)).float()
            U, _, Vh = torch.linalg.svd(H)
            V = Vh.T
            if torch.linalg.det(V @ U.T) < 0:
                V[:, 2] *= -1.0
            R = V @ U.T
            T_next = np.eye(4)
            T_next[:3, :3] = R.double().numpy()
            T_next[:3, 3] = (cd.float() - R @ cs.float()).double().numpy()
        return {"mean": float(mean), "std": float(std), "thr": float(thr),
                "valid": cnt, "rmse": float(rmse), "T": T_next, "n": n}
