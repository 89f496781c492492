"""TUM-format trajectory output + ATE evaluation.

An own copy of `sr_livo_tpu/runtime/tum.py`.

The reference appends TUM lines per retired frame (recordSinglePose,
lioOptimization.cpp:1133-1172: `t x y z qx qy qz qw`) and leaves ATE to
external tools; here the evaluator is built in (SE(3) Umeyama alignment +
RMSE) so trajectory accuracy is a first-class test metric.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def write_tum(path: str, times: Sequence[float], positions: np.ndarray,
              quats_wxyz: np.ndarray):
    """Write TUM format: `time x y z qx qy qz qw` per line."""
    with open(path, "w") as f:
        for t, p, q in zip(times, positions, quats_wxyz):
            f.write(f"{t:.9f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")


def read_tum(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    data = np.loadtxt(path).reshape(-1, 8)
    times = data[:, 0]
    pos = data[:, 1:4]
    q_xyzw = data[:, 4:8]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, :3]], axis=-1)
    return times, pos, q_wxyz


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Nearest-time association; returns (idx_est, idx_gt)."""
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    left = j - 1
    pick = np.where(np.abs(t_gt[j] - t_est) < np.abs(t_gt[left] - t_est),
                    j, left)
    ok = np.abs(t_gt[pick] - t_est) <= max_dt
    return np.nonzero(ok)[0], pick[ok]


def umeyama_se3(src: np.ndarray, dst: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Rigid alignment (no scale): returns (R, t) with dst ~ R src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / src.shape[0]
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    t = mu_d - r @ mu_s
    return r, t


def ate_rmse(t_est: np.ndarray, p_est: np.ndarray,
             t_gt: np.ndarray, p_gt: np.ndarray,
             align: bool = True, max_dt: float = 0.02) -> float:
    """Absolute trajectory error RMSE after nearest-time association and
    optional SE(3) alignment (evo-style `ape -a`)."""
    ie, ig = associate(np.asarray(t_est, np.float64), np.asarray(t_gt, np.float64),
                       max_dt)
    if len(ie) < 3:
        return float("inf")
    pe = p_est[ie]
    pg = p_gt[ig]
    if align:
        r, t = umeyama_se3(pe, pg)
        pe = pe @ r.T + t
    err = pe - pg
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))
