"""Absolute trajectory error against the generator's ground truth.

Frozen from `sr_livo_tpu_torch/runtime/tum.py` at commit f22c487785a4
(`umeyama_se3`, the alignment of `ate_rmse`); later changes to the port
do not change it.  The positions here are paired by stamp already (the
truth is read at each frame's own time), so `associate` is not needed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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


def ate_rmse(p_est: np.ndarray, p_gt: np.ndarray) -> float:
    """RMSE of the estimated positions against the true ones at the same
    stamps, after the best rigid alignment (evo-style `ape -a`); infinite
    with fewer than 3 pairs."""
    p_est = np.asarray(p_est, np.float64).reshape(-1, 3)
    p_gt = np.asarray(p_gt, np.float64).reshape(-1, 3)
    if p_est.shape[0] < 3:
        return float("inf")
    r, t = umeyama_se3(p_est, p_gt)
    err = p_est @ r.T + t - p_gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))
