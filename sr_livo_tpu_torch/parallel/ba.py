"""Windowed bundle adjustment over keyframes (port of the single-device
part of `sr_livo_tpu/parallel/ba.py`).

A sliding window of keyframe poses is jointly refined against the voxel
map with point-to-plane factors plus inter-keyframe odometry priors, by
Gauss-Newton on the banded 6K x 6K normal system (keyframe 0 gauge-fixed).

The association (kNN over the live map, neighbourhood PCA, closest
neighbour) is the plane kernel's fused entry `plane_fit.knn_plane_assoc`:
on CUDA tensors one launch per Gauss-Newton iteration over all K x N
window rows.  The kernel associates only the valid prefix of its rows,
while each keyframe's valid rows are a prefix of its own N, so the window
passes an all-true mask and gates with the real validity afterwards, where
the JAX package gates; zero-padded rows get harmless associations.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.utils import lie


class KeyframeWindow(NamedTuple):
    q: torch.Tensor          # (K, 4) world_from_body
    t: torch.Tensor          # (K, 3)
    points: torch.Tensor     # (K, N, 3) body-frame keypoints
    pt_valid: torch.Tensor   # (K, N) bool
    kf_valid: torch.Tensor   # (K,) bool


def _plane_residual_blocks(voxel_map: vm.VoxelMap, q, t, pts, valid, *,
                           voxel_size, max_neighbors, min_neighbors,
                           max_probe, max_dist):
    """Point-to-plane Gauss-Newton blocks of every keyframe of a window:
    q (K, 4), t (K, 3), pts (K, N, 3), valid (K, N) -> (H (K, 6, 6),
    b (K, 6), used rows (K,), loss (K,))."""
    k, n = pts.shape[:2]
    world = lie.quat_rotate(q[:, None, :], pts) + t[:, None, :]   # (K, N, 3)
    flat = world.reshape(k * n, 3).contiguous()
    everything = torch.ones((k * n,), dtype=torch.bool, device=pts.device)
    threshold = torch.ones((), dtype=torch.int32, device=pts.device)
    normal, a2d, closest, n_found = plane_fit.knn_plane_assoc(
        voxel_map, flat, everything, threshold, voxel_size=voxel_size,
        max_neighbors=max_neighbors, max_probe=max_probe, nb_voxels=1)
    normal = normal.reshape(k, n, 3)
    enough = (n_found >= min_neighbors).reshape(k, n)
    dist = torch.sum(normal * (world - closest.reshape(k, n, 3)), dim=-1)
    a2d = a2d.reshape(k, n)
    w = torch.where(valid & enough & (torch.abs(dist) < max_dist),
                    a2d * a2d, torch.zeros_like(a2d))
    # d dist / d [dtheta, dt] with right perturbation on (q, t):
    # world = R p + t ; d world = -R [p]x dtheta + dt
    r_w = lie.quat_to_rot(q)
    j_rot = -torch.einsum("kni,kij,knjl->knl", normal, r_w, lie.skew(pts))
    j = torch.cat([j_rot, normal], dim=-1)                        # (K, N, 6)
    jw = j * w[..., None]
    h = torch.einsum("kni,knj->kij", jw, j)
    b = torch.einsum("kni,kn->ki", jw, dist)
    loss = torch.sum(w * dist * dist, dim=-1)
    return h, b, torch.sum(w > 0, dim=-1), loss


def _assemble_and_solve(h_blocks, b_blocks, q, t, q_odo, t_odo, kf_valid,
                        prior_rot_w, prior_t_w, damping):
    """Banded Gauss-Newton solve: per-keyframe map blocks plus consecutive
    odometry priors, keyframe 0 gauge-fixed.  Returns dx (K, 6)."""
    K = h_blocks.shape[0]
    dim = 6 * K
    f = dict(dtype=h_blocks.dtype, device=h_blocks.device)
    eye3 = torch.eye(3, **f)
    H = torch.zeros((dim, dim), **f)
    b = torch.zeros((dim,), **f)
    for k in range(K):
        H[6 * k:6 * k + 6, 6 * k:6 * k + 6] = h_blocks[k]
        b[6 * k:6 * k + 6] = b_blocks[k]

    # odometry priors between consecutive keyframes:
    # r_rot = log(R_meas^T R_i^T R_j),  r_t = (t_j - t_i) - R_i t_meas
    for k in range(K - 1):
        q_i, q_j = q[k], q[k + 1]
        r_rel = lie.quat_to_rot(lie.quat_mul(lie.quat_conj(q_i), q_j))
        r_meas = lie.quat_to_rot(q_odo[k])
        r_rot = lie.log_so3(r_meas.T @ r_rel)
        r_t = (t[k + 1] - t[k]) - lie.quat_rotate(q_i, t_odo[k])
        # first order: d r_rot/d th_j = I, d r_rot/d th_i = -R_rel^T,
        # d r_t/d t_j = I, d r_t/d t_i = -I, d r_t/d th_i = R_i [t_odo]x
        r_i = lie.quat_to_rot(q_i)
        Ji = torch.zeros((6, 6), **f)
        Jj = torch.zeros((6, 6), **f)
        Ji[0:3, 0:3] = -r_rel.T * prior_rot_w
        Jj[0:3, 0:3] = eye3 * prior_rot_w
        Ji[3:6, 3:6] = -eye3 * prior_t_w
        Ji[3:6, 0:3] = r_i @ lie.skew(t_odo[k]) * prior_t_w
        Jj[3:6, 3:6] = eye3 * prior_t_w
        r6 = torch.cat([r_rot * prior_rot_w, r_t * prior_t_w])
        i, j = slice(6 * k, 6 * k + 6), slice(6 * k + 6, 6 * k + 12)
        H[i, i] = H[i, i] + Ji.T @ Ji
        H[j, j] = H[j, j] + Jj.T @ Jj
        H[i, j] = H[i, j] + Ji.T @ Jj
        H[j, i] = H[j, i] + Jj.T @ Ji
        b[i] = b[i] + Ji.T @ r6
        b[j] = b[j] + Jj.T @ r6

    # gauge fix: clamp keyframe 0
    H[0:6, 0:6] = H[0:6, 0:6] + torch.eye(6, **f) * 1e8
    H = H + torch.eye(dim, **f) * damping
    dx = -torch.linalg.solve_ex(H, b).result.reshape(K, 6)
    return torch.where(kf_valid[:, None], dx, torch.zeros_like(dx))


def _apply(q, t, dx):
    q_new = lie.quat_normalize(lie.quat_mul(q, lie.exp_so3_quat(dx[:, 0:3])))
    return q_new, t + dx[:, 3:6]


def windowed_ba(voxel_map: vm.VoxelMap, window: KeyframeWindow,
                q_odo: torch.Tensor, t_odo: torch.Tensor, *,
                voxel_size: float, max_neighbors: int = 20,
                min_neighbors: int = 8, max_probe: int = 16,
                max_dist: float = 0.5, iters: int = 3,
                prior_rot_w: float = 100.0, prior_t_w: float = 100.0,
                damping: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device windowed BA: `iters` Gauss-Newton iterations, one
    association launch each.  Returns the refined (q (K, 4), t (K, 3))."""
    q, t = window.q, window.t
    for _ in range(iters):
        hs, bs, _, _ = _plane_residual_blocks(
            voxel_map, q, t, window.points, window.pt_valid,
            voxel_size=voxel_size, max_neighbors=max_neighbors,
            min_neighbors=min_neighbors, max_probe=max_probe,
            max_dist=max_dist)
        dx = _assemble_and_solve(hs, bs, q, t, q_odo, t_odo, window.kf_valid,
                                 prior_rot_w, prior_t_w, damping)
        q, t = _apply(q, t, dx)
    return q, t
