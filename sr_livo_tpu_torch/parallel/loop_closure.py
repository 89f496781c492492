"""Loop-closure detection and verification feeding the pose graph (port
of `sr_livo_tpu/parallel/loop_closure.py`).

Revisit candidates are proposed on the host by trajectory proximity and
verified by point-to-plane Gauss-Newton alignment of the query keyframe's
scan against a temporary voxel map of the target keyframe's scan.  Each
association (8 Gauss-Newton rounds and the fitness pass) is one launch of
the plane kernel's fused entry `plane_fit.knn_plane_assoc` on CUDA
tensors: 9 launches per verified candidate.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from sr_livo_tpu_torch.ops import neighborhood as nb_ops
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.parallel import pose_graph as pg
from sr_livo_tpu_torch.utils import lie


def find_candidates(positions: np.ndarray, *, radius: float = 2.0,
                    min_gap: int = 20, max_pairs: int = 8
                    ) -> List[Tuple[int, int]]:
    """Host-side proximity candidates: keyframe pairs (i, j), i < j,
    within `radius` of each other but at least `min_gap` keyframes apart;
    the best-separated `max_pairs` of them, one per (min_gap / 2)-cell."""
    n = positions.shape[0]
    out = []
    for j in range(n):
        d = np.linalg.norm(positions[:max(j - min_gap, 0)] - positions[j],
                           axis=-1)
        if d.size == 0:
            continue
        i = int(np.argmin(d))
        if d[i] < radius:
            out.append((i, j))
    out.sort(key=lambda ij: ij[1] - ij[0], reverse=True)
    dedup, seen = [], set()
    for (i, j) in out:
        key = (i // max(min_gap // 2, 1), j // max(min_gap // 2, 1))
        if key in seen:
            continue
        seen.add(key)
        dedup.append((i, j))
        if len(dedup) >= max_pairs:
            break
    return dedup


class ClosureResult(NamedTuple):
    q_meas: torch.Tensor         # (4,) q_i^-1 q_j (refined)
    t_meas: torch.Tensor         # (3,) R_i^T (t_j - t_i)
    fitness: torch.Tensor        # () inlier fraction of the aligned scan
    mean_residual: torch.Tensor  # () mean |point-to-plane| of inliers
    # () translation observability: smallest over mean eigenvalue of the
    # inlier-weighted sum of normal outer products; near 0 means the
    # alignment can slide along a direction no plane constrains
    t_observability: torch.Tensor


def _associate(tmp, world, voxel_size, max_probe):
    """(normal, a2d, closest, n_found) of every row of `world` over the 10
    nearest neighbours in `tmp` (every row searched)."""
    everything = torch.ones((world.shape[0],), dtype=torch.bool,
                            device=world.device)
    threshold = torch.ones((), dtype=torch.int32, device=world.device)
    normal, a2d, closest, n_found = plane_fit.knn_plane_assoc(
        tmp, world.contiguous(), everything, threshold,
        voxel_size=voxel_size, max_neighbors=10, max_probe=max_probe,
        nb_voxels=1)
    return normal, a2d, closest, n_found


def verify_closure(points_i: torch.Tensor, valid_i: torch.Tensor,
                   points_j: torch.Tensor, valid_j: torch.Tensor,
                   q_i: torch.Tensor, t_i: torch.Tensor,
                   q_j: torch.Tensor, t_j: torch.Tensor, *,
                   map_capacity: int = 1 << 14, voxel_size: float = 0.5,
                   max_probe: int = 16, iters: int = 8,
                   min_neighbors: int = 6,
                   inlier_dist: float = 0.2) -> ClosureResult:
    """Gauss-Newton-align keyframe j's body-frame scan against a temporary
    map of keyframe i's scan; returns the refined relative edge and its
    fitness.  Reads nothing back to the host but the temporary map's
    claim rounds."""
    f = dict(dtype=points_i.dtype, device=points_i.device)
    world_i = lie.quat_rotate(q_i, points_i) + t_i
    tmp = vm.make_map(map_capacity, 20, device=points_i.device)
    tmp, _ = vm.insert(tmp, world_i, valid_i, voxel_size, 0.0, max_probe)

    skew_j = lie.skew(points_j)
    damp = 1e-4 * torch.eye(6, **f)
    q, t = q_j, t_j
    for _ in range(iters):
        world = lie.quat_rotate(q, points_j) + t
        normal, a2d, closest, n_found = _associate(tmp, world, voxel_size,
                                                   max_probe)
        dist = torch.sum(normal * (world - closest), dim=-1)
        w = torch.where(valid_j & (n_found >= min_neighbors)
                        & (torch.abs(dist) < 1.0), a2d * a2d,
                        torch.zeros_like(a2d))
        r_w = lie.quat_to_rot(q)
        j_rot = -torch.einsum("ni,ij,njk->nk", normal, r_w, skew_j)
        jac = torch.cat([j_rot, normal], dim=-1)
        jw = jac * w[:, None]
        h = jw.T @ jac + damp
        b = jw.T @ dist
        dx = -torch.linalg.solve_ex(h, b).result
        q = lie.quat_normalize(lie.quat_mul(q, lie.exp_so3_quat(dx[0:3])))
        t = t + dx[3:6]

    # fitness of the refined alignment
    world = lie.quat_rotate(q, points_j) + t
    normal, _, closest, n_found = _associate(tmp, world, voxel_size,
                                             max_probe)
    dist = torch.abs(torch.sum(normal * (world - closest), dim=-1))
    usable = valid_j & (n_found >= min_neighbors)
    inlier = usable & (dist < inlier_dist)
    n_inlier = torch.sum(inlier)
    fitness = n_inlier / torch.clamp(torch.sum(usable), min=1)
    mean_res = (torch.sum(torch.where(inlier, dist, torch.zeros_like(dist)))
                / torch.clamp(n_inlier, min=1))
    # translation observability: eigenvalues of the inlier normal scatter
    # (closed form, descending; no solver call, so no host read)
    nw = torch.where(inlier[:, None], normal, torch.zeros_like(normal))
    eigs = nb_ops.eigvals_sym3x3(nw.T @ nw)
    t_obs = eigs[2] / torch.clamp(torch.mean(eigs), min=1e-9)

    q_meas, t_meas = pg.edge_from_poses(q_i, t_i, q, t)
    return ClosureResult(q_meas=q_meas, t_meas=t_meas, fitness=fitness,
                         mean_residual=mean_res, t_observability=t_obs)
