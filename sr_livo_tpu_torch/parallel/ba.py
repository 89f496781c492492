"""Windowed bundle adjustment over keyframes (port of
`sr_livo_tpu/parallel/ba.py`).

A sliding window of keyframe poses is jointly refined against the voxel
map with point-to-plane factors plus inter-keyframe odometry priors, by
Gauss-Newton on the banded 6K x 6K normal system (keyframe 0 gauge-fixed).
`windowed_ba` runs on one device (`windowed_ba_program` as one captured
program); `make_sharded_windowed_ba` partitions
the keyframes and the map blocks over the map mesh (parallel.mesh).

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
from sr_livo_tpu_torch.parallel import routing
from sr_livo_tpu_torch.parallel.mesh import Mesh
from sr_livo_tpu_torch.utils import graphs, lie


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


def windowed_ba_program(programs: dict, voxel_map: vm.VoxelMap,
                        window: KeyframeWindow, q_odo: torch.Tensor,
                        t_odo: torch.Tensor, **kw
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`windowed_ba` as one captured program kept in `programs`
    (`utils.graphs.call`; the JAX package's jitted `windowed_ba`,
    sr_livo_tpu/parallel/ba.py:133), keyed by the window's and the map's
    shapes and `kw`.  The live map is the program's state, adopted and
    read in place (the pipeline's map: the step program's buffers), never
    copied.  The same ops as `windowed_ba`, so the same bits on the CPU.
    Returns the program's (q, t), which its next call overwrites."""
    def fn(live_map, inputs):
        return live_map, windowed_ba(live_map, *inputs, **kw)
    key = ("windowed_ba", tuple(window.points.shape),
           tuple(voxel_map.points.shape), tuple(sorted(kw.items())))
    _, (q, t) = graphs.call(
        programs, key, fn, voxel_map, (window, q_odo, t_odo),
        name=f"windowed_ba[{window.points.shape[0]}x"
             f"{window.points.shape[1]}]")
    return q, t


def make_sharded_windowed_ba(mesh: Mesh, n_keyframes: int, *,
                             voxel_size: float, max_neighbors: int = 20,
                             min_neighbors: int = 8, max_probe: int = 16,
                             max_dist: float = 0.5, iters: int = 3,
                             prior_rot_w: float = 100.0,
                             prior_t_w: float = 100.0,
                             damping: float = 1e-3,
                             block_bits: int = 4,
                             route_slack: float = 4.0):
    """Windowed BA with the keyframes and the map blocks partitioned over
    `mesh`, owner-routed like the per-sweep sharded LIO step.  The map is
    each rank's ShardedLioEngine sub-table (block owner WITH voxel
    halos).  Once per Gauss-Newton iteration every keyframe point of this
    rank's keyframe slice goes to the centre-block owner of its current
    world position (one all-to-all), which associates it on its LOCAL
    table (`knn_plane_assoc`, one launch over the routed rows) and adds
    its 6x6/6 normal-equation terms into per-keyframe blocks.  One psum
    assembles the banded system, which every rank solves on the same bits.

    `block_bits` must match the engine's cfg.shapes.map_block_bits;
    `route_slack` sizes the static per-destination budgets against
    spatial density (rows beyond a budget are dropped for that iteration
    and counted: the returned overflow is psum'd over ranks and
    iterations).

    Returns fn(local_map, window, q_odo, t_odo) -> (q (K, 4), t (K, 3),
    route_overflow () int32), to be called on every rank with the same
    window."""
    n_dev = mesh.size
    if n_keyframes % n_dev:
        raise ValueError(f"{n_dev} ranks must divide {n_keyframes} "
                         "keyframes")
    k_local = n_keyframes // n_dev

    def run(local_map: vm.VoxelMap, window: KeyframeWindow, q_odo, t_odo):
        me = mesh.rank
        K, N = window.points.shape[0], window.points.shape[1]
        dev = window.points.device
        total = K * N
        # static routing budgets
        B = min(total, routing.rup(
            int(total / n_dev / n_dev * route_slack) + 32))
        W = min(total, routing.rup(int(total / n_dev * route_slack) + 64))
        # this rank's keyframe slice, flattened to rows
        mine = slice(me * k_local, (me + 1) * k_local)
        pts_l = window.points[mine].reshape(k_local * N, 3)
        val_l = window.pt_valid[mine].reshape(k_local * N)
        kf_l = (me * k_local + torch.arange(
            k_local, dtype=torch.int32, device=dev).repeat_interleave(N))
        threshold = torch.ones((), dtype=torch.int32, device=dev)
        q, t = window.q, window.t
        ovf = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(iters):
            # rows go to the centre-block owner of their CURRENT world
            # position (poses move between iterations)
            world_l = lie.quat_rotate(q[kf_l], pts_l) + t[kf_l]
            dest = routing.shard_of(vm.voxel_coords(world_l, voxel_size),
                                    n_dev, block_bits)
            buf, bval, d = routing.pack_for_exchange(
                dest, val_l, routing.pack_cols(pts_l, kf_l), n_dev, B)
            ovf += d
            rcv, rval = routing.exchange(buf, bval, mesh)
            qrows, qval, d = routing.compact(rcv, rval, W)
            ovf += d
            body_pts = qrows[:, 0:3]
            kf_q = torch.clamp(routing.unpack_col_i32(qrows, 3), 0, K - 1
                               ).to(torch.int64)
            world = (lie.quat_rotate(q[kf_q], body_pts) + t[kf_q]
                     ).contiguous()
            # qval is a prefix (routing.compact): the kernel associates
            # only the routed rows
            normal, a2d, closest, n_found = plane_fit.knn_plane_assoc(
                local_map, world, qval, threshold, voxel_size=voxel_size,
                max_neighbors=max_neighbors, max_probe=max_probe,
                nb_voxels=1)
            enough = n_found >= min_neighbors
            dist = torch.sum(normal * (world - closest), dim=-1)
            w = torch.where(qval & enough & (torch.abs(dist) < max_dist),
                            a2d * a2d, torch.zeros_like(a2d))
            r_q = lie.quat_to_rot(q[kf_q])
            j_rot = -torch.einsum("ni,nij,njk->nk", normal, r_q,
                                  lie.skew(body_pts))
            j = torch.cat([j_rot, normal], dim=-1)                # (W, 6)
            jw = j * w[:, None]
            kf_tgt = torch.where(w > 0, kf_q, K)                 # K: spare
            h_all = torch.zeros((K + 1, 6, 6), dtype=jw.dtype, device=dev)
            h_all.index_add_(0, kf_tgt, torch.einsum("wi,wj->wij", jw, j))
            b_all = torch.zeros((K + 1, 6), dtype=jw.dtype, device=dev)
            b_all.index_add_(0, kf_tgt, jw * dist[:, None])
            h_all = mesh.psum(h_all[:K])
            b_all = mesh.psum(b_all[:K])
            dx = _assemble_and_solve(h_all, b_all, q, t, q_odo, t_odo,
                                     window.kf_valid, prior_rot_w,
                                     prior_t_w, damping)
            q, t = _apply(q, t, dx)
        return q, t, mesh.psum(ovf)

    return run
