"""LIO iterated ESIKF: point-to-plane registration against the voxel map.

Port of `sr_livo_tpu/models/lio.py` (the reference optimizer,
src/optimize.cpp): the residual rows vectorize buildPlaneResiduals
(optimize.cpp:18-131) over all keypoints, and `iekf_update` runs
updateIEKF (optimize.cpp:133-314) with the same information-form Kalman
gain and SO(3)/S2 covariance-reset Jacobians.  Its iteration loop, a
`lax.while_loop` in the JAX package, is `utils.graphs.while_loop`: in the
LIO step program's capture a WHILE node whose body is one round, so a
round after the loop's flag went down is never launched; masked rounds up
to its bound where a round holds a collective.  Either way the program
reads nothing back to the host.
The kNN association and the plane rows go through `ops.plane_fit`'s
fused entries: one CUDA kernel launch on CUDA tensors, the plain PyTorch
kNN and plane fit on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sr_livo_tpu_torch.models import eskf as eskf_mod
from sr_livo_tpu_torch.models.eskf import EskfState
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.utils import graphs, lie


class ResidualBatch(NamedTuple):
    h_x: torch.Tensor        # (Nk, 6) weighted jacobian rows
    h: torch.Tensor          # (Nk,) weighted point-to-plane distances
    valid: torch.Tensor      # (Nk,) bool
    num: torch.Tensor        # () int32 residual count


class IekfSummary(NamedTuple):
    success: torch.Tensor        # () bool
    num_residuals: torch.Tensor  # () int32
    iterations: torch.Tensor     # () int32


# IEKF updates of either engine (counted as each starts, before its
# association) and their iteration rounds; host integers, callers read
# differences.  Inside a captured program (utils.graphs) they count what
# ran: every masked round, the rounds a WHILE node launched and the
# weak-solve retry's update where its IF node took it, the last two
# brought up to date by `graphs.settle_counts()`.
counts = graphs.register_counter({"updates": 0, "iterations": 0})
# The rounds among those whose flag was up (the rounds that did work), on
# the device: counted in programs captured with stage events on
# (`graphs.DeviceCount`), the step's init phase left out.  Against the
# rounds it counted (`active_rounds.added()`, every round up to the
# bound), the share of rounds that were not dead.
active_rounds = graphs.register_device_count(graphs.DeviceCount())
# The rounds the device launched, counted on the device in the same
# programs: every masked round, only the live ones in a WHILE node.
launched_rounds = graphs.register_device_count(graphs.DeviceCount())


def _lam(weight_alpha: float, weight_neighborhood: float):
    lam_sum = abs(weight_alpha) + abs(weight_neighborhood)
    return abs(weight_alpha) / lam_sum, abs(weight_neighborhood) / lam_sum


def chunked_assoc(voxel_map: vm.VoxelMap, world, n_valid, *, voxel_size,
                  max_neighbors, max_probe, nb_voxels, threshold_capacity,
                  chunk):
    """kNN + neighbourhood PCA over only the first `n_valid` rows of
    `world` (port of `models/lio.py::chunked_assoc`; the valid rows are a
    prefix: frame.voxel_subsample and routing.compact emit prefix-compacted
    rows).

    On CPU tensors the plain association runs in `chunk`-row slices over
    the prefix; on CUDA tensors it is one `knn_plane_assoc` launch over all
    rows with the prefix as its mask, and rows past it skip the search in
    the kernel.  Either way compute follows the actual row count, not the
    static budget.  Returns (normal (Q, 3), a2d (Q,), closest (Q, 3),
    n_found (Q,) int32); rows past the processed prefix (the last chunk
    on the CPU, the prefix itself on CUDA) are zero."""
    valid = torch.arange(world.shape[0], device=world.device) < n_valid
    return plane_fit.knn_plane_assoc(
        voxel_map, world, valid, threshold_capacity, voxel_size=voxel_size,
        max_neighbors=max_neighbors, max_probe=max_probe,
        nb_voxels=nb_voxels, chunk=chunk)


def _cap_residuals(h_x, h, good, max_num_residuals) -> ResidualBatch:
    """Residual cap in keypoint order (optimize.cpp:107)."""
    if max_num_residuals > 0:
        prefix = torch.cumsum(good.to(torch.int32), 0)
        good = good & (prefix <= max_num_residuals)
        h_x = torch.where(good[:, None], h_x, torch.zeros_like(h_x))
        h = torch.where(good, h, torch.zeros_like(h))
    return ResidualBatch(h_x=h_x, h=h, valid=good,
                         num=torch.sum(good, dtype=torch.int32))


def _reset_jacobian(d_so3, so3_dg, b_x) -> torch.Tensor:
    """Block-diagonal 17x17 error-reset Jacobian: identity except
    J_so3 = I - 0.5 [d_so3]x on the attitude block and
    J_s2 = I + 0.5 B^T [so3_dg]x B on the gravity block
    (optimize.cpp:213-214, 278-279)."""
    f = dict(dtype=d_so3.dtype, device=d_so3.device)
    j = torch.eye(17, **f)
    j[3:6, 3:6] = torch.eye(3, **f) - 0.5 * lie.skew(d_so3)
    j[15:17, 15:17] = torch.eye(2, **f) + 0.5 * (
        b_x.T @ lie.skew(so3_dg) @ b_x)
    return j


def _error_vs_prediction(state: EskfState, pred: EskfState):
    """d_x (17,) between the current state and the sweep-start prediction,
    plus the S2 helper quantities (optimize.cpp:172-218)."""
    d_p = state.p - pred.p
    d_so3 = lie.quat_to_so3(lie.quat_mul(lie.quat_conj(pred.q), state.q))
    d_v = state.v - pred.v
    d_ba = state.ba - pred.ba
    d_bg = state.bg - pred.bg
    so3_dg = lie.log_so3(lie.rot_from_v1_to_v2(pred.g, state.g))
    b_x_pred = lie.s2_bx(pred.g)
    d_g = b_x_pred.T @ so3_dg
    d_x = torch.cat([d_p, d_so3, d_v, d_ba, d_bg, d_g])
    return d_x, d_so3, so3_dg, b_x_pred


def pack_state(s: EskfState) -> torch.Tensor:
    return torch.cat([s.p, s.q, s.v, s.ba, s.bg, s.g])


def unpack_state(x: torch.Tensor, like: EskfState = None) -> EskfState:
    """Views of a packed (19,) nominal state; cov, acc_0 and gyr_0 come
    from `like` (None without it: the iteration does not read them)."""
    return EskfState(p=x[0:3], q=x[3:7], v=x[7:10], ba=x[10:13],
                     bg=x[13:16], g=x[16:19],
                     cov=None if like is None else like.cov,
                     acc_0=None if like is None else like.acc_0,
                     gyr_0=None if like is None else like.gyr_0)


def iekf_update(state: EskfState, voxel_map: vm.VoxelMap, keypts_raw,
                keypts_valid, last_trans, r_il, t_il,
                threshold_voxel_capacity, *, size_voxel_map: float,
                nb_voxels_visited: int, max_number_neighbors: int,
                min_number_neighbors: int, power_planarity: float,
                max_dist_to_plane: float, weight_alpha: float,
                weight_neighborhood: float, max_num_residuals: int,
                max_probe: int, max_iters: int,
                threshold_translation_norm: float,
                threshold_orientation_norm: float, laser_point_cov: float,
                check_convergence: bool = True,
                cache_association: bool = False, query_chunk: int = 0,
                seed_q=None, seed_p=None, active=None):
    """Iterated EKF measurement update (updateIEKF, optimize.cpp:133-314).

    Runs `max_iters + 1` iterations at most (the reference loops
    i = -1 .. max_num_iter-1), re-associating keypoints against the map each
    iteration, with early exit on |dt| / |dtheta| convergence or when an
    iteration has fewer than `min_number_neighbors` residuals.  The final
    covariance folds the gain and reset Jacobians as
    P+ = J (P - K_x P[0:6,:]) J^T.

    With `cache_association=True` the kNN search and plane PCA run ONCE at
    the starting pose (kernel entry `knn_plane_assoc`; on the CPU over the
    valid prefix in `query_chunk`-row slices); iterations recompute only
    the pose-dependent distances/Jacobians.  Otherwise each iteration runs
    the search (kernel entry `knn_plane_rows`).

    `seed_q`/`seed_p` override the STARTING iterate pose while `state`
    stays the prediction prior (the INIT_CONSTANT_VELOCITY predictor,
    lioOptimization.cpp:895-990).

    The loop is `iekf_iterations`, which reads nothing back to the host
    in capture form.  `active` (a device bool) masks the whole update, as
    the weak-solve retry's branch runs where it is masked (`graphs.cond`):
    where it is down no keypoint is searched and no round does work.
    Returns (state, IekfSummary).
    """
    counts["updates"] += 1
    pred = state
    if seed_q is not None:
        state = state._replace(q=seed_q, p=seed_p)
    lam_w, lam_nb = _lam(weight_alpha, weight_neighborhood)
    if active is not None:
        keypts_valid = keypts_valid & active
    rows_kw = dict(lam_w=lam_w, lam_nb=lam_nb,
                   power_planarity=power_planarity,
                   max_dist=max_dist_to_plane,
                   min_neighbors=min_number_neighbors)
    search_kw = dict(voxel_size=size_voxel_map,
                     max_neighbors=max_number_neighbors, max_probe=max_probe,
                     nb_voxels=nb_voxels_visited)

    location = keypts_raw @ r_il.T + t_il                    # IMU frame
    n = location.shape[0]

    def world_at(s):
        return lie.quat_rotate(s.q.expand(n, 4), location) + s.p

    if cache_association:
        # keypoints are prefix-compacted (frame.voxel_subsample), so the
        # association only computes the occupied prefix
        assoc = plane_fit.knn_plane_assoc(
            voxel_map, world_at(state), keypts_valid,
            threshold_voxel_capacity, chunk=query_chunk, **search_kw)

        def rows(s, _live):
            return plane_fit.plane_rows_from_assoc(
                *assoc, world_at(s), location, lie.quat_to_rot(s.q),
                last_trans, keypts_valid, **rows_kw)
    else:
        def rows(s, live):
            # a dead round searches no keypoint
            return plane_fit.knn_plane_rows(
                voxel_map, world_at(s), location, lie.quat_to_rot(s.q),
                last_trans, keypts_valid & live, threshold_voxel_capacity,
                **search_kw, **rows_kw)

    def normal_equations(s, live):
        res = _cap_residuals(*rows(s, live), max_num_residuals)
        hth, hth_h = normal_sums(res.h_x, res.h)
        return hth.to(res.h_x.dtype), hth_h.to(res.h_x.dtype), res.num

    return iekf_iterations(
        state, pred, normal_equations, go=active,
        min_number_neighbors=min_number_neighbors, max_iters=max_iters,
        threshold_translation_norm=threshold_translation_norm,
        threshold_orientation_norm=threshold_orientation_norm,
        laser_point_cov=laser_point_cov,
        check_convergence=check_convergence)


def normal_sums(h_x: torch.Tensor, h: torch.Tensor):
    """(H^T H, H^T h) of the residual rows in float64; the caller rounds
    them to the rows' type once, after the sharded engine's psum of the
    ranks' partials.

    A deliberate departure from the JAX package, which sums in float32
    (sr_livo_tpu/models/lio.py:360 and its sharded psum).  Products of
    float32 values are exact in float64 and only the float64 additions
    round, so the sums rounded to float32 very likely, though not
    certainly, have the same bits whatever the order of the rows or
    their split over ranks.  float32 sums differ in the last bits with
    the split, and over a long run that moves a map point: the sharded
    engine would no longer track the single-device one."""
    h_x64 = h_x.double()
    return h_x64.T @ h_x64, h_x64.T @ h.double()


def iekf_iteration(s: EskfState, pred: EskfState, cov0, hth, hth_h, num,
                   cov_final, *, min_number_neighbors: int,
                   threshold_translation_norm: float,
                   threshold_orientation_norm: float,
                   laser_point_cov: float, check_convergence: bool = True):
    """One iteration of updateIEKF (optimize.cpp:172-309) from iterate `s`
    against the prediction prior `pred` (with `cov0` the prior
    covariance), given the point-to-plane system at `s`: H^T H (6, 6),
    H^T h (6,) and the residual count.  Returns (next iterate,
    final-covariance candidate, flags (2,) bool [enough, converged]);
    reads nothing back to the host."""
    f = dict(dtype=cov0.dtype, device=cov0.device)
    eye17 = torch.eye(17, **f)
    enough = num >= min_number_neighbors

    d_x_cur, d_so3, so3_dg, b_x_pred = _error_vs_prediction(s, pred)
    j_old = _reset_jacobian(d_so3, so3_dg, b_x_pred)
    d_x_new = j_old @ d_x_cur
    cov = j_old @ cov0 @ j_old.T

    # inv_ex: no error check, so no host read (the JAX package never
    # raises either)
    temp = torch.linalg.inv_ex(cov / laser_point_cov)[0]
    temp[0:6, 0:6] += hth
    temp_inv = torch.linalg.inv_ex(temp)[0]
    k_h = temp_inv[:, 0:6] @ hth_h                       # (17,)
    k_x = torch.zeros((17, 17), **f)
    k_x[:, 0:6] = temp_inv[:, 0:6] @ hth
    d_x = -k_h + (k_x - eye17) @ d_x_new

    # Divergence guard (optimize.cpp:248-251): skip the injection.
    diverged = (torch.linalg.norm(d_x[0:3]) > 100.0) | (
        lie.angular_distance_deg(d_x[3:6]) > 100.0)
    apply = enough & ~diverged
    g_before = s.g
    s = eskf_mod.observe(s, torch.where(apply, d_x, torch.zeros_like(d_x)))
    if check_convergence:
        converged = ((torch.linalg.norm(d_x[0:3]) < threshold_translation_norm)
                     & (lie.angular_distance_deg(d_x[3:6])
                        < threshold_orientation_norm)
                     & apply)
    else:
        converged = torch.zeros((), dtype=torch.bool, device=f["device"])

    # Final covariance candidate from this iteration's quantities
    # (optimize.cpp:272-309): J from the applied d_x and the
    # pre-injection gravity.
    b_x_before = lie.s2_bx(g_before)
    j_new = _reset_jacobian(d_x[3:6], b_x_before @ d_x[15:17], b_x_before)
    cov_final = torch.where(apply, j_new @ (cov - k_x @ cov) @ j_new.T,
                            cov_final)
    return s, cov_final, torch.stack([enough, converged])


def iekf_iterations(state: EskfState, pred: EskfState, normal_equations, *,
                    min_number_neighbors: int, max_iters: int,
                    threshold_translation_norm: float,
                    threshold_orientation_norm: float,
                    laser_point_cov: float, check_convergence: bool = True,
                    go=None, masked: bool = False):
    """The iteration loop of updateIEKF (optimize.cpp:133-314) from the
    starting iterate `state` against the prediction prior `pred`, the
    loop of both engines.

    `normal_equations(s, live)` gives the point-to-plane system at
    iterate `s` in the state's type: (H^T H (6, 6), H^T h (6,), residual
    count () int32); the sharded engine psums it over the map mesh.
    `live` (a device bool) is down in a dead round, whose result is
    dropped, so the function may skip its work there.

    The JAX package's `while_loop` (sr_livo_tpu/models/lio.py:400) as
    `graphs.while_loop` over a device flag "go on", at most `max_iters +
    1` rounds, each keeping its results only where the flag holds: in a
    program's capture on the card a WHILE node, which launches no round
    after the flag went down; masked rounds with `masked` (the sharded
    engine over a process group, whose flag comes from psum'd values, the
    same on every rank, so every rank calls `normal_equations`, and its
    collectives, the same number of times), in capture form elsewhere,
    and eagerly up to where the flag drops.  The iteration count, the
    last round's residual count, the success flag, the covariance and the
    restore of the starting state on a rejected update
    (sr_livo_tpu/models/lio.py:404-406) stay on the device.  `go` (a
    device bool) masks the whole loop: where it is down no round does
    work.  Returns (state, IekfSummary).
    """
    dev = pred.cov.device
    if go is None:
        go = torch.ones((), dtype=torch.bool, device=dev)

    def round_(carry):
        x, cov_final, it, ok, n_res, go = carry
        counts["iterations"] += 1
        launched_rounds.add_one(dev)
        active_rounds.add(go)
        s = unpack_state(x)
        hth, hth_h, num = normal_equations(s, go)
        s_new, cf_new, flags = iekf_iteration(
            s, pred, pred.cov, hth, hth_h, num, cov_final,
            min_number_neighbors=min_number_neighbors,
            threshold_translation_norm=threshold_translation_norm,
            threshold_orientation_norm=threshold_orientation_norm,
            laser_point_cov=laser_point_cov,
            check_convergence=check_convergence)
        x = torch.where(go, pack_state(s_new), x)
        cov_final = torch.where(go, cf_new, cov_final)
        it = it + go.to(torch.int32)
        ok = torch.where(go, flags[0], ok)
        n_res = torch.where(go, num, n_res)
        go = go & (it < max_iters + 1) & ~flags[1] & flags[0]
        return x, cov_final, it, ok, n_res, go

    x, cov_final, it, ok, n_res, _ = graphs.while_loop(
        lambda carry: carry[-1], round_,
        (pack_state(state), pred.cov,
         torch.zeros((), dtype=torch.int32, device=dev),
         torch.ones((), dtype=torch.bool, device=dev),
         torch.zeros((), dtype=torch.int32, device=dev), go),
        max_iters + 1, masked=masked)

    s = unpack_state(x, state)._replace(cov=cov_final)
    s = eskf_mod.map_state(lambda a, b: torch.where(ok, a, b), s, state)
    return s, IekfSummary(success=ok, num_residuals=n_res, iterations=it)
