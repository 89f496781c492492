"""LIO iterated ESIKF: point-to-plane registration against the voxel map.

Port of `sr_livo_tpu/models/lio.py` (the reference optimizer,
src/optimize.cpp): the residual rows vectorize buildPlaneResiduals
(optimize.cpp:18-131) over all keypoints, and `iekf_update` runs
updateIEKF (optimize.cpp:133-314) as a host loop with the same
information-form Kalman gain and SO(3)/S2 covariance-reset Jacobians.
Each round of the loop is one call of a captured program
(`utils.graphs.Program` over `iteration_fn`: the residual rows, their
normal equations and the 17x17 update), where the JAX package keeps the
whole loop in one jitted program as a `lax.while_loop`; the host reads
the loop's two flags after each round.
The kNN association and the plane rows go through `ops.plane_fit`'s
fused entries: one CUDA kernel launch on CUDA tensors, the plain PyTorch
kNN and plane fit on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
# association) and their iterations (counted by the host loops of
# `iekf_update` and `iekf_iterations`, where they read their flags back);
# host integers.  Callers read differences.
counts = {"updates": 0, "iterations": 0}


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


class IekfIterate(NamedTuple):
    """The state of the IEKF iteration program (the buffers it updates):
    the iterate's nominal state packed as [p, q, v, ba, bg, g] (19,) and
    the final-covariance candidate (17, 17)."""
    x: torch.Tensor
    cov_final: torch.Tensor


class AssocRows(NamedTuple):
    """Inputs of the cached-association residual rows: the association at
    the starting pose (`knn_plane_assoc`) and the keypoints."""
    normal0: torch.Tensor
    a2d: torch.Tensor
    closest: torch.Tensor
    n_found: torch.Tensor
    location: torch.Tensor       # (Q, 3) keypoints in the IMU frame
    keypts_valid: torch.Tensor
    last_trans: torch.Tensor


class SearchRows(NamedTuple):
    """Inputs of the per-iteration search (`knn_plane_rows`)."""
    voxel_map: vm.VoxelMap
    keypts_raw: torch.Tensor
    keypts_valid: torch.Tensor
    last_trans: torch.Tensor
    r_il: torch.Tensor
    t_il: torch.Tensor
    threshold_capacity: torch.Tensor


class IekfInputs(NamedTuple):
    pred_x: torch.Tensor         # (19,) the prediction prior, packed
    cov0: torch.Tensor           # (17, 17) the prior covariance
    rows: tuple                  # AssocRows or SearchRows


class IterationOut(NamedTuple):
    """What one iteration gives the host loop, and the uncapped rows of
    its residuals (the kernel's output in the search mode)."""
    flags: torch.Tensor          # (2,) bool: [enough residuals, converged]
    num: torch.Tensor            # () int32 residual count
    h_x: torch.Tensor
    h: torch.Tensor
    good: torch.Tensor


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


def _assoc_rows(inp: AssocRows, s: EskfState, *, lam_w, lam_nb,
                power_planarity, max_dist_to_plane, min_number_neighbors,
                **_):
    n = inp.location.shape[0]
    world = lie.quat_rotate(s.q.expand(n, 4), inp.location) + s.p
    return plane_fit.plane_rows_from_assoc(
        inp.normal0, inp.a2d, inp.closest, inp.n_found, world, inp.location,
        lie.quat_to_rot(s.q), inp.last_trans, inp.keypts_valid,
        lam_w=lam_w, lam_nb=lam_nb, power_planarity=power_planarity,
        max_dist=max_dist_to_plane, min_neighbors=min_number_neighbors)


def _search_rows(inp: SearchRows, s: EskfState, *, lam_w, lam_nb,
                 size_voxel_map, nb_voxels_visited, max_number_neighbors,
                 min_number_neighbors, power_planarity, max_dist_to_plane,
                 max_probe, **_):
    location = inp.keypts_raw @ inp.r_il.T + inp.t_il          # IMU frame
    world = lie.quat_rotate(s.q.expand(location.shape[0], 4),
                            location) + s.p
    return plane_fit.knn_plane_rows(
        inp.voxel_map, world, location, lie.quat_to_rot(s.q),
        inp.last_trans, inp.keypts_valid, inp.threshold_capacity,
        voxel_size=size_voxel_map, max_neighbors=max_number_neighbors,
        max_probe=max_probe, nb_voxels=nb_voxels_visited, lam_w=lam_w,
        lam_nb=lam_nb, power_planarity=power_planarity,
        max_dist=max_dist_to_plane, min_neighbors=min_number_neighbors)


def iteration_fn(cache_association: bool, **statics):
    """The IEKF iteration program's function (`utils.graphs.Program`):
    the residual rows at the iterate, their normal equations and the
    17x17 update (`iekf_iteration`).  fn(IekfIterate, IekfInputs) ->
    (IekfIterate, IterationOut).  It is the body of one round of the
    JAX package's IEKF `while_loop` (sr_livo_tpu/models/lio.py:400)."""
    rows_of = _assoc_rows if cache_association else _search_rows
    step = {k: statics[k] for k in (
        "min_number_neighbors", "threshold_translation_norm",
        "threshold_orientation_norm", "laser_point_cov",
        "check_convergence")}

    def fn(state: IekfIterate, inputs: IekfInputs):
        s = unpack_state(state.x)
        h_x, h, good = rows_of(inputs.rows, s, **statics)
        res = _cap_residuals(h_x, h, good, statics["max_num_residuals"])
        hth, hth_h = normal_sums(res.h_x, res.h)
        s_new, cov_final, flags = iekf_iteration(
            s, unpack_state(inputs.pred_x), inputs.cov0,
            hth.to(res.h_x.dtype), hth_h.to(res.h_x.dtype), res.num,
            state.cov_final, **step)
        return (IekfIterate(pack_state(s_new), cov_final),
                IterationOut(flags, res.num, h_x, h, good))
    return fn


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
                seed_q=None, seed_p=None, programs: Optional[dict] = None):
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

    Each iteration is one call of the iteration program
    (`iteration_fn`): a CUDA graph replay on the card, the function run
    directly on the CPU.  `programs` caches the programs by their static
    arguments and shapes (a `LioEngine` keeps one dict, as the JAX
    package keeps its jitted steps; without it the call captures its
    own).  The program's buffers are updated in place: the iterate, and
    the inputs copied in at the start of the update.  In the search mode
    the map is read where it lies: the program is captured on the map's
    tensors (which `voxel_map.insert` updates in place) and captured
    again when a new map comes (eviction's `compact_map`, a backend
    rebuild, a checkpoint load), rather than copying the map.

    Each iteration reads two flags back to the host to decide whether to
    go on.  Returns (state, IekfSummary).
    """
    counts["updates"] += 1
    pred = state
    if seed_q is not None:
        state = state._replace(q=seed_q, p=seed_p)
    lam_w, lam_nb = _lam(weight_alpha, weight_neighborhood)
    statics = dict(
        size_voxel_map=size_voxel_map, nb_voxels_visited=nb_voxels_visited,
        max_number_neighbors=max_number_neighbors,
        min_number_neighbors=min_number_neighbors,
        power_planarity=power_planarity,
        max_dist_to_plane=max_dist_to_plane, lam_w=lam_w, lam_nb=lam_nb,
        max_num_residuals=max_num_residuals, max_probe=max_probe,
        threshold_translation_norm=threshold_translation_norm,
        threshold_orientation_norm=threshold_orientation_norm,
        laser_point_cov=laser_point_cov,
        check_convergence=check_convergence)

    if cache_association:
        location = keypts_raw @ r_il.T + t_il               # IMU frame
        n = location.shape[0]
        world0 = lie.quat_rotate(state.q.expand(n, 4), location) + state.p
        # keypoints are prefix-compacted (frame.voxel_subsample), so the
        # association only computes the occupied prefix
        assoc = plane_fit.knn_plane_assoc(
            voxel_map, world0, keypts_valid, threshold_voxel_capacity,
            voxel_size=size_voxel_map, max_neighbors=max_number_neighbors,
            max_probe=max_probe, nb_voxels=nb_voxels_visited,
            chunk=query_chunk)
        rows = AssocRows(*assoc, location, keypts_valid, last_trans)
    else:
        rows = SearchRows(voxel_map, keypts_raw, keypts_valid, last_trans,
                          r_il, t_il, threshold_voxel_capacity)
    start = IekfIterate(pack_state(state), pred.cov)
    inputs = IekfInputs(pack_state(pred), pred.cov, rows)

    def owned(inp: IekfInputs) -> IekfInputs:
        # buffers of the program's own: its refills write into them, so
        # they must not be the caller's tensors (`last_trans` is the last
        # solved state's position); the map and the extrinsic are read,
        # never written, and stay the caller's
        r = inp.rows
        if cache_association:
            r = graphs.tree_map(torch.clone, r)
        else:
            r = r._replace(keypts_raw=r.keypts_raw.clone(),
                           keypts_valid=r.keypts_valid.clone(),
                           last_trans=r.last_trans.clone(),
                           threshold_capacity=r.threshold_capacity.clone())
        return IekfInputs(inp.pred_x.clone(), inp.cov0.clone(), r)

    key = (cache_association, keypts_raw.shape[0], keypts_raw.device,
           tuple(sorted(statics.items())))
    programs = {} if programs is None else programs
    prog = programs.get(key)
    if prog is None:
        prog = programs[key] = graphs.Program(
            iteration_fn(cache_association, **statics),
            graphs.tree_map(torch.clone, start), owned(inputs),
            name=f"iekf[{'assoc' if cache_association else 'search'}, "
                 f"nb={nb_voxels_visited}]")
    else:
        if cache_association or graphs.same_leaves(
                prog.inputs.rows.voxel_map, voxel_map):
            graphs.refill(prog.inputs, inputs)
        else:
            prog.rebind(inputs=owned(inputs))
        graphs.refill(prog.state, start)

    it = 0
    while True:
        out = prog()
        it += 1
        counts["iterations"] += 1
        ok, conv = out.flags.tolist()
        if not (it < max_iters + 1 and not conv and ok):
            break
    n_res = out.num.clone()
    if ok:
        # copies: the program's buffers are overwritten by its next call
        x = prog.state.x.clone()
        s = unpack_state(x, state)._replace(cov=prog.state.cov_final.clone())
    else:
        s = state
    summary = IekfSummary(
        success=torch.tensor(ok, device=keypts_raw.device),
        num_residuals=n_res,
        iterations=torch.tensor(it, dtype=torch.int32,
                                device=keypts_raw.device))
    return s, summary


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
                    laser_point_cov: float, check_convergence: bool = True):
    """The iteration loop of updateIEKF (optimize.cpp:133-314) from the
    starting iterate `state` against the prediction prior `pred`, run
    eagerly: the sharded engine's form, whose `normal_equations` holds
    collectives (the single-device engine runs `iekf_update`'s captured
    iteration program).

    `normal_equations(s)` gives the point-to-plane system at iterate `s`:
    (H^T H (6, 6), H^T h (6,), residual count () int32) — psum'd over the
    map mesh by the sharded engine.  Each iteration reads two flags back
    to the host to decide whether to go on, so every value they come from
    must be the same on every rank.  Returns (state, IekfSummary); on
    failure the state is `state`."""
    s, it = state, 0
    cov_final = state.cov
    while True:
        hth, hth_h, num = normal_equations(s)
        s, cov_final, flags = iekf_iteration(
            s, pred, state.cov, hth, hth_h, num, cov_final,
            min_number_neighbors=min_number_neighbors,
            threshold_translation_norm=threshold_translation_norm,
            threshold_orientation_norm=threshold_orientation_norm,
            laser_point_cov=laser_point_cov,
            check_convergence=check_convergence)
        it += 1
        counts["iterations"] += 1
        n_res = num
        ok, conv = flags.tolist()
        if not (it < max_iters + 1 and not conv and ok):
            break

    if ok:
        s = s._replace(cov=cov_final)
    else:
        s = state
    summary = IekfSummary(
        success=torch.tensor(ok, device=cov_final.device), num_residuals=n_res,
        iterations=torch.tensor(it, dtype=torch.int32,
                                device=cov_final.device))
    return s, summary
