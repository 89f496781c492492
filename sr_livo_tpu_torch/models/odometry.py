"""Full per-sweep LIO step: IMU propagation -> undistortion -> subsampling
-> iterated ESIKF -> map insertion.

Port of `sr_livo_tpu/models/odometry.py` (the reference per-measurement
path run() -> process() -> buildFrame() -> stateEstimation(),
lioOptimization.cpp:1428-1584, 1037-1131, 821-893, 992-1035).  The JAX
package runs a sweep as one jitted program per phase with the map
donated (`LioEngine._steps`, sr_livo_tpu/models/odometry.py:286-291);
here `LioEngine.step` runs `_sweep_core` as one `utils.graphs.Program`
per phase: one CUDA graph replay on the card, the function run directly
on the CPU.  Its data-dependent control flow reads nothing back to the
host in a replay: the IEKF iterations are a WHILE node and the
weak-solve retry an IF node (`graphs.while_loop`, `graphs.cond`), so no
dead round and no untaken retry is launched; the insert's gate chunks and
claim rounds are masked rounds up to proven bounds.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch

from sr_livo_tpu_torch.config import (INIT_CONSTANT_VELOCITY,
                                      MOTION_COMP_CONSTANT_VELOCITY,
                                      MOTION_COMP_IMU, LivoConfig)
from sr_livo_tpu_torch.models import eskf as eskf_mod
from sr_livo_tpu_torch.models import lio
from sr_livo_tpu_torch.models.eskf import EskfState, ImuStates
from sr_livo_tpu_torch.ops import frame as frame_ops
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.runtime.measurements import WIRE_QMAX
from sr_livo_tpu_torch.utils import graphs, lie
from sr_livo_tpu_torch.utils.device import resolve_device


class SweepInput(NamedTuple):
    """Padded tensors for one reconstructed sweep."""
    raw_pts: torch.Tensor    # (N, 3) LiDAR-frame points
    t_rel: torch.Tensor      # (N,) seconds from sweep begin
    pt_valid: torch.Tensor   # (N,) bool
    imu_t: torch.Tensor      # (S,) sample time rel. sweep begin (incl. end)
    imu_dt: torch.Tensor     # (S,) integration step
    imu_acc: torch.Tensor    # (S, 3)
    imu_gyr: torch.Tensor    # (S, 3)
    imu_valid: torch.Tensor  # (S,) bool
    do_optimize: torch.Tensor        # () bool — false for the first frame
    threshold_capacity: torch.Tensor  # () int32 — 1 during init frames


class WireSweep(NamedTuple):
    """Wire form of a sweep: three dense buffers.

      pts_q (N, 4) int16 — xyz quantized by `meta[0]` meters/quantum,
        per-point time as a [0, WIRE_QMAX] fraction of `meta[1]`;
        alpha = -1 marks padding (runtime.measurements.pack_sweep)
      imu   (S, 9) f32   — columns [t, dt, acc(3), gyr(3), valid]
      meta  (4,)  f32    — [scale, duration, do_optimize,
                            threshold_capacity]
    """
    pts_q: torch.Tensor
    imu: torch.Tensor
    meta: torch.Tensor


def unpack_wire(w: WireSweep) -> SweepInput:
    alpha = w.pts_q[:, 3].to(torch.float32)
    scale, duration = w.meta[0], w.meta[1]
    return SweepInput(
        raw_pts=w.pts_q[:, :3].to(torch.float32) * scale,
        t_rel=torch.clamp(alpha, min=0.0) * (duration / WIRE_QMAX),
        pt_valid=alpha >= 0,
        imu_t=w.imu[:, 0], imu_dt=w.imu[:, 1], imu_acc=w.imu[:, 2:5],
        imu_gyr=w.imu[:, 5:8], imu_valid=w.imu[:, 8] > 0.5,
        do_optimize=w.meta[2] > 0.5,
        threshold_capacity=w.meta[3].to(torch.int32))


class SweepOutput(NamedTuple):
    state: EskfState
    voxel_map: vm.VoxelMap
    summary: lio.IekfSummary
    frame_pts_world: torch.Tensor   # (F, 3) registered world points
    frame_valid: torch.Tensor       # (F,) bool
    inserted: torch.Tensor          # (F,) bool — stored into the map
    record: torch.Tensor            # (19,) packed per-frame record
    #   [p(3), q(4), v(3), ba(3), bg(3), success, n_residuals, iters]
    route_overflow: torch.Tensor    # () int32 — points dropped by the
    #   sharded engine's fixed routing budgets this sweep (always 0 on the
    #   single-chip engine; counted, never silently truncated)


def pack_record(state: EskfState, summary: lio.IekfSummary) -> torch.Tensor:
    return torch.cat([
        state.p, state.q, state.v, state.ba, state.bg,
        torch.stack([summary.success.to(torch.float32),
                     summary.num_residuals.to(torch.float32),
                     summary.iterations.to(torch.float32)])])


@functools.lru_cache(maxsize=8)
def _subsample_priority(n: int, device: torch.device) -> torch.Tensor:
    """The subsample priority on the device: an upload, so it must be
    cached before a program is captured (`LioEngine.step` makes it)."""
    return torch.as_tensor(frame_ops.subsample_perm(n), device=device)


def _sweep_core(state: EskfState, voxel_map: vm.VoxelMap, sweep: SweepInput,
                noise: torch.Tensor, r_il: torch.Tensor, t_il: torch.Tensor,
                cfg: LivoConfig, phase: str, prev_poses=None) -> SweepOutput:
    """phase: 'init' (frame_id < init_num_frames), 'steady' or
    'steady_dense' (the finer keypoint grid of adaptive_keypoint_density).

    `prev_poses` = ((q1, p1), (q0, p0)) of the last two solved frames —
    only passed when initialization == INIT_CONSTANT_VELOCITY, where the
    IEKF iterate is seeded with the constant-velocity pose extrapolation
    of stateInitialization (lioOptimization.cpp:949-960):
      q_next = q1 q0^-1 q1,  t_next = t1 + q1 q0^-1 (t1 - t0).
    The map is updated in place.  Each numbered step starts a stage
    (predict, deskew, subsample, iekf, insert) that a program captured
    with stage events times on the device (`graphs.mark`)."""
    icp = cfg.icp
    odo = cfg.odometry_options
    sh = cfg.shapes
    is_init = phase == "init"
    sample_voxel = (odo.init_sample_voxel_size if is_init
                    else cfg.dense_sample_voxel_size
                    if phase == "steady_dense"
                    else odo.sample_voxel_size)
    sub_voxel = odo.init_voxel_size if is_init else odo.voxel_size
    nb_voxels = 2 if is_init else icp.voxel_neighborhood
    max_iters = max(15, icp.num_iters_icp) if is_init else icp.num_iters_icp

    last_trans = state.p  # previous sweep's solved position

    # 1. IMU propagation over the sweep; the pre-sweep state is prepended
    #    as imu_states[0] (lioOptimization.cpp:1488-1501).
    pre = state
    graphs.mark("predict")
    state_pred, scan_states = eskf_mod.predict_sweep(
        state, noise, sweep.imu_t, sweep.imu_dt, sweep.imu_acc,
        sweep.imu_gyr, sweep.imu_valid)

    def _prepend(x0, xs):
        return torch.cat([x0[None], xs], dim=0)

    graphs.mark("deskew")
    imu_states = ImuStates(
        t=_prepend(torch.zeros((), dtype=sweep.imu_t.dtype,
                               device=sweep.imu_t.device), sweep.imu_t),
        un_acc=_prepend(lie.quat_to_rot(pre.q) @ (pre.acc_0 - pre.ba),
                        scan_states.un_acc),
        un_gyr=_prepend(pre.gyr_0 - pre.bg, scan_states.un_gyr),
        p=_prepend(pre.p, scan_states.p),
        q=_prepend(pre.q, scan_states.q),
        v=_prepend(pre.v, scan_states.v),
        valid=_prepend(torch.ones((), dtype=torch.bool,
                                  device=sweep.imu_valid.device),
                       scan_states.valid))

    # 2. Motion undistortion to world, then to the end-of-sweep LiDAR frame.
    if odo.motion_compensation == MOTION_COMP_IMU:
        imu_pts = frame_ops.undistort_imu(
            sweep.raw_pts, sweep.t_rel, imu_states, r_il, t_il)
    elif odo.motion_compensation == MOTION_COMP_CONSTANT_VELOCITY:
        imu_pts = frame_ops.undistort_constant(
            sweep.raw_pts, sweep.t_rel, imu_states, r_il, t_il)
    else:
        imu_pts = lie.quat_rotate(
            state_pred.q.expand(sweep.raw_pts.shape[0], 4),
            sweep.raw_pts @ r_il.T + t_il) + state_pred.p
    raw_deskew = frame_ops.to_end_frame(imu_pts, imu_states, r_il, t_il)

    # 3. Voxel-grid subsample to the frame budget (buildFrame:843-848), in
    #    the shuffle-equivalent priority order.
    graphs.mark("subsample")
    frame_raw, frame_valid, _ = frame_ops.voxel_subsample(
        raw_deskew, sweep.pt_valid, sub_voxel, sh.max_frame_points,
        priority=_subsample_priority(sweep.raw_pts.shape[0],
                                     sweep.raw_pts.device))

    # 4. Grid-sample ICP keypoints (optimize, optimize.cpp:428-431).
    key_raw, key_valid, _ = frame_ops.voxel_subsample(
        frame_raw, frame_valid, sample_voxel, sh.max_keypoints)

    # 5. Iterated ESIKF measurement update.
    if prev_poses is not None:
        (q1, p1), (q0, p0) = prev_poses
        q_rel = lie.quat_mul(q1, lie.quat_conj(q0))
        seed_q = lie.quat_normalize(lie.quat_mul(q_rel, q1))
        seed_p = p1 + lie.quat_rotate(q_rel, p1 - p0)
    else:
        seed_q = seed_p = None

    def _update(nb, active=None):
        return lio.iekf_update(
            state_pred, voxel_map, key_raw, key_valid, last_trans,
            r_il, t_il, sweep.threshold_capacity,
            seed_q=seed_q, seed_p=seed_p,
            size_voxel_map=icp.size_voxel_map,
            nb_voxels_visited=nb,
            max_number_neighbors=icp.max_number_neighbors,
            min_number_neighbors=icp.min_number_neighbors,
            power_planarity=icp.power_planarity,
            max_dist_to_plane=icp.max_dist_to_plane_icp,
            weight_alpha=icp.weight_alpha,
            weight_neighborhood=icp.weight_neighborhood,
            max_num_residuals=icp.max_num_residuals,
            max_probe=sh.map_max_probe,
            max_iters=max_iters,
            threshold_translation_norm=icp.threshold_translation_norm,
            threshold_orientation_norm=icp.threshold_orientation_norm,
            laser_point_cov=cfg.laser_point_cov,
            cache_association=cfg.cache_association,
            query_chunk=sh.query_chunk, active=active)

    graphs.mark("iekf")
    # the IEKF's device counts (lio.active_rounds) leave the init phase
    # out: its rounds are not those of the steady step
    with graphs.counting(False) if is_init else contextlib.nullcontext():
        state_upd, summary = _update(nb_voxels)
        if cfg.retry_wider_neighborhood:
            # Failure/weak-solve recovery: re-run once over the widened
            # neighbourhood when the update failed OR solved on fewer than
            # `min_num_residuals` rows (the JAX package's `lax.cond`,
            # sr_livo_tpu/models/odometry.py:237); in a capture, neither
            # its association nor its rounds launch when it is not taken.
            weak = ~(summary.success
                     & (summary.num_residuals >= icp.min_num_residuals))
            state_upd, summary = graphs.cond(
                weak, lambda active: _update(nb_voxels + 1, active),
                (state_upd, summary))

    state_new = eskf_mod.map_state(
        lambda a, b: torch.where(sweep.do_optimize, a, b),
        state_upd, state_pred)
    success = torch.where(sweep.do_optimize, summary.success,
                          torch.ones_like(summary.success))

    # 6. Register the frame at the solved pose and insert into the map
    #    (addPointsToMap, lioOptimization.cpp:520-554); skipped when the ICP
    #    failed (stateEstimation early-returns, :1011-1014).
    graphs.mark("insert")
    frame_world = frame_ops.transform_to_world(
        frame_raw, state_new.q, state_new.p, r_il, t_il)
    voxel_map, inserted = vm.insert(
        voxel_map, frame_world, frame_valid & success,
        icp.size_voxel_map, odo.min_distance_points, sh.map_max_probe,
        budget=sh.max_insert_points, gate_chunk=sh.query_chunk)

    summary = summary._replace(success=success)
    return SweepOutput(state=state_new, voxel_map=voxel_map, summary=summary,
                       frame_pts_world=frame_world, frame_valid=frame_valid,
                       inserted=inserted,
                       record=pack_record(state_new, summary),
                       route_overflow=torch.zeros(
                           (), dtype=torch.int32, device=frame_world.device))


class StepInputs(NamedTuple):
    """The step program's per-sweep inputs."""
    sweep: tuple             # a WireSweep or a SweepInput
    prev_poses: tuple        # ((q1, p1), (q0, p0)), or None


class LioEngine:
    """The per-sweep LIO step on one device (default "cuda").

    Each phase's step is one `utils.graphs.Program` over `_sweep_core`,
    the counterpart of the JAX package's `_steps[phase]` (jitted with the
    map donated): its state is (EskfState, VoxelMap), adopted from the
    first call, its inputs the sweep and the pose seed.  The programs of
    all phases share those buffers, which the step updates IN PLACE; a
    caller that passes another state or map (an eviction's
    `compact_map`, a checkpoint load, the backend's rebuild) has it copied
    in (`graphs.refill`)."""

    def __init__(self, cfg: LivoConfig, device="cuda",
                 dtype=torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        # The port's one TF32 policy: h_x^T h_x over ~1e3 rows and the 17x17
        # inverses of the IEKF lose too much in TF32, so float32 products
        # stay in full float32 (process-wide torch flags).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = dtype
        f = dict(dtype=dtype, device=self.device)
        self.noise = torch.as_tensor(eskf_mod.noise_diag_np(
            cfg.imu_options.acc_cov, cfg.imu_options.gyr_cov,
            cfg.imu_options.b_acc_cov, cfg.imu_options.b_gyr_cov), **f)
        self.r_il = torch.as_tensor(cfg.extrinsics.R_imu_lidar(), **f)
        self.t_il = torch.as_tensor(cfg.extrinsics.t_imu_lidar(), **f)
        self.use_cv_init = (cfg.odometry_options.initialization
                            == INIT_CONSTANT_VELOCITY)
        # The step programs, keyed by phase, association mode, the retry
        # and the static shapes, as the JAX package keys `_steps`.
        self.programs: dict = {}

    def init_state(self) -> EskfState:
        return eskf_mod.init_state(self.cfg.gravity_acc, self.dtype,
                                   self.device)

    def make_map(self) -> vm.VoxelMap:
        sh = self.cfg.shapes
        return vm.make_map(sh.map_capacity, sh.map_voxel_points, self.dtype,
                           self.device)

    def phase(self, frame_id: int, gyr_rate: float = 0.0) -> str:
        if frame_id < self.cfg.odometry_options.init_num_frames:
            return "init"
        if (self.cfg.adaptive_keypoint_density
                and gyr_rate > self.cfg.dense_gyr_threshold):
            return "steady_dense"
        return "steady"

    def step_fn(self, phase: str):
        """The step program's function: fn((EskfState, VoxelMap),
        StepInputs) -> ((EskfState, VoxelMap), SweepOutput without its
        state and map)."""
        cfg, noise, r_il, t_il = self.cfg, self.noise, self.r_il, self.t_il

        def fn(state, inputs: StepInputs):
            sweep = inputs.sweep
            if isinstance(sweep, WireSweep):
                sweep = unpack_wire(sweep)
            out = _sweep_core(state[0], state[1], sweep, noise, r_il, t_il,
                              cfg, phase, prev_poses=inputs.prev_poses)
            return ((out.state, out.voxel_map),
                    out._replace(state=None, voxel_map=None))
        return fn

    def step(self, state: EskfState, voxel_map: vm.VoxelMap, sweep,
             frame_id: int, prev_poses=None,
             gyr_rate: float = 0.0) -> SweepOutput:
        """One sweep.  `sweep` is a SweepInput or a WireSweep on this
        engine's device; `gyr_rate` (host-side mean |gyro|, rad/s) selects
        the dense-keypoint variant with cfg.adaptive_keypoint_density.

        The returned state and map are the program's buffers and its other
        outputs the graph's own tensors: the next step overwrites them, so
        a caller clones what it keeps past it."""
        if not self.use_cv_init:
            prev_poses = None
        elif prev_poses is None:
            prev_poses = ((state.q, state.p), (state.q, state.p))
        phase = self.phase(frame_id, gyr_rate)
        inputs = StepInputs(sweep, prev_poses)
        key = (phase, self.cfg.cache_association,
               self.cfg.retry_wider_neighborhood, type(sweep).__name__,
               prev_poses is None,
               tuple(tuple(t.shape) for t in graphs.tree_leaves(inputs)))
        n = (sweep.pts_q if isinstance(sweep, WireSweep)
             else sweep.raw_pts).shape[0]
        _subsample_priority(n, self.device)     # uploaded before a capture
        (state, voxel_map), out = graphs.call(
            self.programs, key, self.step_fn(phase), (state, voxel_map),
            inputs, name=f"lio_step[{phase}]")
        return out._replace(state=state, voxel_map=voxel_map)
