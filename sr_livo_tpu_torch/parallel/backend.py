"""Mapping backend: keyframes, windowed BA, pose graph, loop closures
(port of `sr_livo_tpu/parallel/backend.py`).

Optional subsystem attached to a LivoPipeline.  The backend snapshots
keyframes (pose + subsampled scan) at a fixed spacing, periodically
refines the recent window with windowed BA, accumulates odometry edges in
a pose graph, and folds in verified loop closures; with
`feedback_to_filter` an accepted closure re-anchors the live filter and
rebuilds the frontend map at the loop-consistent poses.
`optimized_trajectory()` returns the loop-consistent path.

Keyframe payloads live in host memory as numpy arrays, as in the JAX
package; they go to the backend's device when a solve needs them.  Host
reads happen where the JAX backend has them: the success flag and the
payload of a new keyframe (every `keyframe_interval`), each BA result,
each verified candidate's fitness and every pose-graph result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from sr_livo_tpu_torch.models import eskf as eskf_mod
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.parallel import ba as ba_mod
from sr_livo_tpu_torch.parallel import loop_closure as lc
from sr_livo_tpu_torch.parallel import pose_graph as pg
from sr_livo_tpu_torch.utils import lie
from sr_livo_tpu_torch.utils.device import resolve_device


@dataclass
class Keyframe:
    time: float
    q: np.ndarray             # (4,) world_from_body
    t: np.ndarray             # (3,)
    points: np.ndarray        # (N, 3) body-frame keypoints (padded)
    valid: np.ndarray         # (N,) bool


@dataclass
class BackendConfig:
    keyframe_interval: float = 0.5       # seconds between keyframes
    window_size: int = 4                 # keyframes per BA window
    ba_every_n_keyframes: int = 4
    ba_voxel_size: float = 0.6
    ba_min_neighbors: int = 8
    loop_radius: float = 2.0
    loop_min_gap: int = 20
    loop_fitness_threshold: float = 0.6
    # min translation observability of a verified closure
    # (ClosureResult.t_observability): rejects plane-sliding alignments
    # that score high fitness at a wrong translation
    loop_min_observability: float = 0.15
    loop_check_every_n: int = 5
    loop_max_pairs: int = 8              # candidates verified per check
    max_keyframe_points: int = 1024
    odometry_rot_w: float = 50.0
    odometry_t_w: float = 50.0
    loop_rot_w: float = 100.0
    loop_t_w: float = 100.0
    # Feed accepted loop closures back into the live filter through
    # eskf.observe_pose (observePose, eskfEstimator.cpp:232-260).
    feedback_to_filter: bool = False
    feedback_trans_noise: float = 1e-3
    feedback_ang_noise: float = 1e-3
    # Rebuild the frontend voxel map from the keyframe payloads at their
    # loop-consistent poses on every feedback event.
    feedback_rebuild_map: bool = True
    # Keyframes beyond the newest this many keep their pose but drop their
    # point payload (skipped as loop candidates); 0 keeps every payload.
    max_keyframe_payloads: int = 0


def _rot(q: np.ndarray) -> np.ndarray:
    """float32 rotation matrix of a float32 quaternion (host math)."""
    return lie.quat_to_rot(torch.as_tensor(q, dtype=torch.float32)).numpy()


def _edge(q_i, t_i, q_j, t_j) -> Tuple[np.ndarray, np.ndarray]:
    """pg.edge_from_poses on host float32 arrays."""
    qr, tr = pg.edge_from_poses(*(torch.as_tensor(a, dtype=torch.float32)
                                  for a in (q_i, t_i, q_j, t_j)))
    return qr.numpy(), tr.numpy()


class MappingBackend:
    def __init__(self, cfg: Optional[BackendConfig] = None, device="cuda"):
        """`device`: where the solves run; the pipeline's device."""
        self.cfg = cfg or BackendConfig()
        self.device = resolve_device(device)
        self.keyframes: List[Keyframe] = []
        self.edges: List[dict] = []      # odometry + loop edges
        self.n_loop_closures = 0
        self.n_verified = 0              # candidates run through verify
        self._last_kf_time = -1e18
        self.ba_runs = 0
        self._pending_feedback = False
        self.n_feedback_applied = 0
        self.n_map_rebuilds = 0

    def _up(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ---- called by the pipeline after each processed frame -------------
    def maybe_add_keyframe(self, pipeline, out, meas):
        if meas.time_image - self._last_kf_time < self.cfg.keyframe_interval:
            return
        if not bool(out.summary.success):
            return
        self._last_kf_time = meas.time_image
        q = out.state.q.cpu().numpy().astype(np.float32)
        t = out.state.p.cpu().numpy().astype(np.float32)
        # body-frame keypoints from the registered world-frame points
        pts_w = out.frame_pts_world.cpu().numpy()
        valid = out.frame_valid.cpu().numpy()
        m = self.cfg.max_keyframe_points
        idx = np.nonzero(valid)[0]
        stride = max(len(idx) // m, 1)
        idx = idx[::stride][:m]
        body = (pts_w[idx] - t) @ _rot(q)
        pts = np.zeros((m, 3), np.float32)
        ok = np.zeros(m, bool)
        pts[:len(idx)] = body
        ok[:len(idx)] = True
        kf = Keyframe(time=meas.time_image, q=q, t=t, points=pts, valid=ok)

        if self.keyframes:
            prev = self.keyframes[-1]
            q_rel, t_rel = _edge(prev.q, prev.t, q, t)
            self.edges.append(dict(
                i=len(self.keyframes) - 1, j=len(self.keyframes),
                q=q_rel, t=t_rel,
                rot_w=self.cfg.odometry_rot_w, t_w=self.cfg.odometry_t_w))
        self.keyframes.append(kf)

        n = len(self.keyframes)
        if (n >= self.cfg.window_size
                and n % self.cfg.ba_every_n_keyframes == 0):
            self._run_window_ba(pipeline.voxel_map)
        if n % self.cfg.loop_check_every_n == 0:
            self._check_loop_closures()
        m = self.cfg.max_keyframe_payloads
        if m > 0 and n > m:
            # condense old keyframes: poses stay, payloads go
            for f in self.keyframes[:n - m]:
                if f.points.shape[0]:
                    f.points = np.zeros((0, 3), np.float32)
                    f.valid = np.zeros((0,), bool)
        if self._pending_feedback and self.cfg.feedback_to_filter:
            self.apply_pose_correction(pipeline)
            self._pending_feedback = False

    # ---- loop-closure feedback into the live filter ----------------------
    def apply_pose_correction(self, pipeline) -> bool:
        """Re-anchor the live ESKF on the loop-consistent trajectory via
        eskf.observe_pose (observePose, eskfEstimator.cpp:232-260).

        Solves the pose graph, takes the rigid correction of the newest
        keyframe (optimized from odometry), composes it onto the
        pipeline's current state and applies it as a direct 6-dof pose
        observation.  Every stored keyframe then takes its optimized pose,
        so the next odometry edge measures actual motion.  With
        `feedback_rebuild_map` the frontend voxel map is rebuilt from the
        keyframe payloads at those poses.  Returns True when a correction
        was applied."""
        if len(self.keyframes) < 2 or not self.edges:
            return False
        _, t_opt, q_opt = self.optimized_trajectory()
        f = self.keyframes[-1]
        state = pipeline.state
        dev = dict(dtype=state.q.dtype, device=state.q.device)
        q_old = torch.as_tensor(f.q, **dev)
        t_old = torch.as_tensor(f.t, **dev)
        q_new = torch.as_tensor(q_opt[-1], **dev)
        t_new = torch.as_tensor(t_opt[-1], **dev)
        # delta = X_new X_old^-1 (world-frame rigid correction)
        q_delta = lie.quat_normalize(lie.quat_mul(q_new,
                                                  lie.quat_conj(q_old)))
        t_delta = t_new - lie.quat_rotate(q_delta, t_old)
        q_target = lie.quat_normalize(lie.quat_mul(q_delta, state.q))
        t_target = lie.quat_rotate(q_delta, state.p) + t_delta
        pipeline.state = eskf_mod.observe_pose(
            state, t_target, q_target,
            trans_noise=self.cfg.feedback_trans_noise,
            ang_noise=self.cfg.feedback_ang_noise)
        for k, kf in enumerate(self.keyframes):
            kf.q = np.asarray(q_opt[k], np.float32)
            kf.t = np.asarray(t_opt[k], np.float32)
        if self.cfg.feedback_rebuild_map:
            self._rebuild_map(pipeline)
        self.n_feedback_applied += 1
        return True

    def _rebuild_map(self, pipeline):
        """A fresh frontend voxel table filled with every retained keyframe
        payload at its (now loop-consistent) stored pose, oldest first, in
        batched inserts of 16 keyframes each; same-voxel rows of one batch
        skip the mutual distance check, as in every batched insert."""
        cfg = pipeline.cfg
        m = vm.make_map(cfg.shapes.map_capacity, cfg.shapes.map_voxel_points,
                        device=pipeline.device)
        icp, odo = cfg.icp, cfg.odometry_options
        group = 16
        rows_per = max((f.points.shape[0] for f in self.keyframes),
                       default=0)
        ws, vs = [], []
        for f in self.keyframes:
            if f.points.shape[0] == 0:
                continue           # condensed payload: region re-observes
            w = np.zeros((rows_per, 3), np.float32)
            v = np.zeros((rows_per,), bool)
            w[:f.points.shape[0]] = f.points @ _rot(f.q).T + f.t
            v[:f.valid.shape[0]] = f.valid
            ws.append(w)
            vs.append(v)
        for g in range(0, len(ws), group):
            chunk = ws[g:g + group]
            pad = group - len(chunk)
            world = np.concatenate(
                chunk + [np.zeros((rows_per, 3), np.float32)] * pad)
            val = np.concatenate(
                vs[g:g + group] + [np.zeros((rows_per,), bool)] * pad)
            m, _ = vm.insert(
                m, torch.as_tensor(world, device=pipeline.device),
                torch.as_tensor(val, device=pipeline.device),
                icp.size_voxel_map, odo.min_distance_points,
                cfg.shapes.map_max_probe)
        pipeline.voxel_map = m
        self.n_map_rebuilds += 1

    # ---- windowed BA over the most recent keyframes ---------------------
    def _run_window_ba(self, voxel_map):
        k = self.cfg.window_size
        kfs = self.keyframes[-k:]
        if any(f.points.shape[0] == 0 for f in kfs):
            return             # condensed payloads in the window
        window = ba_mod.KeyframeWindow(
            q=self._up(np.stack([f.q for f in kfs]), torch.float32),
            t=self._up(np.stack([f.t for f in kfs]), torch.float32),
            points=self._up(np.stack([f.points for f in kfs]),
                            torch.float32),
            pt_valid=self._up(np.stack([f.valid for f in kfs])),
            kf_valid=torch.ones(k, dtype=torch.bool, device=self.device))
        odo = [_edge(a.q, a.t, b.q, b.t) for a, b in zip(kfs[:-1], kfs[1:])]
        q_new, t_new = ba_mod.windowed_ba(
            voxel_map, window,
            self._up(np.stack([e[0] for e in odo])),
            self._up(np.stack([e[1] for e in odo])),
            voxel_size=self.cfg.ba_voxel_size,
            min_neighbors=self.cfg.ba_min_neighbors, iters=2)
        q_new, t_new = q_new.cpu().numpy(), t_new.cpu().numpy()
        for idx, f in enumerate(kfs):
            f.q = q_new[idx]
            f.t = t_new[idx]
        self.ba_runs += 1

    # ---- loop closures ---------------------------------------------------
    def _check_loop_closures(self):
        if len(self.keyframes) < self.cfg.loop_min_gap + 2:
            return
        pos = np.stack([f.t for f in self.keyframes])
        cands = lc.find_candidates(pos, radius=self.cfg.loop_radius,
                                   min_gap=self.cfg.loop_min_gap,
                                   max_pairs=self.cfg.loop_max_pairs)
        existing = {(e["i"], e["j"]) for e in self.edges}
        for (i, j) in cands:
            if (i, j) in existing:
                continue
            fi, fj = self.keyframes[i], self.keyframes[j]
            if fi.points.shape[0] == 0 or fj.points.shape[0] == 0:
                continue       # condensed keyframe: payload retired
            res = lc.verify_closure(
                self._up(fi.points), self._up(fi.valid),
                self._up(fj.points), self._up(fj.valid),
                self._up(fi.q), self._up(fi.t),
                self._up(fj.q), self._up(fj.t))
            self.n_verified += 1
            if (float(res.fitness) >= self.cfg.loop_fitness_threshold
                    and float(res.t_observability)
                    >= self.cfg.loop_min_observability):
                self.edges.append(dict(
                    i=i, j=j, q=res.q_meas.cpu().numpy(),
                    t=res.t_meas.cpu().numpy(),
                    rot_w=self.cfg.loop_rot_w, t_w=self.cfg.loop_t_w))
                self.n_loop_closures += 1
                self._pending_feedback = True

    # ---- global optimization --------------------------------------------
    def optimized_trajectory(self, iters: int = 10
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pose-graph solve over all keyframes; returns (times, t, q)."""
        n = len(self.keyframes)
        times = np.array([f.time for f in self.keyframes])
        if n < 2 or not self.edges:
            return (times, np.stack([f.t for f in self.keyframes]),
                    np.stack([f.q for f in self.keyframes]))
        e = len(self.edges)
        # Node and edge counts padded to power-of-two buckets, as in the
        # JAX package (which compiles one program per shape): the shapes of
        # a solve, and so its results, are the JAX package's.  Padded edges
        # carry zero weight, padded nodes are identity poses that only the
        # damping touches (dx = 0).
        n_pad = 1 << max(int(n - 1).bit_length(), 3)
        e_pad = 1 << max(int(e - 1).bit_length(), 3)
        q_all = np.tile(np.array([1, 0, 0, 0], np.float32), (n_pad, 1))
        t_all = np.zeros((n_pad, 3), np.float32)
        q_all[:n] = np.stack([f.q for f in self.keyframes])
        t_all[:n] = np.stack([f.t for f in self.keyframes])

        def pad1(vals, fill, dtype):
            a = np.full((e_pad,), fill, dtype)
            a[:e] = vals
            return a

        qm = np.tile(np.array([1, 0, 0, 0], np.float32), (e_pad, 1))
        qm[:e] = np.stack([d["q"] for d in self.edges])
        tm = np.zeros((e_pad, 3), np.float32)
        tm[:e] = np.stack([d["t"] for d in self.edges])
        graph = pg.PoseGraph(
            q=self._up(q_all), t=self._up(t_all),
            edge_i=self._up(pad1([d["i"] for d in self.edges], 0, np.int64)),
            edge_j=self._up(pad1([d["j"] for d in self.edges], 0, np.int64)),
            q_meas=self._up(qm), t_meas=self._up(tm),
            rot_w=self._up(pad1([d["rot_w"] for d in self.edges], 0.0,
                                np.float32)),
            t_w=self._up(pad1([d["t_w"] for d in self.edges], 0.0,
                              np.float32)),
            edge_valid=self._up(np.arange(e_pad) < e))
        q, t = pg.optimize_pose_graph(graph, iters=iters)
        return times, t.cpu().numpy()[:n], q.cpu().numpy()[:n]
