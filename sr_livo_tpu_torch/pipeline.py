"""LIVO pipeline orchestrator (port of `sr_livo_tpu/pipeline.py`).

Owns the sweep cutter, the IMU initializer, the LIO engine and, when a
vision module is attached, the camera ESIKFs and the colored map; the host
cuts and pads the streams, every sweep runs on one device.  Optional
long-run parts: far-voxel eviction (`enable_map_eviction`), the mapping
backend (`backend=`), live output files (`stream=`) and checkpoints
(`save_checkpoint` / `load_checkpoint`).

Reference topology: lioOptimization::run()/process()
(src/lioOptimization.cpp:1428-1584, 1037-1131).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models import eskf as eskf_mod
from sr_livo_tpu_torch.models.odometry import LioEngine, SweepInput, WireSweep
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.runtime import checkpoint
from sr_livo_tpu_torch.runtime import measurements as meas_mod
from sr_livo_tpu_torch.runtime import tum
from sr_livo_tpu_torch.runtime.pcd import save_xyz_points
from sr_livo_tpu_torch.utils.profiling import StageTimers


@dataclass
class FrameRecord:
    time: float
    position: np.ndarray
    quat_wxyz: np.ndarray
    velocity: np.ndarray
    ba: np.ndarray
    bg: np.ndarray
    success: bool
    num_residuals: int
    iterations: int
    rendering: bool


def _records_from_rows(pending, rows) -> List[FrameRecord]:
    return [FrameRecord(
        time=t, position=row[0:3], quat_wxyz=row[3:7], velocity=row[7:10],
        ba=row[10:13], bg=row[13:16], success=bool(row[16] > 0.5),
        num_residuals=int(row[17]), iterations=int(row[18]), rendering=rend)
        for (t, rend, _), row in zip(pending, rows)]


class LivoPipeline:
    def __init__(self, cfg: LivoConfig, vision=None, backend=None,
                 stream=None, device="cuda"):
        """`vision`: an attached models.vision.VisionModule, `backend`: a
        parallel.backend.MappingBackend, both on the pipeline's device, or
        None.  `stream`: a runtime.streaming.StreamPublisher that writes
        live pose, path and colored-map files (the reference's publishers,
        lioOptimization.cpp:1186-1384), or None."""
        self.cfg = cfg
        self.engine = LioEngine(cfg, device=device)
        self.device = self.engine.device
        for name, part in (("vision module", vision), ("backend", backend)):
            if part is not None and part.device != self.device:
                raise ValueError(f"{name} on {part.device}, pipeline on "
                                 f"{self.device}")
        self.vision = vision
        self.backend = backend
        self.stream = stream
        self.cutter = meas_mod.SweepCutter(
            cfg.sweep_interval,
            time_diff_enable=cfg.imu_options.time_diff_enable)
        self.initializer = eskf_mod.ImuInitializer(
            float(np.linalg.norm(cfg.gravity_acc)))
        self.state = self.engine.init_state()
        self.voxel_map = self.engine.make_map()
        self.initialized = False
        self.current_time = -1.0
        self._dense_until = -1e18      # adaptive_keypoint_density hold
        self.n_dense_sweeps = 0        # observability: dense-variant picks
        self._trigger_log = []         # (t, gyr_rate, acc_dev) per sweep
        self._init_time = None         # time the filter initialized
        self.index_frame = 1
        # Records stay one packed (19,) device vector per frame and are
        # read back to FrameRecords in one transfer on first read.
        self._records: List[FrameRecord] = []
        self._pending_records: list = []     # (time, rendering, (19,) dev)
        self.n_retired = 0                   # frames retired to disk/stream
        self._evict_dropped = None           # last compact_map's drop count
        self.programs: dict = {}             # the eviction's program
        if cfg.retire_frames and stream is None:
            # retirement appends; start the output files fresh
            os.makedirs(cfg.output_path, exist_ok=True)
            for name in ("pose.txt", "velocity.txt", "bias.txt"):
                open(os.path.join(cfg.output_path, name), "w").close()
        self._last_imu_sample = None
        # last two solved poses for the INIT_CONSTANT_VELOCITY seed
        self._pose_hist: list = []
        self.timers = StageTimers(sync=False, device=self.device)

    # ---- ingest -----------------------------------------------------------
    def push_points(self, pts: np.ndarray):
        self.cutter.push_points(pts)

    def push_imu(self, t: float, acc, gyr):
        self.cutter.push_imu(t, acc, gyr)

    def push_image(self, t: float, image: Optional[np.ndarray]):
        self.cutter.push_image(t, image)

    # ---- processing -------------------------------------------------------
    def process_available(self) -> int:
        """Drain the cutter; returns the number of frames processed."""
        n = 0
        while True:
            meas = self.cutter.get()
            if meas is None:
                return n
            self._process_measurement(meas)
            n += 1

    def process_measurements(self, meas_list, pipelined: bool = True,
                             depth: int = 3) -> int:
        """Process a list of pre-cut measurements; with `pipelined`, a
        feeder thread runs the host preparation (sweep padding, int16 wire
        packing, upload) of frames k+1..k+depth while the main thread runs
        frame k.  Frames before filter initialization run serially (the
        init path is stateful on the filter)."""
        i = 0
        while i < len(meas_list) and not (pipelined and self.initialized):
            self._process_measurement(meas_list[i])
            i += 1
        if i >= len(meas_list):
            return i
        q: queue.Queue = queue.Queue(maxsize=depth)
        err: list = []
        start = self.index_frame

        def _feed():
            try:
                for j, m in enumerate(meas_list[i:]):
                    q.put(self._host_prepare_measurement(m, start + j))
            except BaseException as e:  # surfaced on the main thread
                err.append(e)
            finally:
                q.put(None)

        th = threading.Thread(target=_feed, name="livo-feeder", daemon=True)
        th.start()
        n = i
        while True:
            pf = q.get()
            if pf is None:
                break
            self._dispatch_prepared(pf)
            n += 1
        th.join()
        if err:
            raise err[0]
        return n

    def _process_measurement(self, meas: meas_mod.Measurement):
        if not self._init_or_skip(meas):
            return
        self._dispatch_prepared(
            self._host_prepare_measurement(meas, self.index_frame))

    def _init_or_skip(self, meas: meas_mod.Measurement) -> bool:
        """Static-init bookkeeping; returns True once sweeps should flow
        through the estimation path (run(), lioOptimization.cpp:1438-1486)."""
        if self.current_time < 0:
            self.current_time = meas.time_sweep_begin
        if self.initialized:
            return True
        samples, self.current_time = meas_mod.interpolate_imu(
            meas, self.current_time)
        for (_dt, t, acc, gyr) in samples:
            self.initializer.push(t, acc, gyr)
            self._last_imu_sample = (acc, gyr)
        if self.initializer.ready():
            self.state = self.initializer.build_state(self.state)
            if self._last_imu_sample is not None:
                acc, gyr = self._last_imu_sample
                f = dict(dtype=torch.float32, device=self.device)
                self.state = self.state._replace(
                    acc_0=torch.as_tensor(acc, **f),
                    gyr_0=torch.as_tensor(gyr, **f))
            self.initialized = True
        return False

    # ---- two-phase per-frame path -----------------------------------------
    def _host_prepare_measurement(self, meas: meas_mod.Measurement,
                                  frame_index: int, to_device: bool = True):
        """Numpy sweep and image preparation (feeder-thread safe: touches
        only the cutter-side state `current_time`, never the filter or the
        maps).  With `to_device`, the padded buffers and the image are
        uploaded here too."""
        if to_device:
            def up(x):
                return torch.as_tensor(x, device=self.device)
        else:
            def up(x):
                return x
        thr = (1 if frame_index < self.cfg.icp.init_num_frames
               else self.cfg.icp.threshold_voxel_occupancy)
        if self.cfg.wire_quantization:
            with self.timers.stage("prepare_sweep"):
                imu_pack, wire, new_time, _n = meas_mod.prepare_sweep_wire(
                    meas, self.current_time, self.cfg)
            self.current_time = new_time
            meta = np.array([wire.scale, wire.duration,
                             1.0 if frame_index > 1 else 0.0, thr],
                            np.float32)
            sweep = WireSweep(pts_q=up(wire.pts_q), imu=up(imu_pack),
                              meta=up(meta))
        else:
            with self.timers.stage("prepare_sweep"):
                prep = meas_mod.prepare_sweep(meas, self.current_time,
                                              self.cfg)
            self.current_time = prep.new_current_time
            sweep = SweepInput(
                raw_pts=up(prep.raw_pts), t_rel=up(prep.t_rel),
                pt_valid=up(prep.pt_valid), imu_t=up(prep.imu_t),
                imu_dt=up(prep.imu_dt), imu_acc=up(prep.imu_acc),
                imu_gyr=up(prep.imu_gyr), imu_valid=up(prep.imu_valid),
                do_optimize=up(np.asarray(frame_index > 1)),
                threshold_capacity=up(np.int32(thr)))
        host_img = None
        if (self.vision is not None and meas.rendering
                and meas.image is not None):
            with self.timers.stage("vis_host_prep"):
                img_u8, remapped = self.vision._host_prepare(meas.image)
                host_img = (up(img_u8), remapped)
        return (meas, frame_index, sweep, host_img)

    def _adaptive_gyr_rate(self, meas: meas_mod.Measurement) -> float:
        """Host-side trigger of the dense-keypoint variant
        (LivoConfig.adaptive_keypoint_density)."""
        gyr_rate = float(np.mean(
            [np.linalg.norm(g) for (_t, _a, g) in meas.imu]))
        g_norm = float(np.linalg.norm(self.cfg.gravity_acc))
        acc_dev = float(np.mean(
            [abs(float(np.linalg.norm(a)) - g_norm)
             for (_t, a, _g) in meas.imu]))
        self._trigger_log.append((self.current_time, gyr_rate, acc_dev))
        if self._init_time is None and self.initialized:
            self._init_time = self.current_time
        warm = (self._init_time is not None
                and self.current_time - self._init_time
                < self.cfg.dense_warmup_s)
        if warm or acc_dev > self.cfg.dense_acc_threshold:
            gyr_rate = self.cfg.dense_gyr_threshold + 1.0
        if gyr_rate > self.cfg.dense_gyr_threshold:
            # hold the dense variant through the oscillation dips
            self._dense_until = self.current_time + self.cfg.dense_hold_s
        elif self.current_time < self._dense_until:
            gyr_rate = self.cfg.dense_gyr_threshold + 1.0
        if gyr_rate > self.cfg.dense_gyr_threshold:
            self.n_dense_sweeps += 1
        return gyr_rate

    def _dispatch_prepared(self, prepared):
        meas, frame_index, sweep, host_img = prepared
        if frame_index != self.index_frame:
            raise RuntimeError(f"frame {frame_index} dispatched out of order "
                               f"(expected {self.index_frame})")
        prev_poses = None
        if self.engine.use_cv_init and self._pose_hist:
            prev_poses = (self._pose_hist[-1],
                          self._pose_hist[-2] if len(self._pose_hist) > 1
                          else self._pose_hist[-1])
        gyr_rate = 0.0
        if self.cfg.adaptive_keypoint_density and meas.imu:
            gyr_rate = self._adaptive_gyr_rate(meas)
        with self.timers.stage("lio_step"):
            # one program replay on the card (LioEngine.step); its state,
            # map and outputs are overwritten by the next step, so what
            # outlives this sweep is copied below
            out = self.engine.step(self.state, self.voxel_map, sweep,
                                   self.index_frame, prev_poses=prev_poses,
                                   gyr_rate=gyr_rate)
            self.timers.synchronize()
        self.state = out.state
        self.voxel_map = out.voxel_map
        record = out.record.clone()
        if self.engine.use_cv_init:
            self._pose_hist = (self._pose_hist
                               + [(out.state.q.clone(),
                                   out.state.p.clone())])[-2:]

        if self.cfg.debug_output:
            # per-frame de-skewed world-frame cloud dump
            # (lioOptimization.cpp:1091-1099)
            d = os.path.join(self.cfg.output_path, "cloud_frame")
            os.makedirs(d, exist_ok=True)
            save_xyz_points(out.frame_pts_world.cpu().numpy(),
                            out.frame_valid.cpu().numpy(),
                            os.path.join(d, f"{self.index_frame:06d}.pcd"))

        if (self.cfg.enable_map_eviction
                and self.index_frame % self.cfg.eviction_every_n_frames == 0):
            # Slot-reclaiming eviction (robin_map erase semantics,
            # lioOptimization.cpp:556-572): a fresh table of the near
            # voxels, one program replay that writes it into the map's
            # buffers.  The dropped count stays on the device.
            with self.timers.stage("evict"):
                self.voxel_map, self._evict_dropped = vm.compact_map_program(
                    self.programs, self.voxel_map, self.state.p,
                    distance=self.cfg.odometry_options.max_distance,
                    max_probe=self.cfg.shapes.map_max_probe)
                self.timers.synchronize()

        if self.vision is not None:
            if meas.rendering and meas.image is not None:
                # rendered frame: the colored-map insert of this sweep runs
                # inside the vision frame
                with self.timers.stage("vision_frame"):
                    self.vision.process_frame(self, meas, out,
                                              host_img=host_img)
            else:
                # colored-map leg of addPointsToMap (every sweep,
                # lioOptimization.cpp:538-539)
                with self.timers.stage("color_insert"):
                    self.vision.insert_sweep_points(
                        out.frame_pts_world, out.frame_valid,
                        out.summary.success, meas.time_image)
                    self.timers.synchronize()

        if self.backend is not None:
            with self.timers.stage("backend"):
                self.backend.maybe_add_keyframe(self, out, meas)
                self.timers.synchronize()

        if self.cfg.icp.debug_print:
            # ICP failure diagnostics (optimize.cpp:110-123); reads the
            # packed record back synchronously — debug mode only.
            row = record.double().cpu().numpy()
            if row[16] < 0.5:
                print("[Optimization] Error : not enough keypoints "
                      "selected in ct-icp !\n[Optimization] "
                      f"number_of_residuals : {int(row[17])}")

        self._pending_records.append(
            (meas.time_image, meas.rendering, record))
        if self.stream is not None:
            self.stream.publish_frame(
                meas.time_image, record,
                color_map=(self.vision.color_map
                           if self.vision is not None else None))
        if self.cfg.retire_frames:
            self._maybe_retire()
        self.index_frame += 1

    # ---- frame retirement (keep-2 semantics, lioOptimization.cpp:1101) ----
    def _maybe_retire(self):
        """Bound the live record set like the reference's frame loop: keep
        `num_for_initialization` frames before filter init and 2 afterwards
        (lioOptimization.cpp:1101-1130), appending retired poses to the
        output files in `retire_batch`-sized batches (one device->host
        transfer per batch).  With a StreamPublisher attached the records
        are already mirrored to odometry_live.txt and retired entries are
        dropped."""
        keep = (2 if self.initialized
                else self.cfg.odometry_options.num_for_initialization)
        if len(self._pending_records) < keep + self.cfg.retire_batch:
            # also bound _records if a mid-run .records access moved
            # pending entries there already
            if len(self._records) > keep + self.cfg.retire_batch:
                n_ret = len(self._records) - keep
                self._append_retired(self._records[:n_ret])
                self._records = self._records[n_ret:]
                self.n_retired += n_ret
            return
        n_ret = len(self._pending_records) - keep
        retired = self._pending_records[:n_ret]
        self._pending_records = self._pending_records[n_ret:]
        if self.stream is None:
            self._append_retired(_records_from_rows(retired,
                                                    self._rows(retired)))
        self.n_retired += n_ret

    def _append_retired(self, recs: List[FrameRecord]):
        """recordSinglePose for retired frames (lioOptimization.cpp:
        1133-1172): append TUM pose + velocity + bias lines."""
        out_dir = self.cfg.output_path
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "pose.txt"), "a") as fp, \
                open(os.path.join(out_dir, "velocity.txt"), "a") as fv, \
                open(os.path.join(out_dir, "bias.txt"), "a") as fb:
            for r in recs:
                p, q, v = r.position, r.quat_wxyz, r.velocity
                fp.write(f"{r.time:.9f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                         f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")
                fv.write(f"{r.time:.9f} {v[0]:.9f} {v[1]:.9f} {v[2]:.9f}\n")
                fb.write(f"{r.time:.9f} "
                         f"{r.ba[0]:.9f} {r.ba[1]:.9f} {r.ba[2]:.9f} "
                         f"{r.bg[0]:.9f} {r.bg[1]:.9f} {r.bg[2]:.9f}\n")

    # ---- records (lazy batched device->host materialization) --------------
    @staticmethod
    def _rows(pending) -> np.ndarray:
        return torch.stack([r for (_, _, r) in pending]).double().cpu().numpy()

    @property
    def records(self) -> List[FrameRecord]:
        if self._pending_records:
            self._records.extend(_records_from_rows(
                self._pending_records, self._rows(self._pending_records)))
            self._pending_records = []
        return self._records

    @records.setter
    def records(self, value):
        self._records = list(value)
        self._pending_records = []

    # ---- checkpoint / resume ---------------------------------------------
    def save_checkpoint(self, path: str):
        checkpoint.save_pipeline(self, path)

    def load_checkpoint(self, path: str):
        return checkpoint.load_pipeline(self, path)

    # ---- output -----------------------------------------------------------
    def trajectory(self):
        recs = self.records
        ts = np.array([r.time for r in recs])
        ps = np.stack([r.position for r in recs]) if recs else np.zeros((0, 3))
        qs = np.stack([r.quat_wxyz for r in recs]) if recs else np.zeros((0, 4))
        return ts, ps, qs

    def record_parameters(self, out_dir: Optional[str] = None):
        """parameter_list.txt dump (recordParameters, parameters.cpp:73-164),
        with the JAX package's sections and lines."""
        out_dir = out_dir or self.cfg.output_path
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "parameter_list.txt"), "w") as f:
            for name, dc in (("odometry_options", self.cfg.odometry_options),
                             ("icp_options", self.cfg.icp),
                             ("map_options", self.cfg.map_options),
                             ("imu_parameter", self.cfg.imu_options),
                             ("lidar_parameter", self.cfg.lidar_options),
                             ("shapes", self.cfg.shapes)):
                f.write(f"[{name}]\n")
                for fld in dataclasses.fields(dc):
                    f.write(f"{fld.name}: {getattr(dc, fld.name)}\n")
                f.write("\n")

    def write_outputs(self, out_dir: Optional[str] = None):
        """pose.txt / velocity.txt / bias.txt (recordSinglePose,
        lioOptimization.cpp:1133-1172).  With retire_frames on, retired
        frames were appended at retirement time; this flushes only the
        still-live tail (append into the same files)."""
        out_dir = out_dir or self.cfg.output_path
        os.makedirs(out_dir, exist_ok=True)
        if (self.cfg.retire_frames and self.n_retired and self.stream is None
                and out_dir == self.cfg.output_path):
            self._append_retired(self.records)
            self._records = []
            return
        ts, ps, qs = self.trajectory()
        tum.write_tum(os.path.join(out_dir, "pose.txt"), ts, ps, qs)
        with open(os.path.join(out_dir, "velocity.txt"), "w") as f:
            for r in self.records:
                v = r.velocity
                f.write(f"{r.time:.9f} {v[0]:.9f} {v[1]:.9f} {v[2]:.9f}\n")
        with open(os.path.join(out_dir, "bias.txt"), "w") as f:
            for r in self.records:
                f.write(f"{r.time:.9f} "
                        f"{r.ba[0]:.9f} {r.ba[1]:.9f} {r.ba[2]:.9f} "
                        f"{r.bg[0]:.9f} {r.bg[1]:.9f} {r.bg[2]:.9f}\n")


def run_streams(pipeline: LivoPipeline, stream, chunk_seconds: float = 0.25
                ) -> LivoPipeline:
    """Feed a SimStream (or equivalent) through the pipeline in time order,
    interleaving sensor queues like live ROS ingest would."""
    events = []
    for (t, acc, gyr) in stream.imu:
        events.append((t, "imu", (t, acc, gyr)))
    for chunk in stream.lidar_chunks:
        if chunk.shape[0]:
            events.append((chunk[-1, 3], "pts", chunk))
    for (t, img) in stream.images:
        events.append((t, "img", (t, img)))
    events.sort(key=lambda e: (e[0], e[1]))

    next_drain = chunk_seconds
    for (t, kind, payload) in events:
        if kind == "imu":
            pipeline.push_imu(*payload)
        elif kind == "pts":
            pipeline.push_points(payload)
        else:
            pipeline.push_image(*payload)
        if t >= next_drain:
            pipeline.process_available()
            next_drain = t + chunk_seconds
    pipeline.process_available()
    return pipeline
