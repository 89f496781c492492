# Trimmed copy of sr_livo_tpu_torch/pipeline.py at commit f22c487785a4:
# part of the benchmark's plain reference (livo_bench/check.py).  Later
# changes to the port do not change it.
"""LIVO pipeline orchestrator (port of `sr_livo_tpu/pipeline.py`).

Owns the sweep cutter, the IMU initializer, the LIO engine and, when a
vision module is attached, the camera ESIKFs and the colored map; the host
cuts and pads the streams, every sweep runs on one device.  The copy
keeps the per-frame path alone: the port's eviction, mapping backend,
output files, checkpoints, frame retirement and feeder thread are left
out, and its stage timers do nothing.

Reference topology: lioOptimization::run()/process()
(src/lioOptimization.cpp:1428-1584, 1037-1131).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from livo_bench.ref.config import LivoConfig
from livo_bench.ref.models import eskf as eskf_mod
from livo_bench.ref.models.odometry import LioEngine, SweepInput, WireSweep
from livo_bench.ref.runtime import measurements as meas_mod


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


class NoTimers:
    """The port's stage timers' interface, timing nothing."""

    def stage(self, name: str):
        return contextlib.nullcontext()

    def synchronize(self) -> None:
        pass


def _records_from_rows(pending, rows) -> List[FrameRecord]:
    return [FrameRecord(
        time=t, position=row[0:3], quat_wxyz=row[3:7], velocity=row[7:10],
        ba=row[10:13], bg=row[13:16], success=bool(row[16] > 0.5),
        num_residuals=int(row[17]), iterations=int(row[18]), rendering=rend)
        for (t, rend, _), row in zip(pending, rows)]


class LivoPipeline:
    def __init__(self, cfg: LivoConfig, vision=None, device="cuda"):
        """`vision`: an attached models.vision.VisionModule on the
        pipeline's device, or None."""
        for name in ("enable_map_eviction", "retire_frames", "debug_output"):
            if getattr(cfg, name):
                raise ValueError(f"the plain reference has no {name}")
        self.cfg = cfg
        self.engine = LioEngine(cfg, device=device)
        self.device = self.engine.device
        if vision is not None and vision.device != self.device:
            raise ValueError(f"vision module on {vision.device}, pipeline "
                             f"on {self.device}")
        self.vision = vision
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
        self._last_imu_sample = None
        # last two solved poses for the INIT_CONSTANT_VELOCITY seed
        self._pose_hist: list = []
        self.timers = NoTimers()

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

        self._pending_records.append(
            (meas.time_image, meas.rendering, record))
        self.index_frame += 1

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
