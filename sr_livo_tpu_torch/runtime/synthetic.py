"""Synthetic LIVO world: deterministic sensor simulation for tests/bench.

An own copy of the numpy path of `sr_livo_tpu/runtime/synthetic.py`
without camera rendering: the planar world, its ray caster, the analytic
trajectory and the LiDAR / IMU models.

The reference validates by replaying rosbags against external ground truth
(SURVEY §4); this module replaces that with a self-contained simulator: a
planar world, a smooth analytic trajectory, and LiDAR / IMU models
producing the exact stream format the pipeline ingests.
Ground truth is known exactly, enabling closed-loop ATE tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Rect:
    """Finite textured rectangle: origin + two half-axes."""
    center: np.ndarray     # (3,)
    u: np.ndarray          # (3,) half-axis 1 (length = half extent)
    v: np.ndarray          # (3,) half-axis 2
    normal: np.ndarray     # (3,) unit


def _rect(center, u, v) -> Rect:
    center, u, v = (np.asarray(x, np.float64) for x in (center, u, v))
    n = np.cross(u, v)
    n /= np.linalg.norm(n)
    return Rect(center, u, v, n)


def make_room(half: float = 8.0, height: float = 3.0,
              boxes: int = 3, seed: int = 0,
              clear_radius: float = 3.0,
              panels: int = 0) -> List[Rect]:
    """Closed room + interior boxes (rich plane structure) + optional
    wall-mounted tilted PANELS.  Panels matter for forward-cone LiDARs
    (Livox): a bare wall at range constrains only its normal direction —
    ~100 coplanar residuals leave the estimate free to slide laterally —
    while tilted panels inside the cone add independent plane normals.
    Box centers stay `clear_radius` + 0.5 from the origin so the
    trajectory region stays collision-free; panels sit on the walls."""
    h = half
    rects = [
        _rect([0, 0, 0], [h, 0, 0], [0, h, 0]),            # floor
        _rect([0, 0, height], [h, 0, 0], [0, h, 0]),       # ceiling
        _rect([h, 0, height / 2], [0, h, 0], [0, 0, height / 2]),
        _rect([-h, 0, height / 2], [0, h, 0], [0, 0, height / 2]),
        _rect([0, h, height / 2], [h, 0, 0], [0, 0, height / 2]),
        _rect([0, -h, height / 2], [h, 0, 0], [0, 0, height / 2]),
    ]
    rng = np.random.RandomState(seed)
    for _ in range(boxes):
        c = rng.uniform(-h * 0.6, h * 0.6, 2)
        if np.linalg.norm(c) < clear_radius:   # keep trajectory region clear
            c = c / max(np.linalg.norm(c), 1e-6) * (clear_radius + 0.5)
        sx, sy, sz = rng.uniform(0.4, 1.2, 3)
        cx, cy = c
        rects += [
            _rect([cx + sx, cy, sz], [0, sy, 0], [0, 0, sz]),
            _rect([cx - sx, cy, sz], [0, sy, 0], [0, 0, sz]),
            _rect([cx, cy + sy, sz], [sx, 0, 0], [0, 0, sz]),
            _rect([cx, cy - sy, sz], [sx, 0, 0], [0, 0, sz]),
            _rect([cx, cy, 2 * sz], [sx, 0, 0], [0, sy, 0]),
        ]
    # tilted panels mounted just inside the four walls
    for i in range(panels):
        wall = i % 4
        along = rng.uniform(-h * 0.85, h * 0.85)
        zc = rng.uniform(0.5, height - 0.6)
        s1, s2 = rng.uniform(0.5, 1.0, 2)
        tilt = rng.uniform(-0.6, 0.6)          # rad, about the vertical
        lean = rng.uniform(-0.4, 0.4)          # rad, toward the room
        ct, st = np.cos(tilt), np.sin(tilt)
        cl, sl = np.cos(lean), np.sin(lean)
        if wall == 0:      # x = +h wall, faces -x
            c = [h - 0.3, along, zc]
            u = [st * s1, ct * s1, 0.0]
            v = [sl * s2, 0.0, cl * s2]
        elif wall == 1:    # x = -h
            c = [-h + 0.3, along, zc]
            u = [st * s1, ct * s1, 0.0]
            v = [-sl * s2, 0.0, cl * s2]
        elif wall == 2:    # y = +h
            c = [along, h - 0.3, zc]
            u = [ct * s1, st * s1, 0.0]
            v = [0.0, sl * s2, cl * s2]
        else:              # y = -h
            c = [along, -h + 0.3, zc]
            u = [ct * s1, st * s1, 0.0]
            v = [0.0, -sl * s2, cl * s2]
        rects.append(_rect(c, u, v))
    return rects


class SyntheticWorld:
    def __init__(self, rects: Optional[List[Rect]] = None):
        self.rects = rects if rects is not None else make_room()
        self._centers = np.stack([r.center for r in self.rects])
        self._us = np.stack([r.u for r in self.rects])
        self._vs = np.stack([r.v for r in self.rects])
        self._ns = np.stack([r.normal for r in self.rects])
        self._ulen2 = np.sum(self._us ** 2, axis=-1)
        self._vlen2 = np.sum(self._vs ** 2, axis=-1)

    def raycast(self, origins: np.ndarray, dirs: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch ray casting.  origins/dirs: (N, 3).  Returns
        (points (N, 3), hit (N,), t (N,)).

        Formulated entirely as (N, 3) x (3, R) matmuls on 2-D (N, R)
        intermediates:
          uu = ((o + t d) - c) . u / |u|^2
             = (o.u - c.u + t (d.u)) / |u|^2
        """
        ns_t = self._ns.T                              # (3, R)
        denom = dirs @ ns_t                            # (N, R)
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        cn = np.sum(self._centers * self._ns, axis=-1)  # (R,)
        t = (cn[None, :] - origins @ ns_t) / denom
        cu = np.sum(self._centers * self._us, axis=-1)
        cv = np.sum(self._centers * self._vs, axis=-1)
        uu = (origins @ self._us.T + t * (dirs @ self._us.T)
              - cu[None, :]) / self._ulen2[None]
        vv = (origins @ self._vs.T + t * (dirs @ self._vs.T)
              - cv[None, :]) / self._vlen2[None]
        ok = (t > 0.1) & (np.abs(uu) <= 1.0) & (np.abs(vv) <= 1.0)
        t = np.where(ok, t, np.inf)
        best = np.argmin(t, axis=-1)
        tb = t[np.arange(t.shape[0]), best]
        hit = np.isfinite(tb)
        pts = origins + np.where(hit, tb, 0.0)[:, None] * dirs
        return pts, hit, tb


class Trajectory:
    """Smooth analytic trajectory with full IMU observables."""

    def __init__(self, amp=(2.0, 2.0, 0.25), freq=(0.25, 0.17, 0.4),
                 height: float = 1.2, yaw_amp: float = 0.6,
                 yaw_freq: float = 0.2, rp_amp: float = 0.08,
                 start_still: float = 4.5):
        self.amp = np.asarray(amp)
        self.freq = np.asarray(freq) * 2 * np.pi
        self.height = height
        self.yaw_amp = yaw_amp
        self.yaw_freq = yaw_freq * 2 * np.pi
        self.rp_amp = rp_amp
        self.start_still = start_still  # stationary window for IMU init

    def _ramp(self, t):
        """Smooth-step from 0 at start_still to 1 at start_still + 2 s."""
        s = np.clip((t - self.start_still) / 2.0, 0.0, 1.0)
        return s * s * (3 - 2 * s)

    def position(self, t):
        t = np.asarray(t, np.float64)
        r = self._ramp(t)
        base = np.stack([
            self.amp[0] * np.sin(self.freq[0] * t),
            self.amp[1] * np.sin(self.freq[1] * t + 0.6),
            self.height + self.amp[2] * np.sin(self.freq[2] * t),
        ], axis=-1)
        still = np.stack([np.zeros_like(t),
                          self.amp[1] * np.sin(0.6) * np.ones_like(t),
                          self.height * np.ones_like(t)], axis=-1)
        # Blend positions smoothly: p = still + r*(base - still)
        return still + r[..., None] * (base - still)

    def euler(self, t):
        t = np.asarray(t, np.float64)
        r = self._ramp(t)
        yaw = r * self.yaw_amp * np.sin(self.yaw_freq * t)
        pitch = r * self.rp_amp * np.sin(0.9 * t + 0.3)
        roll = r * self.rp_amp * np.sin(1.1 * t + 1.2)
        return roll, pitch, yaw

    def rotation(self, t):
        """R_world_body, (..., 3, 3): Rz(yaw) Ry(pitch) Rx(roll)."""
        roll, pitch, yaw = self.euler(t)
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cy, sy = np.cos(yaw), np.sin(yaw)
        shape = np.shape(yaw) + (3, 3)
        r = np.empty(shape)
        r[..., 0, 0] = cy * cp
        r[..., 0, 1] = cy * sp * sr - sy * cr
        r[..., 0, 2] = cy * sp * cr + sy * sr
        r[..., 1, 0] = sy * cp
        r[..., 1, 1] = sy * sp * sr + cy * cr
        r[..., 1, 2] = sy * sp * cr - cy * sr
        r[..., 2, 0] = -sp
        r[..., 2, 1] = cp * sr
        r[..., 2, 2] = cp * cr
        return r

    def quat(self, t):
        """(w, x, y, z) from rotation matrix (scalar t)."""
        r = self.rotation(t)
        return _rot_to_quat(r)

    def velocity(self, t, eps=1e-4):
        return (self.position(t + eps) - self.position(t - eps)) / (2 * eps)

    def acceleration(self, t, eps=1e-3):
        return ((self.position(t + eps) - 2 * self.position(t)
                 + self.position(t - eps)) / (eps * eps))

    def angular_velocity_body(self, t, eps=1e-4):
        """w_body via numerical differentiation: R(t)^T R(t+eps) ~ exp(w dt)."""
        r0 = self.rotation(t)
        r1 = self.rotation(t + eps)
        dr = np.swapaxes(r0, -1, -2) @ r1
        return _log_rot(dr) / eps


def _rot_to_quat(r):
    w = np.sqrt(max(0.0, 1.0 + r[0, 0] + r[1, 1] + r[2, 2])) / 2.0
    if w > 1e-6:
        x = (r[2, 1] - r[1, 2]) / (4 * w)
        y = (r[0, 2] - r[2, 0]) / (4 * w)
        z = (r[1, 0] - r[0, 1]) / (4 * w)
    else:  # not hit on our smooth trajectories
        x, y, z = 0.0, 0.0, 0.0
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _log_rot(r):
    tr = np.trace(r) if r.ndim == 2 else np.einsum("...ii->...", r)
    c = np.clip((tr - 1) / 2, -1, 1)
    theta = np.arccos(c)
    vee = np.stack([r[..., 2, 1] - r[..., 1, 2],
                    r[..., 0, 2] - r[..., 2, 0],
                    r[..., 1, 0] - r[..., 0, 1]], axis=-1)
    small = theta < 1e-7
    scale = np.where(small, 0.5, theta / (2 * np.maximum(np.sin(theta), 1e-12)))
    return vee * scale[..., None]


def lidar_directions_spinning(n_azimuth: int = 120, n_rings: int = 16,
                              fov_up: float = 15.0, fov_down: float = -15.0,
                              ring_stagger: bool = False):
    """Velodyne-style unit direction table (n_azimuth * n_rings, 3) +
    per-point intra-sweep phase in [0, 1).

    `ring_stagger=True` rotates the within-column ring order by the
    column index (like real staggered channel firing): a column-major
    stream decimated with `point_filter_num` then hits every ring
    round-robin instead of keeping only every k-th ring — without it,
    stream-order decimation by 4 reduces a 16-ring sensor to 4 rings
    and costs vertical observability (measured: 13 cm vs 1 cm ATE on
    the ntu gate world)."""
    az = np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
    el = np.deg2rad(np.linspace(fov_down, fov_up, n_rings))
    azg, elg = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(elg) * np.cos(azg),
                  np.cos(elg) * np.sin(azg),
                  np.sin(elg)], axis=-1).reshape(-1, 3)
    phase = np.repeat(az / (2 * np.pi), n_rings)
    if ring_stagger:
        rows = np.arange(n_azimuth * n_rings).reshape(n_azimuth, n_rings)
        for a in range(n_azimuth):
            rows[a] = np.roll(rows[a], -a)
        order = rows.reshape(-1)
        d = d[order]
        phase = phase[order]
    return d, phase


def lidar_directions_livox(n_az: int = 120, n_el: int = 80,
                           fov_az: float = 35.0, fov_el: float = 38.0):
    """Livox-Avia-style forward cone (+x body axis): a raster over a
    ~70x77 degree FoV with a column-major sweep phase.  Every direction
    has x-components large enough to pass the Livox near-field gate
    (x > 0.7 m, cloudProcessing.cpp:136-143)."""
    az = np.deg2rad(np.linspace(-fov_az, fov_az, n_az))
    el = np.deg2rad(np.linspace(-fov_el, fov_el, n_el))
    azg, elg = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(elg) * np.cos(azg),
                  np.cos(elg) * np.sin(azg),
                  np.sin(elg)], axis=-1).reshape(-1, 3)
    phase = np.repeat((az - az[0]) / (az[-1] - az[0] + 1e-9) * 0.98, n_el)
    return d, phase


@dataclass
class SimStream:
    """All sensor streams for one simulated run."""
    imu: list          # (t, acc, gyr)
    lidar_chunks: list  # (N, 4) arrays
    images: list       # (t, image (H, W, 3) float32) — may be empty
    gt_times: np.ndarray
    gt_pos: np.ndarray
    gt_quat: np.ndarray


def simulate(duration: float = 12.0, *, imu_rate: float = 200.0,
             sweep_rate: float = 10.0, image_rate: float = 10.0,
             n_azimuth: int = 120, n_rings: int = 16,
             lidar_noise: float = 0.004, imu_acc_noise: float = 0.01,
             imu_gyr_noise: float = 0.001,
             acc_bias=(0.05, -0.03, 0.02), gyr_bias=(0.002, -0.001, 0.003),
             image_offset: float = 0.035,
             r_il=None, t_il=None,
             dirs_phase=None,
             seed: int = 0, world: Optional[SyntheticWorld] = None,
             traj: Optional[Trajectory] = None) -> SimStream:
    """Simulate a run.  Returns streams in pipeline ingest format.

    The image stream carries timestamps only (no rendered images), so
    sweep reconstruction still re-cuts the stream at image times;
    `image_offset` staggers them against nominal sweep boundaries.
    `r_il`/`t_il` is the LiDAR-IMU extrinsic: emitted LiDAR points are in
    the LiDAR frame, point_imu = R_il p_l + t_il (utility.cpp:320-332).
    For the same arguments the streams equal those of the JAX package's
    `simulate` without images, byte for byte.
    """
    rng = np.random.RandomState(seed)
    world = world or SyntheticWorld()
    traj = traj or Trajectory()
    g_vec = np.array([0.0, 0.0, 9.81])
    acc_bias = np.asarray(acc_bias)
    gyr_bias = np.asarray(gyr_bias)
    r_il = np.eye(3) if r_il is None else np.asarray(r_il, np.float64)
    t_il = np.zeros(3) if t_il is None else np.asarray(t_il, np.float64)

    # IMU stream
    imu = []
    t = 0.005
    while t < duration:
        r = traj.rotation(t)
        acc = r.T @ (traj.acceleration(t) + g_vec)
        gyr = traj.angular_velocity_body(t)
        imu.append((t, acc + acc_bias + rng.randn(3) * imu_acc_noise,
                    gyr + gyr_bias + rng.randn(3) * imu_gyr_noise))
        t += 1.0 / imu_rate

    # LiDAR stream: continuous scan pattern, chunked per sweep interval
    # (spinning by default; pass dirs_phase=lidar_directions_livox(...)
    # for a Livox-style forward cone)
    dirs, phase = (dirs_phase if dirs_phase is not None
                   else lidar_directions_spinning(n_azimuth, n_rings))
    sweep_T = 1.0 / sweep_rate
    lidar_chunks = []
    t0 = 0.01
    while t0 + sweep_T < duration:
        ts = t0 + phase * sweep_T
        order = np.argsort(ts, kind="stable")
        ts_o = ts[order]
        dirs_o = dirs[order] @ r_il.T          # LiDAR-frame dirs -> body
        rots = traj.rotation(ts_o)
        origins = traj.position(ts_o) + np.einsum("nij,j->ni", rots, t_il)
        dirs_w = np.einsum("nij,nj->ni", rots, dirs_o)
        pts_w, hit, rng_t = world.raycast(origins, dirs_w)
        # vector from the LiDAR center, in body axes, then -> LiDAR frame
        # (point_imu = R_il p_l + t_il, utility.cpp:320-332)
        local = np.einsum("nji,nj->ni", rots, pts_w - origins)
        rr = np.linalg.norm(local, axis=-1, keepdims=True)
        local = local * (1.0 + rng.randn(local.shape[0], 1) * lidar_noise / np.maximum(rr, 0.5))
        local = local @ r_il               # rows: R_il^T v
        chunk = np.concatenate([local[hit], ts_o[hit, None]], axis=-1)
        lidar_chunks.append(chunk)
        t0 += sweep_T

    # image *timestamps* only (sweep alignment still exercised)
    images = []
    tc = 0.1 + image_offset
    while tc < duration - 0.05:
        images.append((tc, None))
        tc += 1.0 / image_rate

    gt_times = np.arange(0.0, duration, 0.01)
    gt_pos = traj.position(gt_times)
    gt_quat = np.stack([traj.quat(ti) for ti in gt_times])
    return SimStream(imu=imu, lidar_chunks=lidar_chunks, images=images,
                     gt_times=gt_times, gt_pos=gt_pos, gt_quat=gt_quat)
