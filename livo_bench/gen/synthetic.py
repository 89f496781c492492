# Frozen copy of sr_livo_tpu_torch/runtime/synthetic.py at commit f22c487785a4:
# the benchmark's traffic generator (world, trajectory, LiDAR, IMU and camera
# models).  Later changes to the port do not change it.
"""Synthetic LIVO world: deterministic sensor simulation for tests/bench.

An own copy of `sr_livo_tpu/runtime/synthetic.py`: the textured planar
world, the analytic trajectory and the LiDAR / IMU / camera models.  The
LiDAR and IMU streams are numpy, byte for byte those of the JAX package.
Camera images are ray-cast by a torch float64 path on an explicit device
(the counterpart of the JAX package's `use_jax=True` raycaster), which
agrees with the JAX package's numpy renderer to float64 round-off.

The reference validates by replaying rosbags against external ground truth
(SURVEY §4); this module replaces that with a self-contained simulator
producing the exact stream format the pipeline ingests.  Ground truth is
known exactly, enabling closed-loop ATE tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch



def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device (the port's `utils/device.py`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested without CUDA")
    return dev


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
    def __init__(self, rects: Optional[List[Rect]] = None, device=None):
        """With `device` set, `raycast` casts the LiDAR rays in float64 on
        that device (`raycast_torch`; the counterpart of the JAX package's
        `use_jax=True` raycaster): the numpy raycast takes about 0.2 s per
        17600-ray sweep over the gate's 142 rectangles.  Without, it runs
        in numpy, as the JAX package's does."""
        self.device = None if device is None else resolve_device(device)
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
        On a `device`, t is None (the simulator does not read it).
        """
        if self.device is not None:
            f = dict(dtype=torch.float64, device=self.device)
            pts, hit = self.raycast_torch(torch.as_tensor(origins, **f),
                                          torch.as_tensor(dirs, **f))
            return pts.cpu().numpy(), hit.cpu().numpy(), None
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

    def raycast_torch(self, origins: torch.Tensor, dirs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`raycast` on float64 tensors of any device: (points, hit)."""
        f = dict(dtype=torch.float64, device=dirs.device)
        ns, us, vs, cs = (torch.as_tensor(a, **f) for a in (
            self._ns, self._us, self._vs, self._centers))
        denom = dirs @ ns.T                            # (N, R)
        denom = torch.where(torch.abs(denom) < 1e-9,
                            torch.full_like(denom, 1e-9), denom)
        t = ((cs * ns).sum(-1)[None, :] - origins @ ns.T) / denom
        uu = (origins @ us.T + t * (dirs @ us.T)
              - (cs * us).sum(-1)[None, :]) / torch.as_tensor(
                  self._ulen2, **f)[None]
        vv = (origins @ vs.T + t * (dirs @ vs.T)
              - (cs * vs).sum(-1)[None, :]) / torch.as_tensor(
                  self._vlen2, **f)[None]
        ok = (t > 0.1) & (torch.abs(uu) <= 1.0) & (torch.abs(vv) <= 1.0)
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        tb = t.amin(dim=-1)
        hit = torch.isfinite(tb)
        pts = origins + torch.where(hit, tb, torch.zeros_like(tb))[:, None] \
            * dirs
        return pts, hit

    def color(self, pts):
        """Procedural RGB texture in [0, 1], (N, 3), for numpy points (a
        numpy result) or float64 tensors (a tensor on their device).

        Two octaves of trilinear value noise (0.5 m and 0.15 m cells) over
        a low-frequency sinusoid base: rank-2 local structure at LK-window
        scale everywhere, C^1-smooth for subpixel gradients.
        """
        if not torch.is_tensor(pts):
            return self.color(torch.as_tensor(pts, dtype=torch.float64)
                              ).numpy()
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        r = 0.5 + 0.12 * torch.sin(1.3 * x + 0.7 * y)
        g = 0.5 + 0.12 * torch.sin(1.1 * y + 0.5 * z)
        b = 0.5 + 0.12 * torch.sin(0.9 * z + 0.8 * x)
        base = torch.stack([r, g, b], dim=-1)
        tex = (0.30 * _value_noise3(pts, 0.5, 11)
               + 0.18 * _value_noise3(pts, 0.15, 23))
        return torch.clamp(base + tex, 0.02, 0.98)


def _cell_hash3(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor,
                salt: int) -> torch.Tensor:
    """Deterministic per-cell value in [-1, 1], (..., 3) RGB channels.
    int64 products wrap around as numpy's do; only the low 32 bits are
    kept."""
    h = (cx * 73856093 + cy * 19349669 + cz * 83492791 + salt * 374761393)
    out = []
    for mix in (2654435761, 2246822519, 3266489917):
        v = (h * mix) & 0xFFFFFFFF
        v = v ^ (v >> 15)
        v = (v * 2654435761) & 0xFFFFFFFF
        out.append((v & 0xFFFF).to(torch.float64) / 32767.5 - 1.0)
    return torch.stack(out, dim=-1)


def _value_noise3(pts: torch.Tensor, scale: float, salt: int
                  ) -> torch.Tensor:
    """Trilinearly-interpolated 3-D value noise, (..., 3) in [-1, 1]."""
    p = pts / scale
    c0 = torch.floor(p).to(torch.int64)
    f = p - c0
    w = f * f * (3.0 - 2.0 * f)            # smoothstep weights
    acc = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                v = _cell_hash3(c0[..., 0] + dx, c0[..., 1] + dy,
                                c0[..., 2] + dz, salt)
                wx = w[..., 0] if dx else 1.0 - w[..., 0]
                wy = w[..., 1] if dy else 1.0 - w[..., 1]
                wz = w[..., 2] if dz else 1.0 - w[..., 2]
                acc = acc + v * (wx * wy * wz)[..., None]
    return acc


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
    images: list       # (t, image (H, W, 3) float32 or None)
    gt_times: np.ndarray
    gt_pos: np.ndarray
    gt_quat: np.ndarray


def simulate(duration: float = 12.0, *, imu_rate: float = 200.0,
             sweep_rate: float = 10.0, image_rate: float = 10.0,
             n_azimuth: int = 120, n_rings: int = 16,
             lidar_noise: float = 0.004, imu_acc_noise: float = 0.01,
             imu_gyr_noise: float = 0.001,
             acc_bias=(0.05, -0.03, 0.02), gyr_bias=(0.002, -0.001, 0.003),
             image_size: Tuple[int, int] = (0, 0),
             camera=None, image_offset: float = 0.035,
             r_il=None, t_il=None,
             r_ic=None, t_ic=None,
             dist_coeffs=None, cam_time_offset: float = 0.0,
             dirs_phase=None,
             seed: int = 0, world: Optional[SyntheticWorld] = None,
             traj: Optional[Trajectory] = None,
             device="cuda") -> SimStream:
    """Simulate a run.  Returns streams in pipeline ingest format.

    Images are rendered only when image_size != (0, 0), on `device`
    (float64; pass device="cpu" without a GPU); otherwise the image stream
    carries timestamps only, so sweep reconstruction still re-cuts the
    stream at image times.  `image_offset` staggers image timestamps
    against nominal sweep boundaries.

    Calibration dimensions (all exercised by the reference dataset
    profiles, lioOptimization.cpp:362-398):
      * `r_il`/`t_il`   — LiDAR-IMU extrinsic: emitted LiDAR points are in
        the LiDAR frame, point_imu = R_il p_l + t_il (utility.cpp:320-332).
      * `r_ic`/`t_ic`   — camera-IMU extrinsic used for rendering (defaults
        to the CV-convention forward camera of render_image).
      * `dist_coeffs`   — OpenCV radial-tangential distortion
        (k1, k2, p1, p2, k3): images are rendered DISTORTED, exercising
        the pipeline's undistort-rectify path (imageProcessing.cpp:103).
      * `cam_time_offset` — the image stamped t was actually captured at
        t + cam_time_offset (the time_td the 11-dof vision ESIKF
        estimates, imageProcessing.cpp:239).

    For the same arguments the IMU and LiDAR streams and the ground truth
    equal those of the JAX package's `simulate`, byte for byte.
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

    # Camera stream: stamped tc, truly captured at tc + cam_time_offset
    render = image_size[0] > 0 and camera is not None
    if render:
        dirs_cam = _camera_ray_table(camera, image_size, dist_coeffs)
    images = []
    tc = 0.1 + image_offset
    while tc < duration - 0.05:
        images.append((tc, render_image(
            world, traj, tc + cam_time_offset, camera, image_size,
            r_imu_camera=r_ic, t_imu_camera=t_ic, _dirs_cam=dirs_cam,
            device=device) if render else None))
        tc += 1.0 / image_rate

    gt_times = np.arange(0.0, duration, 0.01)
    gt_pos = traj.position(gt_times)
    gt_quat = np.stack([traj.quat(ti) for ti in gt_times])
    return SimStream(imu=imu, lidar_chunks=lidar_chunks, images=images,
                     gt_times=gt_times, gt_pos=gt_pos, gt_quat=gt_quat)


def _undistort_normalized(xd: np.ndarray, yd: np.ndarray, dist,
                          iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Invert the OpenCV radial-tangential model by fixed-point iteration:
    find (x, y) with distort(x, y) == (xd, yd)."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def _camera_ray_table(camera, size: Tuple[int, int],
                      dist_coeffs=None) -> np.ndarray:
    """Unit camera-frame ray per pixel, (H*W, 3) float64.  With
    `dist_coeffs` the pixel grid is interpreted through the OpenCV
    radial-tangential model, so the rendered image is DISTORTED exactly as
    a real lens would produce it (inverse of initUndistortRectifyMap,
    imageProcessing.cpp:103)."""
    h, w = size
    fx, fy, cx, cy = camera
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    xn = (us - cx) / fx
    yn = (vs - cy) / fy
    if dist_coeffs is not None and np.any(np.abs(dist_coeffs) > 1e-12):
        xn, yn = _undistort_normalized(xn.astype(np.float64),
                                       yn.astype(np.float64), dist_coeffs)
    d = np.stack([xn, yn, np.ones_like(xn)], axis=-1) \
        .reshape(-1, 3).astype(np.float64)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def render_image(world: SyntheticWorld, traj: Trajectory, t: float,
                 camera, size: Tuple[int, int],
                 r_imu_camera: Optional[np.ndarray] = None,
                 t_imu_camera: Optional[np.ndarray] = None,
                 dist_coeffs=None,
                 _dirs_cam: Optional[np.ndarray] = None,
                 chunk: int = 1 << 17, device="cuda") -> np.ndarray:
    """Ray-cast an image (H, W, 3) float32 in [0, 1], in float64 on
    `device`.

    `camera` is (fx, fy, cx, cy) for the given size.  The camera frame is
    the standard CV convention (+z forward, +x right, +y down); by default
    it looks along the body +x axis (a typical LiDAR-forward rig).  With
    `dist_coeffs` the output is lens-distorted (see _camera_ray_table).
    Rays are cast in `chunk`-sized batches.
    """
    dev = resolve_device(device)
    h, w = size
    if r_imu_camera is None:
        # camera z -> body x, camera x -> body -y, camera y -> body -z
        r_imu_camera = np.array([[0.0, 0.0, 1.0],
                                 [-1.0, 0.0, 0.0],
                                 [0.0, -1.0, 0.0]])
    else:
        r_imu_camera = np.asarray(r_imu_camera, np.float64).reshape(3, 3)
    if t_imu_camera is None:
        t_imu_camera = np.zeros(3)
    else:
        t_imu_camera = np.asarray(t_imu_camera, np.float64)
    d_cam = (_dirs_cam if _dirs_cam is not None
             else _camera_ray_table(camera, size, dist_coeffs))
    r_wb = traj.rotation(t)
    p_wb = traj.position(t)
    f = dict(dtype=torch.float64, device=dev)
    r_wc = torch.as_tensor(r_wb @ r_imu_camera, **f)
    o_w = torch.as_tensor(r_wb @ t_imu_camera + p_wb, **f)
    d_cam = torch.as_tensor(d_cam, **f)
    cols = []
    for s in range(0, d_cam.shape[0], chunk):
        d_w = d_cam[s:s + chunk] @ r_wc.T
        pts, hit = world.raycast_torch(o_w.expand(d_w.shape[0], 3), d_w)
        cols.append(torch.where(hit[:, None], world.color(pts),
                                torch.zeros_like(pts)))
    return torch.cat(cols).reshape(h, w, 3).to(torch.float32).cpu().numpy()
