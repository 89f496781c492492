"""The benchmark's traffic: one lap of a periodic sensor stream, replayed.

A traffic mix (`livo_bench/traffic/<mix>.json`) names a trajectory, a
LiDAR, the camera and the lap.  `build` simulates, from `seed`, the rig's
IMU, LiDAR and camera streams from the still start (the IMU's static
initialization) through one lap of a trajectory whose every frequency
divides the lap, renders the images on the card, and groups the messages
by frame: frame k's group holds everything a robot's driver has handed
over once image k's sweeps can be cut (its image, the LiDAR packets up to
and including the first one whose points pass the image time, the IMU
samples up to that packet's end).  The LiDAR's rate is a whole multiple
of the camera's; where it is higher, the sweep cutter cuts gap-fill
sweeps without an image between the image-aligned ones, so one frame
yields several sweeps.  `Traffic.frames()` yields the prefix and then the
lap again and again with its stamps shifted by the lap length, so the
stream never runs out.

Frozen from the port at commit f22c487785a4 (later changes to the port do
not change them): the calibrations, the room world and the trajectories
of `sr_livo_tpu_torch/runtime/accuracy_gate.py` (`R3_CALIB`, `NTU_CALIB`,
`_world`, `_traj`, `simulate_profile`), and the Livox driver filter of
`sr_livo_tpu_torch/runtime/native.py::process_livox_numpy`, applied to
each packet as the bag path of the accuracy gate writes and reads it
(`accuracy_gate.write_bag`, `drivers.CloudProcessing.process_livox`).
Frozen from the port at commit 2394058cd569: the spinning driver filter
of `native.py::process_spinning_numpy`, applied packet by packet with the
previous packet's end time carried over, as
`drivers.CloudProcessing.process_cloud` applies it to the gate's Ouster
bags (`accuracy_gate.write_bag`, `bag_writer.ser_pointcloud2_ouster`:
offsets in ns from the packet's stamp, ring = index mod the ring count,
times decoded as `native.decode_xyzt_numpy` does).
The one change: roll and pitch swing at frequencies that divide the lap
(the gate's 0.9 and 1.1 rad/s do not), so the lap's seam is smooth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np
import torch

from livo_bench.gen import synthetic

R3_CALIB = dict(
    intr_full=np.array([863.4241, 863.4171, 640.6808, 518.3392]),
    dist=[-0.1080, 0.1050, -1.2872e-04, 5.7923e-05, -0.0222],
    r_ic=np.array([-0.00113207, -0.0158688, 0.999873,
                   -0.9999999, -0.000486594, -0.00113994,
                   0.000504622, -0.999874, -0.0158682]).reshape(3, 3),
    t_ic=np.array([0.050166, 0.0474116, -0.0312415]),
    size=(512, 640),                  # 1024x1280 at image_scale 0.5
    cam_time_offset=0.006)

NTU_CALIB = dict(
    intr_full=np.array([425.0259, 426.7976, 386.0152, 241.9130]),
    dist=[-0.2881, 0.0746, 7.7845e-04, -2.2779e-04, 0.0],
    r_ic=np.array([0.0218308, -0.0131205, 0.999675,
                   0.999759, 0.00230088, -0.0218024,
                   -0.00201407, 0.999912, 0.0131676]).reshape(3, 3),
    t_ic=np.array([0.0555294, -0.124313, -0.0388531]),
    size=(240, 376),                  # 480x752 at image_scale 0.5
    cam_time_offset=0.004)

CALIBS = {"r3live": R3_CALIB, "ntu": NTU_CALIB}

# the simulator's sensor grids (synthetic.simulate): IMU at 0.005 + i/rate,
# LiDAR packets from 0.01 every 1/rate, images from 0.1 + 0.035
IMU_T0, LIDAR_T0, IMAGE_T0 = 0.005, 0.01, 0.135


class LapTrajectory(synthetic.Trajectory):
    """`synthetic.Trajectory` with roll and pitch at given frequencies
    (Hz), so that a lap that all frequencies divide repeats exactly."""

    def __init__(self, *, rp_freq=(0.15, 0.2), **kw):
        super().__init__(**kw)
        self.pitch_w = 2 * math.pi * rp_freq[0]
        self.roll_w = 2 * math.pi * rp_freq[1]

    def euler(self, t):
        t = np.asarray(t, np.float64)
        r = self._ramp(t)
        yaw = r * self.yaw_amp * np.sin(self.yaw_freq * t)
        pitch = r * self.rp_amp * np.sin(self.pitch_w * t + 0.3)
        roll = r * self.rp_amp * np.sin(self.roll_w * t + 1.2)
        return roll, pitch, yaw


def world(spec: dict, device=None) -> synthetic.SyntheticWorld:
    """The gate's room (`accuracy_gate._world`): boxes and tilted wall
    panels that keep the Livox cone constrained everywhere."""
    return synthetic.SyntheticWorld(synthetic.make_room(**spec), device=device)


def livox_filter(xyz: np.ndarray, tag: np.ndarray, line: np.ndarray,
                 offset_ns: np.ndarray, n_scans: int, point_filter_num: int,
                 blind: float, header_time: float) -> np.ndarray:
    """The Livox driver's point filter (`native.process_livox_numpy`):
    validity, the near-field and tag gates, duplicates, time order,
    decimation by `point_filter_num` and the blind range.  Returns the
    (m, 4) float64 points with absolute times."""
    xyz = np.asarray(xyz, np.float32)
    tag = np.asarray(tag, np.uint8)
    line = np.asarray(line)
    n = xyz.shape[0]
    if n < 2:
        return np.zeros((0, 4))
    i = np.arange(1, n)
    p = xyz[i]
    ok = (line[i] < n_scans) & (np.abs(p) <= np.float32(1e8)).all(axis=-1)
    ok &= p[:, 0] > np.float32(0.7)
    bad_tag = ((tag[i] & 0x03) != 0) | ((tag[i] & 0x0C) != 0)
    ok &= ~((p[:, 0] > np.float32(2.0)) & bad_tag)
    ok &= ~np.all(np.abs(p - xyz[i - 1]) <= np.float32(1e-7), axis=-1)
    sel = i[ok]
    t_ms = np.asarray(offset_ns, np.uint32)[sel].astype(np.float64) * 1e-6
    order = np.argsort(t_ms, kind="stable")
    sel, t_ms = sel[order], t_ms[order]
    keep = np.ones(len(sel), bool)
    if point_filter_num > 1:
        keep = np.arange(1, len(sel) + 1) % point_filter_num == 0
    q = xyz[sel].astype(np.float64)
    keep &= (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
             > blind * blind)
    return np.concatenate([q[keep], (header_time + t_ms[keep] / 1000.0)
                           [:, None]], axis=1)


def livox_packet(chunk: np.ndarray, lidar_options) -> np.ndarray:
    """A simulated packet as the Livox driver hands it over: stamped at
    its first point, offsets in whole nanoseconds, six lines, tag 0."""
    stamp = float(chunk[0, 3])
    n = chunk.shape[0]
    t_ns = np.round((chunk[:, 3] - stamp) * 1e9).astype(np.uint32)
    return livox_filter(chunk[:, :3], np.zeros(n, np.uint8),
                        (np.arange(n) % 6).astype(np.uint8), t_ns,
                        lidar_options.n_scans, lidar_options.point_filter_num,
                        lidar_options.blind, stamp)


def spinning_filter(xyzt: np.ndarray, ring, n_scans: int, scan_rate: int,
                    point_filter_num: int, blind: float, header_time: float,
                    given_offset_time: bool, last_end_time: float) -> tuple:
    """The spinning driver's point filter (`native.process_spinning_numpy`):
    per-ring yaw time synthesis where no per-point time is given, time
    sort, decimation by `point_filter_num`, the blind range and the
    monotonic-time gate.  Returns ((m, 4) float64 points with absolute
    times, the new last end time)."""
    xyzt = np.asarray(xyzt, np.float32)
    n = xyzt.shape[0]
    x, y, z = (xyzt[:, j].astype(np.float64) for j in range(3))
    if given_offset_time:
        t_rel = xyzt[:, 3].astype(np.float64)
    else:
        omega = 0.361 * scan_rate
        layer = (np.asarray(ring, np.int64) if ring is not None
                 else np.zeros(n, np.int64))
        # libm's atan2 point by point, as the driver's C++ calls it
        yaw = np.array([math.atan2(b, a) for a, b in zip(x, y)],
                       np.float64).reshape(n) * 57.2957
        t_rel = np.zeros(n)
        for lay in np.unique(layer[(layer >= 0) & (layer < n_scans)]):
            sel = np.nonzero(layer == lay)[0]
            y0 = yaw[sel[0]]
            d = np.where(yaw[sel] <= y0, (y0 - yaw[sel]) / omega,
                         (y0 - yaw[sel] + 360.0) / omega)
            d[0] = 0.0
            t_rel[sel] = d
    order = np.argsort(t_rel, kind="stable")
    dt_last = t_rel[order[-1]] if n else 0.0
    keep = np.ones(n, bool)
    if point_filter_num > 1:
        keep = np.arange(n) % point_filter_num == 0
    o = order
    ts = header_time + t_rel[o] / 1000.0
    keep &= ((x[o] * x[o] + y[o] * y[o] + z[o] * z[o] > blind * blind)
             & (ts > last_end_time))
    out = np.stack([x[o], y[o], z[o], ts], axis=1)[keep]
    return out, header_time + dt_last / 1000.0


# the driver's time_unit -> milliseconds a unit (drivers.CloudProcessing)
TIME_UNIT_MS = {0: 1e3, 1: 1.0, 2: 1e-3, 3: 1e-6}


def ouster_packet(chunk: np.ndarray, lidar_options, n_rings: int,
                  last_end_time: float) -> tuple:
    """A simulated packet as the Ouster driver hands it over: stamped at
    its first point, offsets in whole nanoseconds (field `t`, decoded to
    float32 milliseconds), ring = index mod `n_rings`.  Returns (points,
    the new last end time)."""
    stamp = float(chunk[0, 3])
    n = chunk.shape[0]
    t_ns = np.round((chunk[:, 3] - stamp) * 1e9).astype(np.uint32)
    xyzt = np.empty((n, 4), np.float32)
    xyzt[:, :3] = chunk[:, :3].astype(np.float32)
    xyzt[:, 3] = t_ns.astype(np.float64) * TIME_UNIT_MS.get(
        lidar_options.time_unit, 1.0)
    # a per-point time counts as given where the last point's is above 0;
    # else the driver takes the ring field and synthesizes times by yaw
    given = bool(xyzt[-1, 3] > 0)
    ring = None if given else (np.arange(n) % n_rings).astype(np.int32)
    return spinning_filter(xyzt, ring, lidar_options.n_scans,
                           lidar_options.scan_rate,
                           lidar_options.point_filter_num,
                           lidar_options.blind, stamp, given, last_end_time)


def lidar_packets(chunks: list, lidar: dict, lidar_options) -> list:
    """(index of the chunk on the LiDAR's packet grid, filtered points) of
    every packet that keeps a point, through the mix's driver."""
    out = []
    last_end = -1.0
    for j, c in enumerate(chunks):
        if not c.shape[0]:
            continue               # nothing is handed over
        if lidar["kind"] == "livox":
            pts = livox_packet(c, lidar_options)
        else:
            pts, last_end = ouster_packet(c, lidar_options,
                                          lidar["n_rings"], last_end)
        if pts.shape[0]:
            out.append((j, pts))
    return out


def lidar_directions(lidar: dict) -> tuple:
    """The mix's LiDAR as a direction table and each ray's sweep phase."""
    if lidar["kind"] == "livox":
        return synthetic.lidar_directions_livox(lidar["n_az"], lidar["n_el"])
    if lidar["kind"] == "ouster":
        return synthetic.lidar_directions_spinning(
            lidar["n_az"], lidar["n_rings"],
            ring_stagger=lidar["ring_stagger"])
    raise ValueError(f"lidar kind {lidar['kind']!r}")


def noise_seed(seed: int) -> int:
    """A 32-bit seed for numpy's RandomState from any whole number."""
    return int(np.random.SeedSequence(abs(int(seed))).generate_state(1)[0])


@dataclass
class Frame:
    """One frame's messages, in the order a driver hands them over:
    ("imu", (t, acc, gyr)), ("pts", (m, 4) points) or ("img", (t, image))."""
    index: int
    time_image: float
    events: list

    @property
    def rendered(self) -> bool:
        """Whether the frame's image carries pixels (not a stamp only)."""
        return any(k == "img" and p[1] is not None for k, p in self.events)


def _shifted(events: list, dt: float) -> list:
    if dt == 0.0:
        return events
    out = []
    for kind, payload in events:
        if kind == "imu":
            t, acc, gyr = payload
            out.append((kind, (t + dt, acc, gyr)))
        elif kind == "img":
            out.append((kind, (payload[0] + dt, payload[1])))
        else:
            pts = payload.copy()
            pts[:, 3] += dt
            out.append((kind, pts))
    return out


@dataclass
class Traffic:
    """The prefix (the still start, the ramp, up to the lap) and one lap
    of frames.  `frames()` replays the lap without end."""
    prefix: List[Frame]
    lap: List[Frame]
    lap_s: float
    render_s: float           # seconds spent rendering the images
    traj: "LapTrajectory"     # the ground truth

    def truth(self, times) -> np.ndarray:
        """The rig's true positions at `times` (the trajectory repeats
        every lap, so a replayed frame's stamp reads it directly)."""
        return self.traj.position(np.asarray(times, np.float64))

    def frames(self) -> Iterator[Frame]:
        yield from self.prefix
        n, k = 0, len(self.prefix)
        while True:
            dt = n * self.lap_s
            for f in self.lap:
                yield Frame(k, f.time_image + dt, _shifted(f.events, dt))
                k += 1
            n += 1


def trajectory(spec: dict) -> LapTrajectory:
    return LapTrajectory(**spec)


def build(mix: dict, lidar_options, seed: int, device="cuda") -> Traffic:
    """Simulates the mix (`traffic/<mix>.json`) from `seed`: the sensor
    noise is the seed's, the world and the trajectory are the mix's."""
    import time as _time

    rates = mix["rates_hz"]
    lap_s, lap_start = float(mix["lap_s"]), float(mix["lap_start_s"])
    for name, r in rates.items():
        if abs(lap_s * r - round(lap_s * r)) > 1e-9:
            raise ValueError(f"the lap is no whole number of {name} periods")
    img_dt, lidar_dt = 1.0 / rates["camera"], 1.0 / rates["lidar"]
    per_image = rates["lidar"] / rates["camera"]
    if per_image < 1 or abs(per_image - round(per_image)) > 1e-9:
        raise ValueError("the LiDAR's rate is no whole multiple of the "
                         "camera's")
    k0 = int(math.ceil((lap_start - IMAGE_T0) / img_dt - 1e-9))
    n_lap = int(round(lap_s / img_dt))
    # image k lies in LiDAR packet first + k * per_image; the stream has to
    # reach the packet of the lap's last image
    first = int(math.floor((IMAGE_T0 - LIDAR_T0) / lidar_dt + 1e-9))
    last = first + (k0 + n_lap - 1) * int(round(per_image))
    duration = LIDAR_T0 + (last + 1) * lidar_dt + 0.05
    calib = (CALIBS[mix["calib"]] if isinstance(mix["calib"], str)
             else {k: np.asarray(v) if isinstance(v, list) else v
                   for k, v in mix["calib"].items()})
    traj = trajectory(mix["trajectory"])
    dirs = lidar_directions(mix["lidar"])
    room = world(mix["world"], device=device)
    sim = synthetic.simulate(
        duration=duration, imu_rate=rates["imu"], sweep_rate=rates["lidar"],
        image_rate=rates["camera"], image_size=(0, 0),
        camera=tuple(calib["intr_full"] * 0.5), dist_coeffs=calib["dist"],
        r_ic=calib["r_ic"], t_ic=calib["t_ic"],
        cam_time_offset=calib["cam_time_offset"], seed=noise_seed(seed),
        traj=traj, world=room, dirs_phase=dirs, device=device)

    t0 = _time.perf_counter()
    images = []
    if mix["camera"]:
        rays = synthetic._camera_ray_table(
            tuple(calib["intr_full"] * 0.5), calib["size"], calib["dist"])
        still = None
        for (tc, _) in sim.images:
            t_cap = tc + calib["cam_time_offset"]
            if t_cap <= traj.start_still and still is not None:
                images.append((tc, still))      # the rig has not moved
                continue
            img = synthetic.render_image(
                room, traj, t_cap, tuple(calib["intr_full"] * 0.5),
                calib["size"], r_imu_camera=calib["r_ic"],
                t_imu_camera=calib["t_ic"], _dirs_cam=rays, device=device)
            u8 = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
            if t_cap <= traj.start_still:
                still = u8
            images.append((tc, u8))
    else:
        images = [(tc, None) for (tc, _) in sim.images]
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    render_s = _time.perf_counter() - t0

    packets = lidar_packets(sim.lidar_chunks, mix["lidar"], lidar_options)
    # frame k: its image, the packets up to the first whose points pass
    # the image time, the IMU samples up to that packet's end
    frames, imu_i, pkt_i = [], 0, 0
    for k in range(k0 + n_lap):
        tc, img = images[k]
        ev = []
        end = None
        while end is None and pkt_i < len(packets):
            j, pts = packets[pkt_i]
            ev.append((float(pts[-1, 3]), "pts", pts))
            pkt_i += 1
            if pts[-1, 3] > tc:
                end = LIDAR_T0 + (j + 1) * lidar_dt - 1e-9
        if end is None:
            raise ValueError(f"the stream ends before image {k}'s sweeps "
                             "can be cut")
        while imu_i < len(sim.imu) and sim.imu[imu_i][0] <= end:
            ev.append((sim.imu[imu_i][0], "imu", sim.imu[imu_i]))
            imu_i += 1
        ev.append((tc, "img", (tc, img)))
        ev.sort(key=lambda e: (e[0], e[1]))
        frames.append(Frame(k, tc, [(kind, p) for (_, kind, p) in ev]))
    return Traffic(prefix=frames[:k0], lap=frames[k0:], lap_s=lap_s,
                   render_s=render_s, traj=traj)
