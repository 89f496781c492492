"""Sensor ingest: ROS message parsing + per-vendor LiDAR drivers + bag
replay (port of `sr_livo_tpu/runtime/drivers.py`).

The counterpart of the reference's cloudProcessing (src/
cloudProcessing.cpp) and of the subscriber side of lioOptimization
(:583-664): raw ROS1-serialized messages (from the native bag reader) are
deserialized with numpy, then the vendor drivers (Livox / Velodyne /
Ouster / Robosense) apply the reference's validity, decimation, blind and
monotonic-time filters through the port's native C++ library
(`runtime.native`).  All of it runs on the host; the pipeline it feeds
runs on the pipeline's device.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from sr_livo_tpu_torch.config import LIDAR_OUSTER, LIDAR_ROBOSENSE, LivoConfig
from sr_livo_tpu_torch.runtime import native

# PointField datatypes (sensor_msgs/PointField)
_PF_SIZES = {1: 1, 2: 1, 3: 2, 4: 2, 5: 4, 6: 4, 7: 4, 8: 8}


def _read_string(buf: bytes, pos: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    return buf[pos:pos + n].decode("utf-8", "replace"), pos + n


def parse_ros_header(buf: bytes, pos: int = 0) -> Tuple[float, str, int]:
    """std_msgs/Header -> (stamp_seconds, frame_id, new_pos)."""
    (_seq, sec, nsec) = struct.unpack_from("<III", buf, pos)
    pos += 12
    frame_id, pos = _read_string(buf, pos)
    return sec + nsec * 1e-9, frame_id, pos


def parse_imu(buf: bytes) -> Tuple[float, np.ndarray, np.ndarray]:
    """sensor_msgs/Imu -> (stamp, acc (3,), gyr (3,))."""
    stamp, _fid, pos = parse_ros_header(buf)
    pos += 4 * 8 + 9 * 8            # orientation + its covariance
    gyr = np.frombuffer(buf, np.float64, 3, pos)
    pos += 3 * 8 + 9 * 8
    acc = np.frombuffer(buf, np.float64, 3, pos)
    return stamp, acc.copy(), gyr.copy()


@dataclass
class PointCloud2:
    stamp: float
    height: int
    width: int
    fields: dict           # name -> (offset, datatype, count)
    point_step: int
    data: bytes


def parse_pointcloud2(buf: bytes) -> PointCloud2:
    stamp, _fid, pos = parse_ros_header(buf)
    height, width = struct.unpack_from("<II", buf, pos)
    pos += 8
    (n_fields,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    fields = {}
    for _ in range(n_fields):
        name, pos = _read_string(buf, pos)
        off, dtype, count = struct.unpack_from("<IBI", buf, pos)
        pos += 9
        fields[name] = (off, dtype, count)
    pos += 1                         # is_bigendian
    (point_step, _row_step) = struct.unpack_from("<II", buf, pos)
    pos += 8
    (data_len,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    data = buf[pos:pos + data_len]
    return PointCloud2(stamp, height, width, fields, point_step, data)


@dataclass
class LivoxCustomMsg:
    stamp: float
    timebase: int
    xyz: np.ndarray        # (N, 3) f32
    reflectivity: np.ndarray
    tag: np.ndarray
    line: np.ndarray
    offset_ns: np.ndarray  # (N,) u32


def parse_livox_custom(buf: bytes) -> LivoxCustomMsg:
    """livox_ros_driver/CustomMsg."""
    stamp, _fid, pos = parse_ros_header(buf)
    (timebase,) = struct.unpack_from("<Q", buf, pos)
    pos += 8
    (point_num,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    pos += 1 + 3                     # lidar_id + rsvd
    (arr_len,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    n = arr_len
    rec = np.frombuffer(buf, np.uint8, n * 19, pos).reshape(n, 19)
    offset_ns = rec[:, 0:4].copy().view(np.uint32)[:, 0]
    xyz = rec[:, 4:16].copy().view(np.float32).reshape(n, 3)
    return LivoxCustomMsg(stamp, timebase, xyz, rec[:, 16].copy(),
                          rec[:, 17].copy(), rec[:, 18].copy(), offset_ns)


def parse_image(buf: bytes) -> Tuple[float, np.ndarray]:
    """sensor_msgs/Image (bgr8/rgb8/mono8) -> (stamp, (H, W, 3) uint8 RGB)."""
    stamp, _fid, pos = parse_ros_header(buf)
    h, w = struct.unpack_from("<II", buf, pos)
    pos += 8
    encoding, pos = _read_string(buf, pos)
    pos += 1                          # is_bigendian
    (step,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    (data_len,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    raw = np.frombuffer(buf, np.uint8, data_len, pos)
    if encoding in ("bgr8", "rgb8"):
        img = raw.reshape(h, step)[:, :w * 3].reshape(h, w, 3)
        if encoding == "bgr8":
            img = img[..., ::-1]
    elif encoding == "mono8":
        img = np.repeat(raw.reshape(h, step)[:, :w, None], 3, axis=-1)
    else:
        raise ValueError(f"unsupported image encoding: {encoding}")
    return stamp, np.ascontiguousarray(img)


def parse_compressed_image(buf: bytes) -> Tuple[float, np.ndarray]:
    """sensor_msgs/CompressedImage -> (stamp, RGB uint8) via PIL, imported
    here: only a replay of compressed images needs Pillow."""
    stamp, _fid, pos = parse_ros_header(buf)
    _fmt, pos = _read_string(buf, pos)
    (data_len,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    payload = buf[pos:pos + data_len]
    import io
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
    return stamp, img


class CloudProcessing:
    """Per-vendor LiDAR stream driver (reference cloudProcessing)."""

    def __init__(self, cfg: LivoConfig):
        lo = cfg.lidar_options
        self.lidar_type = lo.lidar_type
        self.n_scans = lo.n_scans
        self.scan_rate = lo.scan_rate
        self.point_filter_num = lo.point_filter_num
        self.blind = lo.blind
        # time_unit -> milliseconds scale (cloudProcessing.cpp:44-66)
        self.time_unit_scale = {0: 1e3, 1: 1.0, 2: 1e-3, 3: 1e-6}.get(
            lo.time_unit, 1.0)
        self.last_end_time = -1.0
        self.sweep_id = 0

    def process_livox(self, msg: LivoxCustomMsg) -> np.ndarray:
        out, self.last_end_time = native.process_livox(
            msg.xyz, msg.tag, msg.line, msg.offset_ns, self.n_scans,
            self.point_filter_num, self.blind, msg.stamp, self.last_end_time)
        self.sweep_id += 1
        return out

    def process_cloud(self, pc: PointCloud2) -> np.ndarray:
        """Velodyne/Ouster/Robosense PointCloud2 -> (m, 4) absolute-time."""
        n = (len(pc.data) // pc.point_step) if pc.point_step else 0
        if n == 0:
            return np.zeros((0, 4))
        fx = pc.fields["x"][0]
        fy = pc.fields["y"][0]
        fz = pc.fields["z"][0]
        if self.lidar_type == LIDAR_OUSTER:
            tname, tdt = "t", 3                 # uint32 ns
        elif self.lidar_type == LIDAR_ROBOSENSE:
            tname, tdt = "timestamp", 2         # float64 abs seconds
        else:
            tname, tdt = "time", 1              # float32
        has_t = tname in pc.fields
        off_t = pc.fields[tname][0] if has_t else 0
        t_base = 0.0
        if self.lidar_type == LIDAR_ROBOSENSE and has_t:
            # robosense carries absolute f64 stamps; subtract the first
            # point's stamp IN DOUBLE inside the decoder
            # (cloudProcessing.cpp:477) — narrowing epoch-scale seconds
            # to f32 first quantizes relative times to ~0.125 ms
            t_base = float(np.frombuffer(
                pc.data[off_t:off_t + 8], np.float64)[0])
        xyzt = native.decode_xyzt(pc.data, n, pc.point_step, fx, fy, fz,
                                  off_t, tdt if has_t else 0,
                                  self.time_unit_scale, t_base=t_base)
        given = bool(has_t and n > 0 and xyzt[-1, 3] > 0)
        ring = None
        if not given and "ring" in pc.fields:
            off_r, dt_r, _ = pc.fields["ring"]
            ring = native.decode_ring(pc.data, n, pc.point_step, off_r,
                                      1 if _PF_SIZES.get(dt_r, 2) == 1 else 2)
        out, self.last_end_time = native.process_spinning(
            xyzt, ring, self.n_scans, self.scan_rate, self.point_filter_num,
            self.blind, pc.stamp, given, self.last_end_time)
        self.sweep_id += 1
        return out


IMAGE_TYPE_RGB8 = "RGB8"
IMAGE_TYPE_COMPRESSED = "COMPRESSED"


def replay_bag(pipeline, bag_path: str, cfg: LivoConfig,
               lidar_topic: str, imu_topic: str, image_topic: str,
               image_type: str = IMAGE_TYPE_RGB8,
               drain_every: float = 0.25) -> None:
    """Feed a rosbag through a LivoPipeline (the roslaunch+rosbag-play
    equivalent of the reference workflow): IMU, LiDAR (Livox CustomMsg or
    PointCloud2) and image messages in bag order, with the cutter drained
    every `drain_every` seconds of IMU time and once at the end.
    `image_type` is "RGB8" or "COMPRESSED", in any case."""
    cloud_pro = CloudProcessing(cfg)
    next_drain = None
    with native.BagReader(bag_path) as reader:
        for topic, msg_type, _t, payload in reader:
            if topic == imu_topic:
                stamp, acc, gyr = parse_imu(payload)
                pipeline.push_imu(stamp, acc, gyr)
                if next_drain is None:
                    next_drain = stamp + drain_every
                elif stamp >= next_drain:
                    pipeline.process_available()
                    next_drain = stamp + drain_every
            elif topic == lidar_topic:
                if "CustomMsg" in msg_type:
                    pts = cloud_pro.process_livox(parse_livox_custom(payload))
                else:
                    pts = cloud_pro.process_cloud(parse_pointcloud2(payload))
                if pts.shape[0]:
                    pipeline.push_points(pts)
            elif topic == image_topic:
                # case-insensitive: reference YAMLs write "compressed",
                # launch files "Compressed"
                if str(image_type).upper() == IMAGE_TYPE_COMPRESSED:
                    stamp, img = parse_compressed_image(payload)
                else:
                    stamp, img = parse_image(payload)
                pipeline.push_image(stamp, img)
    pipeline.process_available()
