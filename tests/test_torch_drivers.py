"""The port's sensor ingest (sr_livo_tpu_torch.runtime.drivers): the ROS
message parsers against the JAX package's, the frozen vendor-decode
goldens for all four vendors on the native path and on the plain numpy
path (bit-exact, with the final `last_end_time`, as
tests/test_vendor_golden.py holds the JAX package), and the hand checks
of tests/test_ingest.py:45-139 and :194-306 on the port's drivers."""
import os

import numpy as np
import pytest

from sr_livo_tpu.runtime import drivers as jdrivers
from sr_livo_tpu_torch.config import (LIDAR_LIVOX, LIDAR_OUSTER,
                                      LIDAR_ROBOSENSE, LIDAR_VELODYNE,
                                      LivoConfig)
from sr_livo_tpu_torch.runtime import drivers, native
from sr_livo_tpu_torch.runtime.measurements import SweepCutter
from tests import rosbag_writer as rbw

FIX = os.path.join(os.path.dirname(__file__), "fixtures",
                   "vendor_decode_golden.npz")
RNG = np.random.RandomState(21)


@pytest.fixture(scope="module")
def gold():
    return np.load(FIX)


def _cfg(lidar_type, time_unit, filter_num=2, blind=0.5, n_scans=6,
         scan_rate=10):
    cfg = LivoConfig()
    lo = cfg.lidar_options
    lo.lidar_type = lidar_type
    lo.time_unit = time_unit
    lo.point_filter_num = filter_num
    lo.blind = blind
    lo.n_scans = n_scans
    lo.scan_rate = scan_rate
    return cfg


GOLDEN_CFGS = {
    "livox": lambda: _cfg(LIDAR_LIVOX, 3, filter_num=1),
    "ouster": lambda: _cfg(LIDAR_OUSTER, 3, filter_num=2, n_scans=16,
                           scan_rate=20),
    "velodyne": lambda: _cfg(LIDAR_VELODYNE, 0, filter_num=2, n_scans=16),
    "robosense": lambda: _cfg(LIDAR_ROBOSENSE, 0, filter_num=2, n_scans=16),
}


@pytest.mark.parametrize("vendor", sorted(GOLDEN_CFGS))
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_decoder_matches_golden(gold, vendor, path, monkeypatch):
    if path == "numpy":
        for name in ("decode_xyzt", "decode_ring", "process_spinning",
                     "process_livox"):
            monkeypatch.setattr(native, name,
                                getattr(native, f"{name}_numpy"))
    payload = gold[f"{vendor}_payload"].tobytes()
    cp = drivers.CloudProcessing(GOLDEN_CFGS[vendor]())
    if vendor == "livox":
        out = cp.process_livox(drivers.parse_livox_custom(payload))
    else:
        out = cp.process_cloud(drivers.parse_pointcloud2(payload))
    np.testing.assert_array_equal(out, gold[f"{vendor}_expected"])
    assert out.dtype == np.float64
    assert cp.last_end_time == float(gold[f"{vendor}_last_end"])
    assert cp.sweep_id == 1


# ---- the parsers against the JAX package's -------------------------------

def _payloads():
    n = 40
    xyz = RNG.uniform(-10, 10, (n, 3)).astype(np.float32)
    ring = (np.arange(n) % 16).astype(np.uint16)
    img = RNG.randint(0, 255, (6, 10, 3)).astype(np.uint8)
    return {
        "imu": rbw.ser_imu(12.25, [0.1, 0.2, 9.8], [0.01, -0.02, 0.03]),
        "velodyne": rbw.ser_pointcloud2_velodyne(
            5.5, xyz, np.linspace(0, 0.09, n).astype(np.float32), ring),
        "ouster": rbw.ser_pointcloud2_ouster(
            6.5, xyz, np.linspace(0, 45e6, n).astype(np.uint32),
            ring.astype(np.uint8)),
        "robosense": rbw.ser_pointcloud2_robosense(
            7.5, xyz, 7.5 + np.linspace(0, 0.095, n), ring),
        "livox": rbw.ser_livox_custom(
            8.5, xyz, np.zeros(n, np.uint8), (np.arange(n) % 6)
            .astype(np.uint8), np.arange(n, dtype=np.uint32) * 1000),
        "rgb8": rbw.ser_image_rgb8(9.5, img),
        "bgr8": rbw.ser_image_rgb8(9.5, img).replace(b"rgb8", b"bgr8"),
        "mono8": _mono8(9.5, img[..., 0]),
        "png": rbw.ser_compressed_image(10.5, img, fmt="png"),
    }


def _mono8(stamp, gray):
    import struct
    h, w = gray.shape
    out = rbw.ser_header(stamp) + struct.pack("<II", h, w)
    out += struct.pack("<I", 5) + b"mono8" + struct.pack("<B", 0)
    out += struct.pack("<I", w) + struct.pack("<I", h * w) + gray.tobytes()
    return out


def _parse(mod, kind, payload):
    if kind == "imu":
        return mod.parse_imu(payload)
    if kind in ("velodyne", "ouster", "robosense"):
        pc = mod.parse_pointcloud2(payload)
        return (pc.stamp, pc.height, pc.width, pc.fields, pc.point_step,
                pc.data)
    if kind == "livox":
        m = mod.parse_livox_custom(payload)
        return (m.stamp, m.timebase, m.xyz, m.reflectivity, m.tag, m.line,
                m.offset_ns)
    if kind == "png":
        return mod.parse_compressed_image(payload)
    return mod.parse_image(payload)


@pytest.mark.parametrize("kind", ["imu", "velodyne", "ouster", "robosense",
                                  "livox", "rgb8", "bgr8", "mono8", "png"])
def test_parsers_match_jax(kind):
    payload = _payloads()[kind]
    got, want = _parse(drivers, kind, payload), _parse(jdrivers, kind,
                                                       payload)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    stamp, _, pos = drivers.parse_ros_header(payload)
    assert (stamp, pos) == jdrivers.parse_ros_header(payload)[::2]


def test_parse_image_rejects_unknown_encoding():
    bad = _payloads()["rgb8"].replace(b"rgb8", b"yuv4")
    with pytest.raises(ValueError):
        drivers.parse_image(bad)


# ---- hand checks (tests/test_ingest.py) ----------------------------------

def test_pointcloud2_parse_and_velodyne_driver():
    n = 64
    xyz = RNG.uniform(-10, 10, (n, 3)).astype(np.float32)
    xyz[:5] *= 0.001                       # inside the blind radius
    time_s = np.linspace(0, 0.095, n).astype(np.float32)
    ring = (np.arange(n) % 16).astype(np.uint16)
    pc = drivers.parse_pointcloud2(
        rbw.ser_pointcloud2_velodyne(100.0, xyz, time_s, ring))
    assert pc.width == n and pc.point_step == 22
    assert set(pc.fields) == {"x", "y", "z", "intensity", "ring", "time"}
    cp = drivers.CloudProcessing(_cfg(LIDAR_VELODYNE, 0, filter_num=1,
                                      n_scans=16))
    out = cp.process_cloud(pc)
    assert out.shape[0] == n - 5
    assert np.all(np.diff(out[:, 3]) >= 0)
    assert abs(out[0, 3] - 100.0) < 0.2
    assert np.all(np.linalg.norm(out[:, :3], axis=-1) > 0.5)
    assert cp.process_cloud(pc).shape[0] == 0     # the monotonic gate


def test_velodyne_ring_time_synthesis():
    n_az, n_rings = 90, 4
    az = np.linspace(0, 2 * np.pi * 0.9, n_az)
    dirs = np.stack([np.cos(az), np.sin(az)], axis=-1)
    xyz = np.concatenate([np.c_[5 * dirs, np.full(n_az, ring * 0.1)]
                          for ring in range(n_rings)]).astype(np.float32)
    ring = np.concatenate([np.full(n_az, r) for r in range(n_rings)])
    pc = drivers.parse_pointcloud2(rbw.ser_pointcloud2_velodyne(
        50.0, xyz, np.zeros(n_az * n_rings, np.float32),
        ring.astype(np.uint16)))
    cp = drivers.CloudProcessing(_cfg(LIDAR_VELODYNE, 0, filter_num=1,
                                      n_scans=n_rings))
    out = cp.process_cloud(pc)
    assert out.shape[0] > 300
    spread = out[:, 3].max() - out[:, 3].min()
    assert 0.05 < spread < 0.12, spread     # a 0.9 turn at 10 Hz


def test_livox_driver_filters():
    n = 200
    xyz = np.c_[RNG.uniform(1.0, 20.0, n), RNG.uniform(-5, 5, n),
                RNG.uniform(-2, 2, n)].astype(np.float32)
    tag = np.zeros(n, np.uint8)
    line = (np.arange(n) % 6).astype(np.uint8)
    offset_ns = np.linspace(0, 99e6, n).astype(np.uint32)
    xyz[10, 0] = 0.3            # too close in x
    tag[20] = 0x01              # bad tag (x > 2)
    xyz[30] = xyz[29]           # duplicate
    line[40] = 50               # bad line
    msg = drivers.parse_livox_custom(
        rbw.ser_livox_custom(77.0, xyz, tag, line, offset_ns))
    assert msg.xyz.shape == (n, 3) and np.allclose(msg.xyz, xyz)
    cp = drivers.CloudProcessing(_cfg(LIDAR_LIVOX, 3, filter_num=1,
                                      blind=0.1))
    out = cp.process_livox(msg)
    assert out.shape[0] == n - 5      # index 0 skipped + 4 defects
    assert np.all(np.diff(out[:, 3]) >= 0)
    assert abs(out[0, 3] - 77.0) < 0.2


def test_decimation():
    n = 100
    xyzt = np.c_[np.full(n, 5.0), np.zeros(n), np.zeros(n),
                 np.linspace(0, 99, n)].astype(np.float32)
    out, _ = native.process_spinning(xyzt, None, 1, 10, 4, 0.1, 0.0, True,
                                     -1.0)
    assert out.shape[0] == 25


def test_ouster_driver_ntu_profile():
    n = 160
    xyz = RNG.uniform(-12, 12, (n, 3)).astype(np.float32)
    xyz[:6] *= 0.01
    t_ns = np.linspace(0, 45e6, n).astype(np.uint32)
    ring = (np.arange(n) % 16).astype(np.uint8)
    pc = drivers.parse_pointcloud2(
        rbw.ser_pointcloud2_ouster(200.0, xyz, t_ns, ring))
    assert pc.point_step == 23
    cp = drivers.CloudProcessing(_cfg(LIDAR_OUSTER, 3, filter_num=1,
                                      blind=1.0, n_scans=16, scan_rate=20))
    out = cp.process_cloud(pc)
    assert out.shape[0] == n - 6
    assert np.all(np.diff(out[:, 3]) >= 0)
    assert abs(out[0, 3] - (200.0 + t_ns[6] * 1e-9)) < 1e-4
    assert abs(out[-1, 3] - 200.045) < 1e-4
    assert cp.process_cloud(pc).shape[0] == 0


def test_robosense_driver_subtracts_the_first_stamp_in_float64():
    n = 120
    xyz = RNG.uniform(-10, 10, (n, 3)).astype(np.float32)
    xyz[:4] *= 0.01
    stamp = 321.0
    ts_abs = 1.7e9 + np.linspace(0, 0.095, n)       # epoch-scale stamps
    ring = (np.arange(n) % 32).astype(np.uint16)
    pc = drivers.parse_pointcloud2(
        rbw.ser_pointcloud2_robosense(stamp, xyz, ts_abs, ring))
    cp = drivers.CloudProcessing(_cfg(LIDAR_ROBOSENSE, 0, filter_num=1,
                                      n_scans=32))
    out = cp.process_cloud(pc)
    assert out.shape[0] == n - 4
    assert np.all(np.diff(out[:, 3]) > 0)
    np.testing.assert_allclose(out[:, 3], stamp + (ts_abs[4:] - ts_abs[0]),
                               rtol=0, atol=1e-6)


def test_ouster_through_sweep_cutter():
    """An Ouster stream (20 Hz) + IMU + image through SweepCutter: the
    image-aligned sweep ends exactly at the image stamp."""
    cp = drivers.CloudProcessing(_cfg(LIDAR_OUSTER, 3, filter_num=1,
                                      blind=1.0, n_scans=16, scan_rate=20))
    cutter = SweepCutter(0.05)
    t0 = 500.0
    for k in range(8):
        n = 96
        xyz = RNG.uniform(2, 12, (n, 3)).astype(np.float32)
        t_ns = np.linspace(0, 49.9e6, n).astype(np.uint32)
        ring = (np.arange(n) % 16).astype(np.uint8)
        out = cp.process_cloud(drivers.parse_pointcloud2(
            rbw.ser_pointcloud2_ouster(t0 + 0.05 * k, xyz, t_ns, ring)))
        assert out.shape[0] == n
        cutter.push_points(out)
    for k in range(81):
        cutter.push_imu(t0 + 0.005 * k, np.array([0, 0, 9.81]), np.zeros(3))
    img_t = t0 + 0.12
    cutter.push_image(img_t, np.zeros((4, 4, 3), np.uint8))
    aligned = []
    while (m := cutter.get()) is not None:
        if m.rendering:
            aligned.append(m)
    assert aligned and abs(aligned[0].time_image - img_t) < 1e-9
    assert 0 < aligned[0].points.shape[0]
    assert aligned[0].points[:, 3].max() < img_t + 1e-9
