"""A rosbag replayed through the port (sr_livo_tpu_torch.runtime.drivers.
replay_bag into LivoPipeline(device="cpu")) against the same bag through
the JAX package's replay_bag and LivoPipeline.

The bag is the 6 s synthetic Velodyne + IMU + image bag of
tests/test_ingest.py:141-164 (bz2 chunks).  Both replays must give the
same frames with the same registration flags, positions within 2 mm of
each other (the port's parity bar) and an ATE below 0.08 m.  A second
bag carries JPEG `CompressedImage`s (test_ingest.py:327-377): the port
decodes them and the images reach the cutter.
"""
import dataclasses

import numpy as np
import pytest

from sr_livo_tpu.config import LIDAR_VELODYNE
from sr_livo_tpu.config import LivoConfig as JCfg
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.runtime import drivers as jdrivers
from sr_livo_tpu_torch.config import LivoConfig as TCfg
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.runtime import drivers, synthetic, tum
from tests import rosbag_writer as rbw

MAX_GAP_M = 2e-3
TOPICS = ("/lidar", "/imu", "/cam")


def _cfg(cls):
    cfg = cls()
    cfg.lidar_options.lidar_type = LIDAR_VELODYNE
    cfg.lidar_options.n_scans = 8
    cfg.lidar_options.time_unit = 0
    cfg.lidar_options.blind = 0.3
    cfg.lidar_options.point_filter_num = 1
    cfg.odometry_options.voxel_size = 0.2
    cfg.odometry_options.init_voxel_size = 0.2
    cfg.odometry_options.sample_voxel_size = 0.8
    cfg.odometry_options.init_sample_voxel_size = 0.8
    cfg.odometry_options.min_distance_points = 0.05
    cfg.icp.size_voxel_map = 0.6
    cfg.icp.min_number_neighbors = 12
    cfg.shapes.max_sweep_points = 2048
    cfg.shapes.max_frame_points = 2048
    cfg.shapes.max_keypoints = 512
    cfg.shapes.max_imu_samples = 48
    cfg.shapes.map_capacity = 1 << 15
    return cfg


def _write_bag(path, sim, compression="none", image=None):
    """The LIO bag of test_ingest.py: IMU, one Velodyne PointCloud2 per
    simulated chunk (8 rings, per-point float32 time), and an image or a
    JPEG per image stamp."""
    w = rbw.BagWriter(path, compression=compression)
    for (t, acc, gyr) in sim.imu:
        w.write_message("/imu", "sensor_msgs/Imu", t, rbw.ser_imu(t, acc, gyr))
    for chunk in sim.lidar_chunks:
        if chunk.shape[0] == 0:
            continue
        stamp = chunk[0, 3]
        rel = (chunk[:, 3] - stamp).astype(np.float32)
        ring = (np.arange(chunk.shape[0]) % 8).astype(np.uint16)
        w.write_message("/lidar", "sensor_msgs/PointCloud2", stamp,
                        rbw.ser_pointcloud2_velodyne(
                            stamp, chunk[:, :3].astype(np.float32), rel, ring))
    for (t, _img) in sim.images:
        if image is None:
            w.write_message("/cam", "sensor_msgs/Image", t,
                            rbw.ser_image_rgb8(t, np.zeros((8, 8, 3),
                                                           np.uint8)))
        else:
            w.write_message("/cam", "sensor_msgs/CompressedImage", t,
                            rbw.ser_compressed_image(t, image, fmt="jpeg"))
    w.close()
    return path


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    sim = synthetic.simulate(duration=6.0, n_azimuth=80, n_rings=8, seed=8)
    path = _write_bag(str(tmp_path_factory.mktemp("bag") / "replay.bag"),
                      sim, compression="bz2")
    jcfg, tcfg = _cfg(JCfg), _cfg(TCfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = JPipe(jcfg)
    jdrivers.replay_bag(jp, path, jcfg, *TOPICS)
    tp = TPipe(tcfg, device="cpu")
    drivers.replay_bag(tp, path, tcfg, *TOPICS)
    return sim, jp, tp


def test_replay_gives_the_jax_frames(replays):
    _sim, jp, tp = replays
    assert tp.initialized and jp.initialized
    assert len(tp.records) == len(jp.records) > 20
    assert [r.time for r in tp.records] == [r.time for r in jp.records]
    assert [r.success for r in tp.records] == [r.success for r in jp.records]
    assert [r.rendering for r in tp.records] == [
        r.rendering for r in jp.records]


def test_replay_tracks_like_jax(replays):
    sim, jp, tp = replays
    tt, tpos, _ = tp.trajectory()
    jt, jpos, _ = jp.trajectory()
    assert np.linalg.norm(tpos - jpos, axis=1).max() < MAX_GAP_M
    for ts, ps in ((tt, tpos), (jt, jpos)):
        ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
        assert ate < 0.08, f"bag-replay ATE {ate:.3f} m"


@pytest.mark.parametrize("image_type", ["COMPRESSED", "Compressed"])
def test_replay_compressed_images(tmp_path, image_type):
    """`image_type` is case-insensitive, as in the JAX package; JPEG
    images are decoded and reach the cutter as image payloads."""
    sim = synthetic.simulate(duration=3.0, n_azimuth=40, n_rings=8, seed=8)
    grad = np.tile(np.arange(16, dtype=np.uint8)[None, :, None] * 15,
                   (12, 1, 3))
    path = _write_bag(str(tmp_path / "compressed.bag"), sim, image=grad)
    images = []

    class Recorder:
        def push_imu(self, *a):
            pass

        def push_points(self, pts):
            pass

        def push_image(self, t, img):
            images.append((t, img))

        def process_available(self):
            return 0

    drivers.replay_bag(Recorder(), path, _cfg(TCfg), *TOPICS,
                       image_type=image_type)
    assert [t for t, _ in images] == pytest.approx(
        [t for t, _ in sim.images], abs=1e-6)
    assert all(img.shape == grad.shape and img.dtype == np.uint8
               and np.abs(img.astype(int) - grad).mean() < 8
               for _, img in images)
