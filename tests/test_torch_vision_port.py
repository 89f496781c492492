"""The port's LIVO loop alone, on images of the port's own renderer: the
calibrated rig of test_vision_pipeline.py (lens distortion through the
host remap, LiDAR and camera extrinsics, a camera time offset) passes its
absolute bars, and the pipelined host path (a feeder thread preparing and
uploading the next frames) gives the serial path's results."""
import numpy as np
import torch

from sr_livo_tpu_torch.models.vision import VisionModule as TVision
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.pipeline import run_streams as trun
from sr_livo_tpu_torch.runtime import synthetic as tsyn
from sr_livo_tpu_torch.runtime import tum
from tests.test_torch_vision import CAM, R_CFG, SIM, SIZE, _port_cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401


def test_full_calibration_dimensions_port_alone():
    """test_vision_pipeline.py's calibrated rig on the port alone: 30 deg
    LiDAR-IMU rotation and offset, lens distortion (undistorted by the
    host remap), a camera-IMU offset and an 8 ms camera time offset, on
    images of the port's own renderer."""
    a = np.deg2rad(30)
    r_il = np.array([[np.cos(a), -np.sin(a), 0],
                     [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    t_il = np.array([0.12, -0.06, 0.08])
    dist = [-0.28, 0.07, 8e-4, -2e-4, 0.0]
    t_ic = np.array([0.05, 0.047, -0.031])
    sim = tsyn.simulate(duration=6.5, n_azimuth=100, n_rings=12, seed=6,
                        image_size=SIZE, camera=CAM, r_il=r_il, t_il=t_il,
                        dist_coeffs=dist, r_ic=R_CFG, t_ic=t_ic,
                        cam_time_offset=0.008, device="cpu")
    cfg = _port_cfg()
    cfg.camera_options.camera_dist_coeffs = dist
    cfg.extrinsics.extrinsic_R_imu_lidar = list(r_il.flatten())
    cfg.extrinsics.extrinsic_t_imu_lidar = list(t_il)
    cfg.extrinsics.extrinsic_R_imu_camera = list(R_CFG.flatten())
    cfg.extrinsics.extrinsic_t_imu_camera = list(t_ic)
    vision = TVision(cfg, device="cpu")
    assert vision.host_map is not None
    assert vision._host_prepare(sim.images[0][1])[1]    # host remap path
    pipe = trun(TPipe(cfg, vision=vision, device="cpu"), sim)
    ts, ps, _ = pipe.trajectory()
    ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
    assert ate < 0.05, f"calibrated-rig LIVO ATE {ate:.3f} m"
    tracked = np.array([s[1] for s in vision.stats])
    assert tracked[5:].mean() > 30


def test_pipelined_vision_matches_serial():
    """The feeder thread (host prep and image upload of the next frames)
    reorders host work only: records and vision stats equal the serial
    path's."""
    sim = tsyn.simulate(**SIM, device="cpu")
    cfg = _port_cfg()
    cutter = TPipe(cfg, device="cpu")
    for (t, a, g) in sim.imu:
        cutter.push_imu(t, a, g)
    for c in sim.lidar_chunks:
        cutter.push_points(c)
    for (t, img) in sim.images:
        cutter.push_image(t, img)
    meas = [cutter.cutter.get() for _ in range(48)]
    pipes = []
    for pipelined in (False, True):
        v = TVision(cfg, device="cpu")
        p = TPipe(cfg, vision=v, device="cpu")
        assert p.process_measurements(meas, pipelined=pipelined) == len(meas)
        pipes.append((p, v))
    (ps, vs), (pp, vp) = pipes
    assert len(vs.stats) > 5 and vs.stats == vp.stats
    assert vs._stats_full == vp._stats_full
    for a, b in zip(ps.records, pp.records):
        np.testing.assert_array_equal(a.position, b.position)
    assert torch.equal(vs.color_map.reg, vp.color_map.reg)
