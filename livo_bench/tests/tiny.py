"""Tiny cells for the CPU tests, small enough for the plain path on the
CPU: the r3live_odom deployment's YAML and switches on narrow shapes (30
x 40 images, a 40 x 30 ray cone, a 4 s lap), and a spinning one, the
NTU-VIRAL profile's YAML (`configs/ntu.yaml`: an Ouster OS1-16 at 20 Hz,
the camera at 10 Hz) with a 16-ring Ouster of a few dozen azimuths on
the same narrow shapes."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
NTU_YAML = os.path.join(os.path.dirname(BENCH), "configs", "ntu.yaml")


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def spec(config_name: str = "r3live_odom", mix_name: str = "livo",
         workload: str = "r3live_odom.livo"):
    """(workload entry, configuration, mix, limits) of the tiny cell."""
    config = copy.deepcopy(_load("configs", config_name + ".json"))
    config["overrides"].update({
        "shapes.max_sweep_points": 2048, "shapes.max_frame_points": 2048,
        "shapes.max_keypoints": 256, "shapes.map_capacity": 1 << 14,
        "shapes.color_capacity": 1 << 14, "shapes.color_registry": 1 << 15,
        "shapes.max_render_points": 1 << 11, "shapes.max_render_voxels": 512,
        "shapes.lk_pyramid_levels": 2, "shapes.lk_window": 9,
        "shapes.lk_iterations": 3,
        "camera_options.image_width": 80, "camera_options.image_height": 60,
        "camera_options.camera_intrinsic": [40.0, 0, 40.0, 0, 40.0, 30.0,
                                            0, 0, 1],
        "camera_options.camera_dist_coeffs": [0.0, 0.0, 0.0, 0.0, 0.0],
        "camera_options.max_tracked_points": 40,
        "odometry_options.init_num_frames": 3})
    mix = copy.deepcopy(_load("traffic", mix_name + ".json"))
    yaml_ext = config["yaml"]["extrinsic_parameter"]
    mix["calib"] = {
        "intr_full": [40.0, 40.0, 40.0, 30.0], "dist": [0.0] * 5,
        "r_ic": [yaml_ext["extrinsic_R_imu_camera"][i:i + 3]
                 for i in (0, 3, 6)],
        "t_ic": yaml_ext["extrinsic_t_imu_camera"], "size": (30, 40),
        "cam_time_offset": 0.006}
    mix["lidar"] = {"kind": "livox", "n_az": 40, "n_el": 30}
    tr = mix["trajectory"]
    tr.update({"freq": [0.25, 0.5, 0.75], "yaw_freq": 0.25,
               "rp_freq": [0.25, 0.5], "start_still": 3.5})
    mix.update({"lap_s": 4.0, "lap_start_s": 5.6,
                "warm_up": {"min_rendered": 3, "after_init_s": 1.0,
                            "laps": 0},
                "check": {"segments": 2, "segment_frames": 3,
                          "span_frames": 12},
                "trace": {"after_check": 1, "frames": 4,
                          "roofline_frames": 1}})
    limits = _load("limits", workload + ".json")
    # the gate's 5 cm holds for the deployment's sensor; a 40 x 30 ray cone
    # on a 4 s lap tracks its trajectory to about 0.1-0.2 m
    limits["ate_m"] = 0.5
    wl = {"name": workload, "config": config_name, "traffic": mix_name,
          "chips": 1}
    return wl, config, mix, limits


def spinning_spec(n_az: int = 64):
    """(workload entry, configuration, mix, limits) of the tiny spinning
    cell: `configs/ntu.yaml` with the tiny cell's shapes and switches, a
    16-ring staggered Ouster of `n_az` azimuths at 20 Hz, the camera at 10
    Hz, the gate's `standard_lowyaw` trajectory at frequencies that divide
    the 4 s lap.  Each frame yields two sweeps: a gap-fill sweep without
    an image, then the image-aligned one."""
    import yaml

    wl, config, mix, limits = spec()
    with open(NTU_YAML) as f:
        config["yaml"] = yaml.safe_load(f)
    ext = config["yaml"]["extrinsic_parameter"]
    mix["calib"]["r_ic"] = [ext["extrinsic_R_imu_camera"][i:i + 3]
                            for i in (0, 3, 6)]
    mix["calib"]["t_ic"] = ext["extrinsic_t_imu_camera"]
    mix["calib"]["cam_time_offset"] = 0.004
    mix["rates_hz"]["lidar"] = 20
    mix["lidar"] = {"kind": "ouster", "n_az": n_az, "n_rings": 16,
                    "ring_stagger": True}
    mix["trajectory"].update({"yaw_amp": 0.5})
    wl = dict(wl, name="ntu_tiny.livo", config="ntu_tiny")
    return wl, config, mix, limits
