"""Runnable demo: synthetic-world LIVO replay with ATE report (port of
`sr_livo_tpu/runtime/demo.py`).

    python -m sr_livo_tpu_torch.runtime.demo [--duration 10]
        [--device cuda|cpu] [--out output/] [--seed 2] [--vision]
        [--stream DIR]

Simulates a sensor rig flying through a textured room, runs the full
pipeline on `--device` (default cuda; cpu runs the plain PyTorch path),
writes pose.txt/velocity.txt/bias.txt, and prints per-run stats + ATE
RMSE against the exact simulator ground truth.  Exits 1 at an ATE of
0.10 m or more.  With LIVO_TRACE_DIR set, the run is traced with
torch.profiler into $LIVO_TRACE_DIR/demo/, and the pipeline's spans
(`utils.profiling.StageTimers`: host spans and the device intervals of
their work on one clock) are written beside it as a Chrome trace,
spans-<ns>.json.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default: the kernels on the GPU) or cpu "
                         "(the plain PyTorch path)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--vision", action="store_true",
                    help="render camera images and run the vision ESIKFs")
    ap.add_argument("--stream", default=None, metavar="DIR",
                    help="publish live pose/path/color-map files to DIR "
                         "while the run is in flight")
    args = ap.parse_args(argv)

    from sr_livo_tpu_torch.config import LivoConfig
    from sr_livo_tpu_torch.pipeline import LivoPipeline, run_streams
    from sr_livo_tpu_torch.runtime import synthetic, tum
    from sr_livo_tpu_torch.utils.device import resolve_device
    from sr_livo_tpu_torch.utils.profiling import trace_if_enabled

    device = resolve_device(args.device)
    cfg = LivoConfig()
    cfg.odometry_options.voxel_size = 0.2
    cfg.odometry_options.init_voxel_size = 0.2
    cfg.odometry_options.sample_voxel_size = 0.8
    cfg.odometry_options.init_sample_voxel_size = 0.8
    cfg.odometry_options.min_distance_points = 0.05
    cfg.icp.size_voxel_map = 0.6
    cfg.icp.min_number_neighbors = 12
    cfg.shapes.max_sweep_points = 4096
    cfg.shapes.max_frame_points = 4096
    cfg.shapes.max_keypoints = 768
    cfg.shapes.max_imu_samples = 48
    cfg.shapes.map_capacity = 1 << 16

    vision = None
    image_size = (0, 0)
    camera = None
    if args.vision:
        from sr_livo_tpu_torch.models.vision import VisionModule
        image_size = (240, 320)
        camera = (260.0, 260.0, 160.0, 120.0)
        cfg.camera_options.image_width = 320
        cfg.camera_options.image_height = 240
        cfg.camera_options.image_scale = 1.0
        cfg.camera_options.camera_intrinsic = [
            camera[0], 0.0, camera[2], 0.0, camera[1], camera[3], 0, 0, 1]
        cfg.camera_options.camera_dist_coeffs = [0, 0, 0, 0, 0]
        cfg.extrinsics.extrinsic_R_imu_camera = [
            0, 0, 1, -1, 0, 0, 0, -1, 0]
        vision = VisionModule(cfg, device=device)

    print(f"[demo] simulating {args.duration:.0f}s of sensor data...",
          flush=True)
    sim = synthetic.simulate(duration=args.duration, n_azimuth=100,
                             n_rings=12, seed=args.seed,
                             image_size=image_size, camera=camera,
                             device=device)

    stream = None
    if args.stream:
        from sr_livo_tpu_torch.runtime.streaming import StreamPublisher
        stream = StreamPublisher(args.stream)
    pipe = LivoPipeline(cfg, vision=vision, stream=stream, device=device)
    t0 = time.time()
    with trace_if_enabled("demo", timers=pipe.timers):
        run_streams(pipe, sim)
    if stream is not None:
        stream.close()
        print(f"[demo] live stream written to {args.stream}")
    wall = time.time() - t0

    ts, ps, qs = pipe.trajectory()
    n_ok = sum(r.success for r in pipe.records)
    ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
    print(f"[demo] frames={len(pipe.records)} registered={n_ok} "
          f"rendered={sum(r.rendering for r in pipe.records)}")
    print(f"[demo] wall={wall:.1f}s  ({len(pipe.records)/max(wall,1e-9):.1f} "
          f"sweeps/s incl. sim+host)")
    print(f"[demo] ATE RMSE = {ate*100:.2f} cm")
    if args.out:
        pipe.write_outputs(args.out)
        print(f"[demo] wrote pose.txt/velocity.txt/bias.txt to {args.out}")
    return 0 if ate < 0.10 else 1


if __name__ == "__main__":
    sys.exit(main())
