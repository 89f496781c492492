"""Live visualization of a streaming run — the rviz substitute.

The port's counterpart of `scripts/live_viewer.py`, with the same flags,
over the port's own `runtime.pcd` and `runtime.streaming`.  The
reference publishes rviz-consumable topics (colored map chunks, the
odometry path, TF; lioOptimization.cpp:1186-1384 with rviz_cfg/).
`runtime.streaming.StreamPublisher` mirrors that data to files while a
run is in flight:

  out_dir/odometry_live.txt       pose/velocity per frame
  out_dir/color_chunks/*.pcd      incremental colored-map chunks

This viewer is the human-viewable end of that pipe: it watches the
streaming directory and renders the colored global map (top-down and
side orthographic projections, true RGB) plus the trajectory into
`view.png`, refreshing as new chunks land — follow it live with any
auto-reloading image viewer.  `--once` renders a single frame and exits;
`--out` overrides the image path.  Host only; needs matplotlib.

Usage:
    python -m sr_livo_tpu_torch.runtime.live_viewer <stream_out_dir>
        [--interval 2.0] [--once] [--out view.png] [--max-points 400000]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

from sr_livo_tpu_torch.runtime.pcd import load_pcd_xyz
from sr_livo_tpu_torch.runtime.streaming import read_live_trajectory


def load_state(out_dir: str, max_points: int):
    """Read every available chunk + the live trajectory:
    (points, rgb in [0, 1], times, positions, number of chunks)."""
    pts, rgb = [], []
    chunks = sorted(glob.glob(os.path.join(out_dir, "color_chunks",
                                           "chunk_*.pcd")))
    for path in chunks:
        try:
            rows = load_pcd_xyz(path)
        except (OSError, ValueError):
            continue                      # chunk mid-write; next tick
        if rows.shape[1] >= 4:
            packed = rows[:, 3].view(np.uint32)
            rgb.append(np.stack([(packed >> 16) & 0xFF,
                                 (packed >> 8) & 0xFF,
                                 packed & 0xFF], axis=1) / 255.0)
        else:
            rgb.append(np.full((rows.shape[0], 3), 0.6))
        pts.append(rows[:, :3])
    if pts:
        pts = np.concatenate(pts)
        rgb = np.concatenate(rgb)
        if pts.shape[0] > max_points:    # uniform thinning for draw speed
            sel = np.linspace(0, pts.shape[0] - 1, max_points).astype(int)
            pts, rgb = pts[sel], rgb[sel]
    else:
        pts = np.zeros((0, 3))
        rgb = np.zeros((0, 3))
    try:
        ts, pos, _q, _v = read_live_trajectory(out_dir)
    except (OSError, ValueError):
        ts, pos = np.zeros(0), np.zeros((0, 3))
    return pts, rgb, ts, pos, len(chunks)


def render(out_dir: str, image_path: str, max_points: int) -> int:
    """Draws the current state into `image_path`; returns the points
    drawn."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts, rgb, ts, pos, n_chunks = load_state(out_dir, max_points)
    fig, axes = plt.subplots(1, 2, figsize=(14, 7), facecolor="black")
    views = (("top (x-y)", 0, 1), ("side (x-z)", 0, 2))
    for ax, (title, i, j) in zip(axes, views):
        ax.set_facecolor("black")
        if pts.shape[0]:
            ax.scatter(pts[:, i], pts[:, j], c=rgb, s=0.3, linewidths=0)
        if pos.shape[0]:
            ax.plot(pos[:, i], pos[:, j], color="#00ff88", lw=1.2)
            ax.plot(pos[-1, i], pos[-1, j], marker="o", ms=6,
                    color="#ff3355")
        ax.set_title(title, color="white")
        ax.tick_params(colors="gray")
        ax.set_aspect("equal")
    t_live = f"t={ts[-1]:.1f}s" if ts.shape[0] else "waiting for data"
    fig.suptitle(f"sr_livo_tpu_torch live map — {pts.shape[0]} pts, "
                 f"{n_chunks} chunks, {pos.shape[0]} poses, {t_live}",
                 color="white")
    fig.tight_layout()
    fig.savefig(image_path, dpi=110, facecolor="black")
    plt.close(fig)
    return pts.shape[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out_dir", help="StreamPublisher output directory")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--out", default=None, help="image path "
                    "(default <out_dir>/view.png)")
    ap.add_argument("--max-points", type=int, default=400_000)
    args = ap.parse_args(argv)
    image_path = args.out or os.path.join(args.out_dir, "view.png")
    while True:
        n = render(args.out_dir, image_path, args.max_points)
        print(f"[viewer] rendered {n} points -> {image_path}",
              file=sys.stderr)
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
