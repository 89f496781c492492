"""Colored point-cloud export (rgb_map.pcd); an own copy of
`sr_livo_tpu/runtime/pcd.py` that reads the port's tensors.

Equivalent of lioOptimization::saveColorPoints
(src/lioOptimization.cpp:1386-1426): dumps every registry
point with at least `minimum_views` color observations
(map_options.pub_point_minimum_views) as a binary PCD with packed RGB.
"""

from __future__ import annotations

import numpy as np

from sr_livo_tpu_torch.ops import color_map as cm


def save_xyz_points(points: np.ndarray, valid: np.ndarray, path: str) -> int:
    """Plain-xyz binary PCD of one frame's (de-skewed, world-frame) points —
    the debug_output dump of lioOptimization::process
    (src/lioOptimization.cpp:1091-1099)."""
    pts = np.asarray(points, np.float32)[np.asarray(valid, bool)]
    n = pts.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        "DATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.tobytes())
    return n


def save_color_points(color_map, path: str, minimum_views: int = 3) -> int:
    """Write rgb_map.pcd from a ColorMap (tensors on any device); returns
    the number of points written."""
    reg = color_map.reg.cpu().numpy()
    sel = ((reg[:, cm.C_VALID] > 0.5)
           & (reg[:, cm.C_NRGB].astype(np.int32) >= minimum_views))
    return save_color_rows(reg[:, cm.C_POS], reg[:, cm.C_RGB], sel, path)


def save_color_rows(pos: np.ndarray, rgb: np.ndarray, sel: np.ndarray,
                    path: str) -> int:
    """Colored binary PCD from raw rows (positions, 0-255 rgb, mask)."""
    pos = np.asarray(pos, np.float32)[sel]
    rgb = np.clip(np.asarray(rgb)[sel], 0, 255).astype(np.uint32)
    n = pos.shape[0]

    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    packed_f = packed.view(np.float32) if packed.dtype.itemsize == 4 \
        else packed.astype(np.uint32).view(np.float32)

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z rgb\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        "DATA binary\n")
    data = np.concatenate([pos, packed_f[:, None]], axis=1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
    return n


def load_pcd_xyz(path: str) -> np.ndarray:
    """Read a binary PCD written by this module: returns (N, F) float32
    rows (x y z [rgb-packed])."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"DATA binary\n") + len(b"DATA binary\n")
    header = raw[:end].decode("ascii").splitlines()
    nfields = npoints = None
    for line in header:
        if line.startswith("FIELDS"):
            nfields = len(line.split()) - 1
        elif line.startswith("POINTS"):
            npoints = int(line.split()[1])
    return np.frombuffer(raw, np.float32, npoints * nfields,
                         end).reshape(npoints, nfields)
