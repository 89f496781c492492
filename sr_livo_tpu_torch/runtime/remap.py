"""Host-side bilinear remap of uint8 images (the numpy path of the JAX
package's `runtime/native.py::remap_u8`).

The vision module undistorts full-resolution camera frames on the host
before upload (imageProcessing.cpp:118-120, resize composed into the
map), as the JAX package does; this is the port's own numpy copy.
"""

from __future__ import annotations

import numpy as np


def remap_u8(src: np.ndarray, map_uv: np.ndarray) -> np.ndarray:
    """Bilinear remap of a uint8 (H, W, C) image by a float32 (dh, dw, 2)
    source-coordinate map (u = source column, v = source row), rounded to
    the nearest uint8 like cv::remap."""
    src = np.ascontiguousarray(src)
    if src.ndim == 2:
        src = src[..., None]
    sh, sw, ch = src.shape
    map_uv = np.asarray(map_uv, np.float32)
    u = np.clip(map_uv[..., 0], 0.0, sw - 1.001)
    v = np.clip(map_uv[..., 1], 0.0, sh - 1.001)
    u0 = u.astype(np.int32)
    v0 = v.astype(np.int32)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    p00 = src[v0, u0].astype(np.float32)
    p01 = src[v0, u0 + 1].astype(np.float32)
    p10 = src[v0 + 1, u0].astype(np.float32)
    p11 = src[v0 + 1, u0 + 1].astype(np.float32)
    out = ((1 - fv) * (1 - fu) * p00 + (1 - fv) * fu * p01
           + fv * (1 - fu) * p10 + fv * fu * p11)
    if src.dtype == np.uint8:
        out = np.clip(out + 0.5, 0, 255).astype(np.uint8)
    else:
        out = out.astype(src.dtype)
    return out if ch > 1 else out[..., 0]
