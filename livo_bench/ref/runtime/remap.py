# Frozen copy of sr_livo_tpu_torch/runtime/remap.py at commit f22c487785a4: part of the
# benchmark's plain reference (livo_bench/check.py).  Later changes
# to the port do not change it.
"""Plain version of the host-side bilinear remap of uint8 images
(`runtime/native.py::remap_u8`, the C++ `livo_remap_u8`).

The vision module undistorts full-resolution camera frames on the host
before upload (imageProcessing.cpp:118-120, resize composed into the
map), as the JAX package does, through the native library.  This numpy
copy repeats the C++ arithmetic step for step in float32 (the clamp edge,
the fractions, the four weights and their sum in the same order), so the
two agree bit for bit; the tests use it as the oracle.
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
    sh, sw, _ch = src.shape
    map_uv = np.asarray(map_uv, np.float32)
    f32 = np.float32
    u = np.clip(map_uv[..., 0], f32(0.0), f32(sw - 1) - f32(1e-3))
    v = np.clip(map_uv[..., 1], f32(0.0), f32(sh - 1) - f32(1e-3))
    u0 = u.astype(np.int32)
    v0 = v.astype(np.int32)
    fu = (u - u0.astype(f32))[..., None]
    fv = (v - v0.astype(f32))[..., None]
    p00 = src[v0, u0].astype(f32)
    p01 = src[v0, u0 + 1].astype(f32)
    p10 = src[v0 + 1, u0].astype(f32)
    p11 = src[v0 + 1, u0 + 1].astype(f32)
    one = f32(1.0)
    out = (((one - fv) * (one - fu)) * p00 + ((one - fv) * fu) * p01
           + (fv * (one - fu)) * p10 + (fv * fu) * p11)
    out = (out + f32(0.5)).astype(np.uint8)
    return out if out.shape[-1] > 1 else out[..., 0]
