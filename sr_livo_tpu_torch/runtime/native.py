"""ctypes binding of the port's native ingest library
(`sr_livo_tpu_torch/csrc/livo_native.cpp`, port of
`sr_livo_tpu/runtime/native.py`).

The library is host C++, built at first use by `kernels.load` with g++
into `build/native/`.  Every entry calls it, or raises when it cannot be
built: there is no silent numpy fallback.  Beside each entry stands its
plain version (`*_numpy`; the host remap's is `runtime.remap.remap_u8`,
the wire pack's `measurements.prepare_sweep` + `pack_sweep`), which
repeats the C++ arithmetic in numpy, bit for bit; the tests hold the two
together and nothing on the main path calls the plain versions.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import numpy as np

from sr_livo_tpu_torch import kernels

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The loaded ingest library with its signatures declared; built at
    first use (raises with the compiler's log if g++ fails)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = kernels.load("livo_native")
        c = ctypes
        lib.livo_decode_xyzt.restype = c.c_int
        lib.livo_decode_xyzt.argtypes = [
            c.c_char_p, c.c_long, c.c_long, c.c_long, c.c_long, c.c_long,
            c.c_long, c.c_int, c.c_double, c.c_double,
            c.POINTER(c.c_float)]
        lib.livo_decode_ring.restype = c.c_int
        lib.livo_decode_ring.argtypes = [
            c.c_char_p, c.c_long, c.c_long, c.c_long, c.c_int,
            c.POINTER(c.c_int32)]
        lib.livo_process_spinning.restype = c.c_int
        lib.livo_process_spinning.argtypes = [
            c.POINTER(c.c_float), c.POINTER(c.c_int32), c.c_long, c.c_int,
            c.c_int, c.c_int, c.c_double, c.c_double, c.c_int,
            c.POINTER(c.c_double), c.POINTER(c.c_double)]
        lib.livo_process_livox.restype = c.c_int
        lib.livo_process_livox.argtypes = [
            c.POINTER(c.c_float), c.c_char_p, c.c_char_p,
            c.POINTER(c.c_uint32), c.c_long, c.c_int, c.c_int, c.c_double,
            c.c_double, c.POINTER(c.c_double), c.POINTER(c.c_double)]
        lib.livo_remap_u8.restype = c.c_int
        lib.livo_remap_u8.argtypes = [
            c.POINTER(c.c_uint8), c.c_long, c.c_long, c.c_long,
            c.POINTER(c.c_float), c.c_long, c.c_long, c.POINTER(c.c_uint8)]
        lib.livo_prepare_pack.restype = c.c_int
        lib.livo_prepare_pack.argtypes = [
            c.POINTER(c.c_double), c.c_long, c.c_double, c.c_double,
            c.c_double, c.c_long, c.POINTER(c.c_int16),
            c.POINTER(c.c_double)]
        lib.livo_bag_open.restype = c.c_void_p
        lib.livo_bag_open.argtypes = [c.c_char_p]
        lib.livo_bag_next.restype = c.c_int
        lib.livo_bag_next.argtypes = [
            c.c_void_p, c.POINTER(c.c_int32), c.POINTER(c.c_double),
            c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_long)]
        lib.livo_bag_topic.restype = c.c_char_p
        lib.livo_bag_topic.argtypes = [c.c_void_p, c.c_int32]
        lib.livo_bag_type.restype = c.c_char_p
        lib.livo_bag_type.argtypes = [c.c_void_p, c.c_int32]
        lib.livo_bag_error.restype = c.c_char_p
        lib.livo_bag_error.argtypes = [c.c_void_p]
        lib.livo_bag_close.restype = None
        lib.livo_bag_close.argtypes = [c.c_void_p]
        _LIB = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# Host image remap and the fused wire pack
# ---------------------------------------------------------------------------

def remap_u8(src: np.ndarray, map_uv: np.ndarray) -> np.ndarray:
    """Bilinear remap of a uint8 (H, W, C) image by a float32 (dh, dw, 2)
    source-coordinate map (u = source column, v = source row): the host
    cv::remap of imageProcessing.cpp:120 with the :118 resize composed
    in.  Plain version: `runtime.remap.remap_u8`."""
    src = np.ascontiguousarray(src)
    if src.ndim == 2:
        src = src[..., None]
    if src.dtype != np.uint8 or not 1 <= src.shape[2] <= 4:
        raise ValueError(f"remap_u8 takes uint8 images of 1-4 channels, got "
                         f"{src.dtype} {src.shape}")
    sh, sw, ch = src.shape
    m32 = np.ascontiguousarray(map_uv, np.float32)
    if m32.ndim != 3 or m32.shape[2] != 2:
        raise ValueError(f"map_uv must be (dh, dw, 2), got {m32.shape}")
    dh, dw = m32.shape[:2]
    out = np.empty((dh, dw, ch), np.uint8)
    get_lib().livo_remap_u8(_ptr(src, ctypes.c_uint8), sh, sw, ch,
                            _ptr(m32, ctypes.c_float), dh, dw,
                            _ptr(out, ctypes.c_uint8))
    return out if ch > 1 else out[..., 0]


def prepare_pack(pts: np.ndarray, begin: float, t_end: float,
                 duration: float, max_points: int
                 ) -> Tuple[np.ndarray, float, int]:
    """Fused sweep window + stride decimation + int16 wire pack (the
    `measurements.prepare_sweep` + `pack_sweep` point path in one C++ pass
    that releases the GIL).  Returns (pts_q (max_points, 4) int16, scale,
    n_points)."""
    if max_points <= 0:
        raise ValueError(f"max_points must be positive, got {max_points}")
    pts = np.ascontiguousarray(pts, np.float64).reshape(-1, 4)
    out_q = np.empty((max_points, 4), np.int16)
    scale = ctypes.c_double(0.0)
    k = get_lib().livo_prepare_pack(
        _ptr(pts, ctypes.c_double), pts.shape[0], begin, t_end, duration,
        max_points, _ptr(out_q, ctypes.c_int16), ctypes.byref(scale))
    return out_q, scale.value, k


# ---------------------------------------------------------------------------
# Point decoders and the vendor stream filters
# ---------------------------------------------------------------------------

def _check_payload(data: bytes, n: int, step: int, *fields) -> None:
    if n < 0 or step <= 0 or len(data) < n * step:
        raise ValueError(f"payload of {len(data)} bytes holds no {n} points "
                         f"of {step} bytes")
    for off, size in fields:
        if not 0 <= off <= step - size:
            raise ValueError(f"field at byte {off} (+{size}) outside a "
                             f"{step}-byte point")


_T_SIZES = {0: 0, 1: 4, 2: 8, 3: 4}


def decode_xyzt(data: bytes, n: int, step: int, off_x: int, off_y: int,
                off_z: int, off_t: int, t_dtype: int,
                time_unit_scale: float, t_base: float = 0.0) -> np.ndarray:
    """PointCloud2 payload -> (n, 4) float32 [x, y, z, t_rel_ms];
    `t_dtype` 0 = no time, 1 = float32, 2 = float64, 3 = uint32.

    `t_base` is subtracted from the decoded time in float64 before the
    float32 downcast: absolute epoch-scale stamps (Robosense float64
    `timestamp`) would quantize to ~0.125 ms if narrowed first."""
    data = bytes(data)
    _check_payload(data, n, step, (off_x, 4), (off_y, 4), (off_z, 4),
                   (off_t if t_dtype else 0, _T_SIZES[t_dtype]))
    out = np.empty((n, 4), np.float32)
    get_lib().livo_decode_xyzt(data, n, step, off_x, off_y, off_z, off_t,
                               t_dtype, time_unit_scale, t_base,
                               _ptr(out, ctypes.c_float))
    return out


def decode_xyzt_numpy(data: bytes, n: int, step: int, off_x: int,
                      off_y: int, off_z: int, off_t: int, t_dtype: int,
                      time_unit_scale: float, t_base: float = 0.0
                      ) -> np.ndarray:
    """Plain version of `decode_xyzt`: the time in float64, then float32."""
    buf = np.frombuffer(data, np.uint8, n * step).reshape(n, step)
    out = np.empty((n, 4), np.float32)
    for j, off in enumerate((off_x, off_y, off_z)):
        out[:, j] = buf[:, off:off + 4].copy().view(np.float32)[:, 0]
    if t_dtype in (1, 2, 3):
        dtype = {1: np.float32, 2: np.float64, 3: np.uint32}[t_dtype]
        size = _T_SIZES[t_dtype]
        t = buf[:, off_t:off_t + size].copy().view(dtype)[:, 0].astype(
            np.float64)
    else:
        t = np.zeros(n)
    out[:, 3] = (t - t_base) * time_unit_scale
    return out


def decode_ring(data: bytes, n: int, step: int, off_ring: int,
                ring_dtype: int) -> np.ndarray:
    """The u8 (`ring_dtype` 1) or u16 (2) ring field -> (n,) int32."""
    data = bytes(data)
    _check_payload(data, n, step, (off_ring, 1 if ring_dtype == 1 else 2))
    out = np.empty(n, np.int32)
    get_lib().livo_decode_ring(data, n, step, off_ring, ring_dtype,
                               _ptr(out, ctypes.c_int32))
    return out


def decode_ring_numpy(data: bytes, n: int, step: int, off_ring: int,
                      ring_dtype: int) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8, n * step).reshape(n, step)
    if ring_dtype == 1:
        return buf[:, off_ring].astype(np.int32)
    return buf[:, off_ring:off_ring + 2].copy().view(np.uint16)[:, 0] \
        .astype(np.int32)


def process_spinning(xyzt: np.ndarray, ring: Optional[np.ndarray],
                     n_scans: int, scan_rate: int, point_filter_num: int,
                     blind: float, header_time: float,
                     given_offset_time: bool, last_end_time: float
                     ) -> Tuple[np.ndarray, float]:
    """Spinning-LiDAR stream filter (ousterHandler / velodyneHandler /
    robosenseHandler, cloudProcessing.cpp:216-541): per-ring yaw time
    synthesis when no per-point time is given, time sort, decimation,
    blind and monotonic-time filters.  Returns (out (m, 4) float64 with
    absolute times, new_last_end_time)."""
    xyzt32 = np.ascontiguousarray(xyzt, np.float32).reshape(-1, 4)
    n = xyzt32.shape[0]
    ring32 = None
    if ring is not None:
        ring32 = np.ascontiguousarray(ring, np.int32)
        if ring32.shape != (n,):
            raise ValueError(f"ring {ring32.shape} for {n} points")
    out = np.empty((n, 4), np.float64)
    let = ctypes.c_double(last_end_time)
    m = get_lib().livo_process_spinning(
        _ptr(xyzt32, ctypes.c_float),
        _ptr(ring32, ctypes.c_int32) if ring32 is not None else None,
        n, n_scans, scan_rate, point_filter_num, blind, header_time,
        int(given_offset_time), ctypes.byref(let),
        _ptr(out, ctypes.c_double))
    return out[:m], let.value


def process_spinning_numpy(xyzt: np.ndarray, ring: Optional[np.ndarray],
                           n_scans: int, scan_rate: int,
                           point_filter_num: int, blind: float,
                           header_time: float, given_offset_time: bool,
                           last_end_time: float) -> Tuple[np.ndarray, float]:
    """Plain version of `process_spinning`, in the C++'s float64
    arithmetic (yaw in degrees by the reference's 57.2957)."""
    xyzt = np.asarray(xyzt, np.float32)
    n = xyzt.shape[0]
    x, y, z = (xyzt[:, j].astype(np.float64) for j in range(3))
    if given_offset_time:
        t_rel = xyzt[:, 3].astype(np.float64)
    else:
        omega = 0.361 * scan_rate
        layer = (np.asarray(ring, np.int64) if ring is not None
                 else np.zeros(n, np.int64))
        # libm's atan2 point by point, as the C++ calls it (numpy's
        # vectorized arctan2 can differ in the last bit)
        yaw = np.array([math.atan2(b, a) for a, b in zip(x, y)],
                       np.float64).reshape(n) * 57.2957
        t_rel = np.zeros(n)
        for lay in np.unique(layer[(layer >= 0) & (layer < n_scans)]):
            sel = np.nonzero(layer == lay)[0]
            y0 = yaw[sel[0]]
            d = np.where(yaw[sel] <= y0, (y0 - yaw[sel]) / omega,
                         (y0 - yaw[sel] + 360.0) / omega)
            d[0] = 0.0
            t_rel[sel] = d
    order = np.argsort(t_rel, kind="stable")
    dt_last = t_rel[order[-1]] if n else 0.0
    keep = np.ones(n, bool)
    if point_filter_num > 1:
        keep = np.arange(n) % point_filter_num == 0
    o = order
    ts = header_time + t_rel[o] / 1000.0
    keep &= ((x[o] * x[o] + y[o] * y[o] + z[o] * z[o] > blind * blind)
             & (ts > last_end_time))
    out = np.stack([x[o], y[o], z[o], ts], axis=1)[keep]
    return out, header_time + dt_last / 1000.0


def process_livox(xyz: np.ndarray, tag: np.ndarray, line: np.ndarray,
                  offset_ns: np.ndarray, n_scans: int, point_filter_num: int,
                  blind: float, header_time: float, last_end_time: float
                  ) -> Tuple[np.ndarray, float]:
    """Livox CustomMsg stream filter (livoxHandler, cloudProcessing.cpp:
    125-214): line, range, tag and duplicate filters (the first point is
    skipped, as the reference's loop starts at 1), time sort, decimation,
    blind filter.  `last_end_time` is only passed through, as in the
    reference.  Returns (out (m, 4) float64 with absolute times,
    new_last_end_time)."""
    xyz32 = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    n = xyz32.shape[0]
    tag8 = np.ascontiguousarray(tag, np.uint8)
    line8 = np.ascontiguousarray(line, np.uint8)
    off32 = np.ascontiguousarray(offset_ns, np.uint32)
    if not tag8.shape == line8.shape == off32.shape == (n,):
        raise ValueError("tag, line and offset_ns need one entry per point")
    out = np.empty((n, 4), np.float64)
    let = ctypes.c_double(last_end_time)
    m = get_lib().livo_process_livox(
        _ptr(xyz32, ctypes.c_float), tag8.tobytes(), line8.tobytes(),
        _ptr(off32, ctypes.c_uint32), n, n_scans, point_filter_num, blind,
        header_time, ctypes.byref(let), _ptr(out, ctypes.c_double))
    return out[:m], let.value


def process_livox_numpy(xyz: np.ndarray, tag: np.ndarray, line: np.ndarray,
                        offset_ns: np.ndarray, n_scans: int,
                        point_filter_num: int, blind: float,
                        header_time: float, last_end_time: float
                        ) -> Tuple[np.ndarray, float]:
    """Plain version of `process_livox`: float32 filters, float64 times
    and ranges, as the C++."""
    xyz = np.asarray(xyz, np.float32)
    tag = np.asarray(tag, np.uint8)
    line = np.asarray(line)
    n = xyz.shape[0]
    if n < 2:
        return np.zeros((0, 4)), header_time
    i = np.arange(1, n)
    p = xyz[i]
    ok = (line[i] < n_scans) & (np.abs(p) <= np.float32(1e8)).all(axis=-1)
    ok &= p[:, 0] > np.float32(0.7)
    bad_tag = ((tag[i] & 0x03) != 0) | ((tag[i] & 0x0C) != 0)
    ok &= ~((p[:, 0] > np.float32(2.0)) & bad_tag)
    ok &= ~np.all(np.abs(p - xyz[i - 1]) <= np.float32(1e-7), axis=-1)
    sel = i[ok]
    t_ms = np.asarray(offset_ns, np.uint32)[sel].astype(np.float64) * 1e-6
    order = np.argsort(t_ms, kind="stable")
    sel, t_ms = sel[order], t_ms[order]
    dt_last = t_ms[-1] if len(t_ms) else 0.0
    keep = np.ones(len(sel), bool)
    if point_filter_num > 1:
        keep = np.arange(1, len(sel) + 1) % point_filter_num == 0
    q = xyz[sel].astype(np.float64)
    keep &= (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
             > blind * blind)
    out = np.concatenate([q[keep], (header_time + t_ms[keep] / 1000.0)
                          [:, None]], axis=1)
    return out, header_time + dt_last / 1000.0


# ---------------------------------------------------------------------------
# ROS1 bag reader
# ---------------------------------------------------------------------------

class BagReader:
    """Minimal ROS1 v2.0 bag reader over the native library: iterates
    (topic, msg_type, record time, payload bytes).  A file that is no bag
    raises IOError on open; a malformed record, a lying length field or a
    chunk that does not decompress raises IOError while iterating."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.livo_bag_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open bag: {path}")

    def __iter__(self):
        c = ctypes
        conn = c.c_int32()
        t = c.c_double()
        data = c.POINTER(c.c_uint8)()
        ln = c.c_long()
        while True:
            if not self._h:
                raise IOError("bag reader is closed")
            rc = self._lib.livo_bag_next(self._h, c.byref(conn), c.byref(t),
                                         c.byref(data), c.byref(ln))
            if rc == 0:
                return
            if rc < 0:
                raise IOError("bag read error: "
                              + self._lib.livo_bag_error(self._h).decode())
            topic = self._lib.livo_bag_topic(self._h, conn.value).decode()
            msg_type = self._lib.livo_bag_type(self._h, conn.value).decode()
            payload = ctypes.string_at(data, ln.value)
            yield topic, msg_type, t.value, payload

    def close(self):
        if self._h:
            self._lib.livo_bag_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
