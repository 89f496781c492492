"""The port's native ingest library (sr_livo_tpu_torch.runtime.native)
against the JAX package's (sr_livo_tpu.runtime.native, native C++) and
against the port's own plain numpy versions, on seeded inputs.

Every entry is bit-exact with both: the decoders, the spinning and Livox
stream filters, the host remap and the fused int16 wire pack (the wire,
its scale and the point count, also against the port's plain
`prepare_sweep` + `pack_sweep`).  The bag reader reads the bags that
`tests/rosbag_writer.py` writes, uncompressed, bz2 and lz4, and fails
cleanly (IOError) on the corrupt bags of test_ingest.py.  The library is
built from the port's own source into `build/native/`.
"""
import os
import struct

import numpy as np
import pytest

from sr_livo_tpu.runtime import native as jnative
from sr_livo_tpu_torch import kernels
from sr_livo_tpu_torch.config import LivoConfig as TCfg
from sr_livo_tpu_torch.runtime import measurements as tmeas
from sr_livo_tpu_torch.runtime import native
from sr_livo_tpu_torch.runtime.remap import remap_u8 as remap_u8_numpy
from tests import rosbag_writer as rbw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(*outs):
    """Every output equal to the first, dtype and bits."""
    for o in outs[1:]:
        if isinstance(o, tuple):
            assert len(o) == len(outs[0])
            for a, b in zip(outs[0], o):
                _equal(a, b)
        else:
            a, b = np.asarray(outs[0]), np.asarray(o)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_library_is_the_port_copy_built_under_build_native():
    lib = native.get_lib()
    path = kernels.library_path("livo_native")
    assert path.parent == kernels.NATIVE_DIR
    assert os.path.relpath(path, REPO).startswith(
        os.path.join("build", "native") + os.sep)
    assert path.exists() and lib._name == str(path)
    assert kernels._source("livo_native")[0].name == "livo_native.cpp"
    assert kernels._source("livo_native")[0].parent == kernels.CSRC


def _cloud(rng, n, step, t_dtype, t_values):
    """A packed point payload: x, y, z float32 at 0, 4, 8; the time at 12
    in `t_dtype`; a u8 ring at step - 3 and a u16 ring at step - 2."""
    buf = np.zeros((n, step), np.uint8)
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    buf[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    dtype = {1: np.float32, 2: np.float64, 3: np.uint32}.get(t_dtype)
    if dtype is not None:
        t = np.asarray(t_values).astype(dtype)
        buf[:, 12:12 + t.itemsize] = t.view(np.uint8).reshape(n, -1)
    buf[:, step - 3] = rng.randint(0, 256, n)
    buf[:, step - 2:] = rng.randint(0, 65536, n).astype(np.uint16) \
        .view(np.uint8).reshape(n, 2)
    return buf.tobytes()


DECODE_CASES = {
    # t_dtype, time values, time_unit_scale, t_base
    "no_time": (0, None, 1.0, 0.0),
    "f32_seconds": (1, np.linspace(0, 0.099, 500), 1e3, 0.0),
    "f32_ms": (1, np.linspace(0, 99.3, 500), 1e-3, 0.0),
    "f64_robosense_abs": (2, 1.7e9 + 321.0 + np.linspace(0, 0.095, 500),
                          1e3, 1.7e9 + 321.0),
    "u32_ns": (3, np.linspace(0, 99.9e6, 500), 1e-6, 0.0),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_xyzt_bit_exact(case):
    t_dtype, t_values, scale, t_base = DECODE_CASES[case]
    rng = np.random.RandomState(1 + t_dtype)
    step = 24
    data = _cloud(rng, 500, step, t_dtype, t_values)
    args = (data, 500, step, 0, 4, 8, 12, t_dtype, scale)
    _equal(native.decode_xyzt(*args, t_base=t_base),
           jnative.decode_xyzt(*args, t_base=t_base),
           native.decode_xyzt_numpy(*args, t_base=t_base))


@pytest.mark.parametrize("ring_dtype", [1, 2])
def test_decode_ring_bit_exact(ring_dtype):
    rng = np.random.RandomState(7)
    step = 24
    data = _cloud(rng, 300, step, 0, None)
    off = step - 3 if ring_dtype == 1 else step - 2
    args = (data, 300, step, off, ring_dtype)
    _equal(native.decode_ring(*args), jnative.decode_ring(*args),
           native.decode_ring_numpy(*args))


def test_decoders_reject_short_payloads():
    with pytest.raises(ValueError):
        native.decode_xyzt(b"\0" * 100, 10, 16, 0, 4, 8, 12, 1, 1.0)
    with pytest.raises(ValueError):
        native.decode_ring(b"\0" * 160, 10, 16, 15, 2)


def _spinning_input(rng, given):
    n_rings, per_ring = 16, 120
    az = np.concatenate([np.sort(rng.uniform(-np.pi, np.pi, per_ring))[::-1]
                         for _ in range(n_rings)])
    r = rng.uniform(0.2, 30.0, az.size)
    xyzt = np.zeros((az.size, 4), np.float32)
    xyzt[:, 0] = r * np.cos(az)
    xyzt[:, 1] = r * np.sin(az)
    xyzt[:, 2] = rng.uniform(-2, 2, az.size)
    xyzt[:, 3] = rng.uniform(0, 99.0, az.size) if given else 0.0
    ring = np.repeat(np.arange(n_rings), per_ring).astype(np.int32)
    ring[::37] = n_rings + 3                    # out-of-range rings
    perm = rng.permutation(az.size)
    return xyzt[perm], ring[perm]


@pytest.mark.parametrize("given", [True, False],
                         ids=["given_time", "yaw_synthesis"])
@pytest.mark.parametrize("filter_num", [1, 3])
def test_process_spinning_bit_exact(given, filter_num):
    rng = np.random.RandomState(11 + filter_num)
    xyzt, ring = _spinning_input(rng, given)
    # the first call with no history, the second gated by the first's
    # end time (a replayed stamp keeps only the later points)
    for header, last_end in ((100.0, -1.0), (100.05, 100.098)):
        args = (xyzt, ring, 16, 10, filter_num, 1.0, header, given, last_end)
        got = native.process_spinning(*args)
        _equal(got, jnative.process_spinning(*args),
               native.process_spinning_numpy(*args))
        assert 0 < got[0].shape[0] < xyzt.shape[0]
    args = (xyzt, None, 16, 10, filter_num, 1.0, 7.0, given, -1.0)
    _equal(native.process_spinning(*args),
           native.process_spinning_numpy(*args))


def _livox_args(filter_num, n=600):
    """A Livox message with near, bad-tag, bad-line, duplicate and
    out-of-range points, as `process_livox` arguments."""
    rng = np.random.RandomState(21 + filter_num)
    xyz = np.c_[rng.uniform(0.2, 25.0, n), rng.uniform(-5, 5, n),
                rng.uniform(-2, 2, n)].astype(np.float32)
    tag = np.zeros(n, np.uint8)
    tag[rng.choice(n, 40)] = rng.choice([0x01, 0x04, 0x10], 40)
    line = (np.arange(n) % 6).astype(np.uint8)
    line[rng.choice(n, 10)] = 9
    xyz[50:55] = xyz[49]                          # duplicates
    xyz[60, 1] = 3e8                              # out of range
    offset_ns = rng.randint(0, 100_000_000, n).astype(np.uint32)
    return (xyz, tag, line, offset_ns, 6, filter_num, 1.0, 77.0, -1.0)


@pytest.mark.parametrize("filter_num", [1, 2])
def test_process_livox_bit_exact(filter_num):
    args = _livox_args(filter_num)
    got = native.process_livox(*args)
    _equal(got, jnative.process_livox(*args),
           native.process_livox_numpy(*args))
    assert 0 < got[0].shape[0] < args[0].shape[0] - 40


def _remap_args(channels, h=96, w=128):
    """A uint8 image and a warped 60 x 80 map with clamped corners."""
    rng = np.random.RandomState(31 + channels)
    img = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img
    ys, xs = np.meshgrid(np.arange(60), np.arange(80), indexing="ij")
    m = np.stack([xs * 1.58 + 3.0 * np.sin(ys / 5.0) - 1.0,
                  ys * 1.59 + 2.0 * np.cos(xs / 7.0) - 1.0],
                 -1).astype(np.float32)
    m[0, :4] = [[-3.0, -3.0], [w + 4.0, h + 4.0], [w - 1.0, h - 1.0],
                [w - 1.0005, h - 1.0005]]
    return img, m


@pytest.mark.parametrize("channels", [1, 3])
def test_remap_u8_bit_exact(channels):
    img, m = _remap_args(channels)
    got = native.remap_u8(img, m)
    _equal(got, jnative.remap_u8(img, m), remap_u8_numpy(img, m))
    assert got.shape == ((60, 80, 3) if channels == 3 else (60, 80))


PACK_CASES = {"empty": (0, 1024), "normal": (700, 1024),
              "overflow": (5000, 1024), "single_slot": (9, 1)}


def _pack_case(n, max_points, begin=0.0, end=0.1):
    """A sweep's points (some outside [begin, end]) and the plain pack of
    them: (points, (int16 wire, scale, count))."""
    rng = np.random.RandomState(41 + n)
    pts = np.zeros((n, 4))
    pts[:, :3] = rng.uniform(-80.0, 80.0, (n, 3)) * rng.uniform(0.05, 1, (n, 1))
    pts[:, 3] = np.sort(rng.uniform(-0.01, 0.105, n))
    cfg = TCfg()
    cfg.shapes.max_sweep_points = max_points
    cfg.shapes.max_imu_samples = 8
    meas = tmeas.Measurement(
        time_image=end, time_sweep_begin=begin, duration=end - begin,
        rendering=False, imu=[(end, np.zeros(3), np.zeros(3))], points=pts)
    prep = tmeas.prepare_sweep(meas, begin, cfg)
    wire = tmeas.pack_sweep(prep, end - begin)
    return pts, (wire.pts_q, wire.scale, prep.n_points)


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_prepare_pack_bit_exact(case):
    """The fused pack against the JAX native pack and against the port's
    plain prepare_sweep + pack_sweep: the int16 wire, scale and count."""
    n, max_points = PACK_CASES[case]
    begin, end = 0.0, 0.1
    pts, plain = _pack_case(n, max_points, begin, end)
    got = native.prepare_pack(pts, begin, end, end - begin, max_points)
    _equal(got, jnative.prepare_pack(pts, begin, end, end - begin,
                                     max_points), plain)
    in_window = int(((pts[:, 3] >= begin) & (pts[:, 3] <= end)).sum())
    assert got[2] == min(in_window, max_points)
    assert (got[0][got[2]:] == -1).all()


def test_prepare_pack_rejects_no_slots():
    with pytest.raises(ValueError):
        native.prepare_pack(np.zeros((3, 4)), 0.0, 0.1, 0.1, 0)


# ---- the bag reader ------------------------------------------------------

def _lz4_block(raw: bytes) -> bytes:
    """An LZ4 block holding `raw` as one literal run (a valid block that
    LZ4_decompress_safe expands to `raw`)."""
    n = len(raw)
    if n < 15:
        return bytes([n << 4]) + raw
    out, rest = bytearray([0xF0]), n - 15
    while rest >= 255:
        out.append(255)
        rest -= 255
    out.append(rest)
    return bytes(out) + raw


def _fields(header: bytes) -> dict:
    out, pos = {}, 0
    while pos < len(header):
        (flen,) = struct.unpack_from("<I", header, pos)
        name, value = header[pos + 4:pos + 4 + flen].split(b"=", 1)
        out[name.decode()] = value
        pos += 4 + flen
    return out


def _recompress_lz4(src: str, dst: str) -> None:
    """Rewrite an uncompressed bag with every chunk lz4-compressed."""
    raw = open(src, "rb").read()
    out, pos = bytearray(raw[:13]), 13
    while pos < len(raw):
        (hlen,) = struct.unpack_from("<I", raw, pos)
        header = raw[pos + 4:pos + 4 + hlen]
        (dlen,) = struct.unpack_from("<I", raw, pos + 4 + hlen)
        data = raw[pos + 8 + hlen:pos + 8 + hlen + dlen]
        rec = raw[pos:pos + 8 + hlen + dlen]
        fields = _fields(header)
        if fields["op"] == rbw._op(0x05):
            rec = rbw._record({"op": rbw._op(0x05), "compression": "lz4",
                               "size": len(data)}, _lz4_block(data))
        out += rec
        pos += 8 + hlen + dlen
    open(dst, "wb").write(bytes(out))


def _messages(rng):
    img = rng.randint(0, 255, (8, 12, 3)).astype(np.uint8)
    return [("/imu", "sensor_msgs/Imu", 10.0 + 0.005 * k,
             rbw.ser_imu(10.0 + 0.005 * k, rng.randn(3), rng.randn(3)))
            for k in range(20)] + [
        ("/cam", "sensor_msgs/Image", 10.01, rbw.ser_image_rgb8(10.01, img)),
        ("/livox/lidar", "livox_ros_driver/CustomMsg", 10.02,
         rbw.ser_livox_custom(10.02, rng.uniform(1, 9, (50, 3)),
                              np.zeros(50, np.uint8),
                              np.zeros(50, np.uint8),
                              np.arange(50, dtype=np.uint32)))]


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_reader_matches_jax(tmp_path, compression):
    msgs = _messages(np.random.RandomState(3))
    path = str(tmp_path / "bag.bag")
    w = rbw.BagWriter(path, compression="bz2" if compression == "bz2"
                      else "none")
    for m in msgs:
        w.write_message(*m)
    w.close()
    if compression == "lz4":
        _recompress_lz4(path, str(tmp_path / "lz4.bag"))
        path = str(tmp_path / "lz4.bag")
        assert b"compression=lz4" in open(path, "rb").read()
    with native.BagReader(path) as reader:
        got = list(reader)
    assert got == list(jnative.BagReader(path))
    assert [(t, ty, p) for t, ty, _, p in got] == [
        (t, ty, p) for t, ty, _, p in msgs]
    assert np.allclose([s for _, _, s, _ in got], [s for _, _, s, _ in msgs],
                       atol=1e-6)


def _tiny_bag(path):
    w = rbw.BagWriter(str(path))
    for i in range(4):
        w.write_message("/imu", "sensor_msgs/Imu", 0.1 * (i + 1),
                        rbw.ser_imu(0.1 * (i + 1), [0, 0, 9.8], [0, 0, 0]))
    w.close()
    return open(str(path), "rb").read()


def _corrupt(raw: bytes, case: str) -> bytes:
    """The corrupt bags of test_ingest.py:397-470."""
    (hlen,) = struct.unpack_from("<I", raw, 13)
    if case == "lying_header_length":
        return raw[:13] + struct.pack("<I", 0xFFFFFFF0) + raw[17:]
    if case == "lying_data_length":
        dpos = 13 + 4 + hlen
        return raw[:dpos] + struct.pack("<I", 0xFFFFFFF0) + raw[dpos + 4:]
    if case == "garbage_tail":
        bad = b"nonsense-without-separator"
        return raw + struct.pack("<I", len(bad)) + bad + struct.pack("<I", 0)
    if case == "unknown_compression":
        return raw + rbw._record({"op": rbw._op(0x05), "compression": b"zstd",
                                  "size": np.uint32(64).tobytes()},
                                 b"\x00" * 32)
    if case == "lz4_garbage":
        return raw + rbw._record({"op": rbw._op(0x05), "compression": b"lz4",
                                  "size": np.uint32(512).tobytes()},
                                 b"\xde\xad" * 16)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["lying_header_length", "lying_data_length",
                                  "garbage_tail", "unknown_compression",
                                  "lz4_garbage"])
def test_bag_reader_raises_on_corrupt_bags(tmp_path, case):
    raw = _tiny_bag(tmp_path / "ok.bag")
    with native.BagReader(str(tmp_path / "ok.bag")) as reader:
        assert len(list(reader)) == 4
    p = tmp_path / f"{case}.bag"
    p.write_bytes(_corrupt(raw, case))
    for reader in (native.BagReader(str(p)), jnative.BagReader(str(p))):
        with pytest.raises(IOError):
            list(reader)


def test_bag_reader_truncated_and_fuzzed(tmp_path):
    """Truncation mid-record stops cleanly or raises IOError, as the JAX
    reader does; random byte corruption never crashes the process."""
    raw = _tiny_bag(tmp_path / "ok.bag")
    p = tmp_path / "trunc.bag"
    p.write_bytes(raw[:-11])
    try:
        assert len(list(native.BagReader(str(p)))) <= 4
    except IOError:
        pass
    rng = np.random.RandomState(5)
    for trial in range(40):
        buf = bytearray(raw)
        for _ in range(rng.randint(1, 4)):
            buf[rng.randint(13, len(buf))] = rng.randint(0, 256)
        p = tmp_path / f"fuzz{trial}.bag"
        p.write_bytes(bytes(buf))
        try:
            got = list(native.BagReader(str(p)))
        except IOError as e:
            with pytest.raises(IOError):
                list(jnative.BagReader(str(p)))
            assert "bag" in str(e)
        else:
            assert got == list(jnative.BagReader(str(p)))
            assert len(got) <= 8


def test_bag_reader_rejects_a_file_that_is_no_bag(tmp_path):
    p = tmp_path / "not.bag"
    p.write_bytes(b"#ROSBAG V1.2\n" + b"\0" * 64)
    with pytest.raises(IOError):
        native.BagReader(str(p))
    with pytest.raises(IOError):
        native.BagReader(str(tmp_path / "missing.bag"))
