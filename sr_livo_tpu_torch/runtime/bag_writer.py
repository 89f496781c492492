"""Minimal ROS1 bag v2.0 writer and the serializers of the messages the
accuracy gate records.

The port's own copy of the parts of the repository's test fixture
(`tests/rosbag_writer.py`) that the gate uses: the bag layout (bag header
record, uncompressed chunks of connection and message-data records) and
the serializers of sensor_msgs/Imu, livox_ros_driver/CustomMsg, an
Ouster sensor_msgs/PointCloud2, sensor_msgs/Image (rgb8) and
sensor_msgs/CompressedImage (JPEG at quality 92), every header with
frame id "f".  They write the fixture's bytes for these settings; the
inverse is `runtime/drivers.py`'s parsers.
"""

from __future__ import annotations

import struct

import numpy as np


def _header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        if isinstance(v, int):
            v = struct.pack("<i", v) if k in ("conn",) else struct.pack("<I", v)
        elif isinstance(v, str):
            v = v.encode()
        field = k.encode() + b"=" + v
        out += struct.pack("<I", len(field)) + field
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _op(code: int) -> bytes:
    return struct.pack("<B", code)


class BagWriter:
    """Collects messages with `write_message` and writes the bag on
    `close`, in uncompressed chunks of about `CHUNK_TARGET` bytes."""

    # Real rosbags chunk at ~768 KB-4 MB; one giant chunk would trip the
    # reader's record-size cap on long sequences.
    CHUNK_TARGET = 8 << 20

    def __init__(self, path: str):
        self.path = path
        self.connections = {}     # topic -> (conn_id, type, conn_record)
        self.messages = []        # (conn_id, time, payload)

    def add_connection(self, topic: str, msg_type: str) -> int:
        if topic in self.connections:
            return self.connections[topic][0]
        cid = len(self.connections)
        conn_header = _header({"topic": topic, "type": msg_type,
                               "md5sum": "0" * 32,
                               "message_definition": ""})
        rec = _record({"op": _op(0x07), "conn": cid, "topic": topic},
                      conn_header)
        self.connections[topic] = (cid, msg_type, rec)
        return cid

    def write_message(self, topic: str, msg_type: str, t: float,
                      payload: bytes):
        cid = self.add_connection(topic, msg_type)
        self.messages.append((cid, t, payload))

    def close(self):
        chunks = []
        chunk = b"".join(c[2] for c in self.connections.values())
        for (cid, t, payload) in self.messages:
            sec = int(t)
            nsec = int(round((t - sec) * 1e9))
            time64 = struct.pack("<Q", (nsec << 32) | sec)
            chunk += _record({"op": _op(0x02), "conn": cid, "time": time64},
                             payload)
            if len(chunk) >= self.CHUNK_TARGET:
                chunks.append(chunk)
                chunk = b""
        if chunk:
            chunks.append(chunk)

        with open(self.path, "wb") as f:
            f.write(b"#ROSBAG V2.0\n")
            # bag header record (op 0x03), padded like real bags
            bh = _record({"op": _op(0x03),
                          "index_pos": struct.pack("<Q", 0),
                          "conn_count": len(self.connections),
                          "chunk_count": len(chunks)},
                         b" " * 4096)
            f.write(bh)
            for chunk in chunks:
                f.write(_record({"op": _op(0x05), "compression": "none",
                                 "size": len(chunk)}, chunk))


# ---- message serializers (inverse of runtime.drivers parsers) ----------

def ser_header(stamp: float) -> bytes:
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    return struct.pack("<III", 0, sec, nsec) + struct.pack("<I", 1) + b"f"


def ser_imu(stamp: float, acc, gyr) -> bytes:
    out = ser_header(stamp)
    out += struct.pack("<4d", 0, 0, 0, 1) + struct.pack("<9d", *([0] * 9))
    out += struct.pack("<3d", *gyr) + struct.pack("<9d", *([0] * 9))
    out += struct.pack("<3d", *acc) + struct.pack("<9d", *([0] * 9))
    return out


def _ser_pointcloud2(stamp: float, step: int, fields, data: np.ndarray
                     ) -> bytes:
    """PointCloud2 from a packed (n, step) uint8 array.  `fields` =
    [(name, offset, datatype, count), ...] (PointField codes: 2=u8,
    4=u16, 6=u32, 7=f32, 8=f64)."""
    n = data.shape[0]
    payload = data.tobytes()
    out = ser_header(stamp)
    out += struct.pack("<II", 1, n)
    out += struct.pack("<I", len(fields))
    for (name, off, dt, cnt) in fields:
        nm = name.encode()
        out += struct.pack("<I", len(nm)) + nm
        out += struct.pack("<IBI", off, dt, cnt)
    out += struct.pack("<B", 0)
    out += struct.pack("<II", step, step * n)
    out += struct.pack("<I", len(payload)) + payload
    out += struct.pack("<B", 1)
    return out


def ser_pointcloud2_ouster(stamp: float, xyz: np.ndarray,
                           t_ns: np.ndarray, ring: np.ndarray) -> bytes:
    """ouster_ros::Point layout (cloudProcessing.h Ouster struct): x, y, z,
    intensity f32 @0,4,8,12; t u32 ns @16; reflectivity u16 @20;
    ring u8 @22 (packed)."""
    n = xyz.shape[0]
    step = 23
    data = np.zeros((n, step), np.uint8)
    data[:, 0:12] = xyz.astype(np.float32).view(np.uint8).reshape(n, 12)
    data[:, 16:20] = t_ns.astype(np.uint32).view(np.uint8).reshape(n, 4)
    data[:, 22] = ring.astype(np.uint8)
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
              ("intensity", 12, 7, 1), ("t", 16, 6, 1),
              ("reflectivity", 20, 4, 1), ("ring", 22, 2, 1)]
    return _ser_pointcloud2(stamp, step, fields, data)


def ser_livox_custom(stamp: float, xyz: np.ndarray, tag: np.ndarray,
                     line: np.ndarray, offset_ns: np.ndarray) -> bytes:
    n = xyz.shape[0]
    out = ser_header(stamp)
    out += struct.pack("<Q", int(stamp * 1e9))
    out += struct.pack("<I", n)
    out += struct.pack("<B", 0) + b"\x00" * 3
    out += struct.pack("<I", n)
    rec = np.zeros((n, 19), np.uint8)
    rec[:, 0:4] = offset_ns.astype(np.uint32).view(np.uint8).reshape(n, 4)
    rec[:, 4:16] = xyz.astype(np.float32).view(np.uint8).reshape(n, 12)
    rec[:, 16] = 100
    rec[:, 17] = tag
    rec[:, 18] = line
    return out + rec.tobytes()


def ser_image_rgb8(stamp: float, img: np.ndarray) -> bytes:
    h, w, _ = img.shape
    out = ser_header(stamp)
    out += struct.pack("<II", h, w)
    enc = b"rgb8"
    out += struct.pack("<I", len(enc)) + enc
    out += struct.pack("<B", 0)
    out += struct.pack("<I", w * 3)
    payload = img.astype(np.uint8).tobytes()
    out += struct.pack("<I", len(payload)) + payload
    return out


def ser_compressed_image(stamp: float, img: np.ndarray) -> bytes:
    """sensor_msgs/CompressedImage with a real JPEG payload at quality 92
    (the r3live_compressed profile's image transport,
    lioOptimization.cpp:583-664 compressedImageHandler).  Pillow is
    imported here: only the compressed transport needs it."""
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG",
                                               quality=92)
    payload = buf.getvalue()
    out = ser_header(stamp)
    out += struct.pack("<I", 4) + b"jpeg"
    out += struct.pack("<I", len(payload)) + payload
    return out
