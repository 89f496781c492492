"""The port's live output (sr_livo_tpu_torch.runtime.streaming) against
the JAX package's, on the 7 s LIVO run of test_streaming.py.

Both pipelines stream into their own directories: the port's files grow
while frames remain, `odometry_live.txt` and `path_live.txt` have the JAX
run's line counts, the odometry rows agree within 1e-3 (the time column
exactly), the last row equals the port's own last record, and the chunks
are PCDs.  On the same registry snapshots the chunk publisher writes the
JAX package's chunk files byte for byte (late-maturing rows included),
scripts/live_viewer.py renders the port's directory unchanged, and with
frame retirement on, retired frames live only in the stream.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sr_livo_tpu.models.vision import VisionModule as JVision
from sr_livo_tpu.ops.color_map import C_NRGB, C_POS, C_VALID, REG_WIDTH
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.runtime import streaming as jstream
from sr_livo_tpu.runtime import synthetic as jsyn
from sr_livo_tpu_torch.models.vision import VisionModule as TVision
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.runtime import streaming as tstream
from tests.test_streaming import CAM, SIZE, _cfg
from tests.test_torch_vision import _port_cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUB = dict(path_stride=5, map_every_n_frames=3, pub_point_minimum_views=1)


def _cut(pipe, sim):
    for (t, a, g) in sim.imu:
        pipe.push_imu(t, a, g)
    for c in sim.lidar_chunks:
        pipe.push_points(c)
    for (t, img) in sim.images:
        pipe.push_image(t, img)
    meas = []
    while True:
        m = pipe.cutter.get()
        if m is None:
            return meas
        meas.append(m)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    sim = jsyn.simulate(duration=7.0, n_azimuth=100, n_rings=12, seed=6,
                        image_size=SIZE, camera=CAM)
    jdir = str(tmp_path_factory.mktemp("jax_live"))
    jpub = jstream.StreamPublisher(jdir, **PUB)
    jp = JPipe(_cfg(), vision=JVision(_cfg()), stream=jpub)
    for m in _cut(jp, sim):
        jp._process_measurement(m)
    jpub.close()

    tdir = str(tmp_path_factory.mktemp("port_live"))
    tpub = tstream.StreamPublisher(tdir, **PUB)
    cfg = _port_cfg(_cfg())
    tp = TPipe(cfg, vision=TVision(cfg, device="cpu"), stream=tpub,
               device="cpu")
    meas = _cut(tp, sim)
    mid = len(meas) - 5
    for m in meas[:mid]:
        tp._process_measurement(m)
    tpub.flush()
    n_mid = len(tstream.read_live_trajectory(tdir)[0])
    chunks_mid = os.listdir(os.path.join(tdir, "color_chunks"))
    path_mid = os.path.getsize(os.path.join(tdir, "path_live.txt"))
    for m in meas[mid:]:
        tp._process_measurement(m)
    tpub.close()
    return (jdir, jp), (tdir, tp, tpub), (n_mid, chunks_mid, path_mid)


def _lines(d, name):
    with open(os.path.join(d, name)) as f:
        return f.read().splitlines()


def test_port_files_grow_mid_run(streams):
    _, (tdir, tp, tpub), (n_mid, chunks_mid, path_mid) = streams
    assert tpub.last_error is None
    assert n_mid > 5 and chunks_mid and path_mid > 0
    ts, ps, qs, _ = tstream.read_live_trajectory(tdir)
    recs = tp.records
    assert len(ts) == len(recs) > n_mid
    assert np.allclose(ps[-1], recs[-1].position, atol=1e-6)
    assert np.allclose(qs[-1], recs[-1].quat_wxyz, atol=1e-6)
    chunks = sorted(os.listdir(os.path.join(tdir, "color_chunks")))
    assert len(chunks) >= len(chunks_mid)
    with open(os.path.join(tdir, "color_chunks", chunks[0]), "rb") as f:
        assert f.read(200).startswith(b"# .PCD")


def test_live_files_match_jax(streams):
    (jdir, _), (tdir, _, _), _ = streams
    for name in ("odometry_live.txt", "path_live.txt"):
        assert len(_lines(tdir, name)) == len(_lines(jdir, name)) > 5, name
    jrows = np.loadtxt(os.path.join(jdir, "odometry_live.txt"), ndmin=2)
    trows = np.loadtxt(os.path.join(tdir, "odometry_live.txt"), ndmin=2)
    np.testing.assert_array_equal(trows[:, 0], jrows[:, 0])
    assert np.abs(trows - jrows).max() < 1e-3


def test_chunks_of_late_maturing_rows_match_jax(tmp_path):
    """test_streaming.py's three registry ticks through both publishers:
    the same two chunk files, byte for byte, with every row published
    exactly once."""
    def snapshot(n_rgb_by_row):
        reg = np.zeros((64, REG_WIDTH), np.float32)
        for i, nv in n_rgb_by_row.items():
            reg[i, C_POS] = (float(i), 0.0, 0.0)
            reg[i, C_VALID] = 1.0
            reg[i, C_NRGB] = nv
        return reg

    nv2 = {i: (4 if i < 5 else 1) for i in range(10)}
    nv2.update({i: (5 if i >= 12 else 2) for i in range(10, 15)})
    ticks = [(snapshot({i: 1 for i in range(10)}), 10),
             (snapshot(nv2), 15),
             (snapshot({i: 6 for i in range(15)}), 15)]
    dirs = {}
    for name, mod in (("jax", jstream), ("port", tstream)):
        dirs[name] = str(tmp_path / name)
        pub = mod.StreamPublisher(dirs[name], pub_point_minimum_views=3)
        for reg, count in ticks:
            if mod is tstream:
                reg, count = torch.as_tensor(reg), torch.tensor(count)
            pub._write_chunk((reg, count))
        pub.close()
    chunks = sorted(os.listdir(os.path.join(dirs["port"], "color_chunks")))
    assert chunks == sorted(os.listdir(os.path.join(dirs["jax"],
                                                    "color_chunks")))
    assert len(chunks) == 2
    for c in chunks:
        with open(os.path.join(dirs["port"], "color_chunks", c), "rb") as f:
            port = f.read()
        with open(os.path.join(dirs["jax"], "color_chunks", c), "rb") as f:
            assert port == f.read()


def test_path_live_written_with_stride_one(tmp_path):
    pub = tstream.StreamPublisher(str(tmp_path / "p1"), path_stride=1)
    rec = torch.zeros(19)
    pub.publish_frame(1.0, rec)
    pub.publish_frame(2.0, rec)
    pub.close()
    assert len(_lines(str(tmp_path / "p1"), "path_live.txt")) == 2


def test_live_viewer_reads_port_files(streams, tmp_path):
    _, (tdir, _, _), _ = streams
    png = str(tmp_path / "view.png")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "live_viewer.py"),
         tdir, "--once", "--out", png], capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    assert os.path.getsize(png) > 10_000


def test_retirement_with_a_stream_drops_retired_frames(tmp_path):
    """With a StreamPublisher attached, retired frames live only in
    odometry_live.txt: the pipeline neither starts nor appends pose.txt,
    and the stream holds every frame."""
    sim = jsyn.simulate(duration=6.0, n_azimuth=80, n_rings=10, seed=6)
    cfg = _port_cfg(_cfg())
    cfg.output_path = str(tmp_path / "out")
    cfg.retire_frames = True
    cfg.retire_batch = 4
    pub = tstream.StreamPublisher(str(tmp_path / "live"))
    pipe = TPipe(cfg, stream=pub, device="cpu")
    for m in _cut(pipe, sim):
        pipe._process_measurement(m)
    pub.close()
    live = len(pipe._pending_records) + len(pipe._records)
    assert live <= 2 + cfg.retire_batch and pipe.n_retired > 10
    ts = tstream.read_live_trajectory(str(tmp_path / "live"))[0]
    assert len(ts) == pipe.n_retired + live
    assert not os.path.exists(os.path.join(cfg.output_path, "pose.txt"))
