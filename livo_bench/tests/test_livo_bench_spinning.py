"""CPU tests of a spinning LiDAR faster than the camera: the frozen Ouster
driver filter against the port's, a tiny cell whose every frame yields a
gap-fill sweep and an image-aligned one, run through the harness, and a
fault on the gap-fill sweeps alone, which the check has to catch.

    python -m pytest -q livo_bench/tests
"""

import numpy as np
import pytest
import torch

from livo_bench import harness
from livo_bench.gen import synthetic, traffic
from livo_bench.tests import tiny


@pytest.fixture(scope="module")
def spinning():
    """The tiny spinning cell's configuration and a few of its simulated
    packets (chunks of one sweep interval)."""
    from livo_bench.ref.config import load_config
    wl, config, mix, limits = tiny.spinning_spec()
    cfg = harness.make_config(config, load_config)
    lidar = mix["lidar"]
    sim = synthetic.simulate(
        duration=0.4, sweep_rate=mix["rates_hz"]["lidar"],
        dirs_phase=traffic.lidar_directions(lidar),
        world=traffic.world(mix["world"]), traj=traffic.trajectory(
            mix["trajectory"]), seed=5, device="cpu")
    return cfg.lidar_options, [c for c in sim.lidar_chunks if c.shape[0]]


def test_spinning_cell_is_the_ntu_driver(spinning):
    lo, chunks = spinning
    assert lo.n_scans == 16 and lo.scan_rate == 20 and lo.time_unit == 3
    assert lo.blind == 4 and lo.point_filter_num == 4
    assert len(chunks) >= 6


@pytest.mark.parametrize("given", [True, False])
def test_spinning_filter_equals_the_port(spinning, given):
    """`gen/traffic.py`'s frozen filter and the port's plain one, bit for
    bit, packet by packet with the last end time carried over; the third
    packet is sent twice, half a packet late, so the time gate drops
    points."""
    from sr_livo_tpu_torch.runtime import native
    lo, chunks = spinning
    stream = chunks[:3] + [chunks[2][len(chunks[2]) // 2:]] + chunks[3:6]
    mine = port = -1.0
    dropped = 0
    for chunk in stream:
        stamp = float(chunk[0, 3])
        xyzt = np.concatenate([chunk[:, :3], (chunk[:, 3:] - stamp) * 1e3],
                              axis=1).astype(np.float32)
        ring = (np.arange(len(chunk)) % 16).astype(np.int32)
        args = (xyzt, ring, lo.n_scans, lo.scan_rate, lo.point_filter_num,
                lo.blind, stamp, given)
        a, mine_next = traffic.spinning_filter(*args, mine)
        b, port_next = native.process_spinning_numpy(*args, port)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert mine_next == port_next
        n_kept = traffic.spinning_filter(*args, -1.0)[0].shape[0]
        dropped += n_kept - a.shape[0]
        mine, port = mine_next, port_next
    if given:
        # the late half-packet lies before the last end time
        assert dropped > 0


def test_ouster_packet_equals_the_ports_bag_path(spinning):
    """A packet as the gate writes an Ouster bag (`ser_pointcloud2_ouster`)
    and the port's driver reads it (`parse_pointcloud2`, the plain decode
    and filter), against `traffic.ouster_packet`: the same points, bit
    for bit, stamped at the packet's first point."""
    from sr_livo_tpu_torch.runtime import bag_writer, drivers, native
    lo, chunks = spinning
    mine = port = -1.0
    for chunk in chunks[:4]:
        stamp = float(chunk[0, 3])
        n = chunk.shape[0]
        t_ns = np.round((chunk[:, 3] - stamp) * 1e9).astype(np.uint32)
        ring = (np.arange(n) % 16).astype(np.uint8)
        pc = drivers.parse_pointcloud2(bag_writer.ser_pointcloud2_ouster(
            stamp, chunk[:, :3].astype(np.float32), t_ns, ring))
        step = pc.point_step
        xyzt = native.decode_xyzt_numpy(
            pc.data, n, step, pc.fields["x"][0], pc.fields["y"][0],
            pc.fields["z"][0], pc.fields["t"][0], 3, 1e-6)
        given = bool(xyzt[-1, 3] > 0)
        assert given
        b, port = native.process_spinning_numpy(
            xyzt, None, lo.n_scans, lo.scan_rate, lo.point_filter_num,
            lo.blind, stamp, given, port)
        a, mine = traffic.ouster_packet(chunk, lo, 16, mine)
        assert np.array_equal(a, b) and mine == port
        assert a.shape[0] > 0


def gap_fill_pose_altered(pipe):
    """The answer altered where it is produced, on the sweeps without an
    image alone: their pose record moved by 1 cm."""
    process, step = pipe._process_measurement, pipe.engine.step
    rendering = [True]

    def measurement(meas, *a, **kw):
        rendering[0] = meas.rendering
        return process(meas, *a, **kw)

    def broken(*a, **kw):
        out = step(*a, **kw)
        if rendering[0]:
            return out
        rec = out.record.clone()
        rec[0] += 0.01
        return out._replace(record=rec)
    pipe._process_measurement = measurement
    pipe.engine.step = broken


def run_spinning(fault=None, seed=2 ** 31 + 77):
    torch.set_num_threads(4)
    return harness.run("ntu_tiny.livo", seed, 8.0, False, device="cpu",
                       spec=tiny.spinning_spec(), fault=fault)


def test_spinning_cell_two_poses_a_frame():
    out = run_spinning()
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["per_segment"]
    # every window frame: a gap-fill sweep, then the image-aligned one
    assert set(out["poses"]) == {2}
    assert out["completed"] >= 2 * out["attempted"] - 2
    assert set(out["numbers"]) == {
        "pose_m", "rot_rad", "map_rows", "map_m", "color_rows", "color_m",
        "track_px", "ate_m"}


def test_gap_fill_fault_is_caught_by_pose_m():
    out = run_spinning(gap_fill_pose_altered)
    assert not out["correct"]
    assert out["numbers"]["pose_m"] > out["limits"]["pose_m"], out["numbers"]
