"""CPU tests of the benchmark's harness: lookup by name, the result line,
the lap replay, the statistics, the roofline and idle arithmetic.

    python -m pytest -q livo_bench/tests
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from livo_bench import harness, run
from livo_bench.gen import profile as gp
from livo_bench.gen import roofline, traffic
from livo_bench.tests import tiny

ROOT = harness.ROOT


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(workload):
    wl, config, mix, limits = harness.cell_spec(workload)
    assert wl["name"] == workload
    assert {"yaml", "overrides", "source", "assumed", "reduced"} <= set(config)
    assert {"trajectory", "lap_s", "warm_up", "check", "trace"} <= set(mix)
    assert limits and all(v > 0 for v in limits.values())
    e2e = {m["name"] for m in harness.metric_names(workload, "end_to_end")}
    assert {"setup_s", "meas_per_s", "frame_ms_p99", "peak_mem_mib"} <= e2e


def test_readers_found_by_name():
    names = [m["name"] for m in bench()["per_layer"]]
    readers = harness.load_readers(names)
    empty = harness.Traced()
    for name, reader in readers.items():
        assert reader.read(empty) is None, name   # nothing to read


def test_config_overrides_apply():
    from livo_bench.ref.config import load_config
    _, config, _, _ = harness.cell_spec("r3live_odom.livo")
    cfg = harness.make_config(config, load_config)
    assert cfg.shapes.map_capacity == 1 << 18       # the port's default
    assert cfg.retry_wider_neighborhood and cfg.cache_association
    assert cfg.odometry_options.init_num_frames == 20


def _out(trace):
    t = harness.Traced(
        timer_calls=[(0, "lio_step", 0.01), (0, "prepare_sweep", 0.001),
                     (1, "lio_step", 0.03)],
        step_stages=[{"iekf": 4.0}], roofline=[(0.1, 0.2)], busy_s=0.6,
        window_s=1.0, breakdown={"device_ops": [["k", 0.5]],
                                 "idle_gaps": [["idle host", 0.1]]})
    return {"correct": True, "attempted": 200, "failed": 0, "setup_s": 40.0,
            "completed": 199, "latencies": [0.03] * 198 + [0.5, 0.9],
            "peak_reserved": 2 ** 30, "traced": t if trace else
            harness.Traced(), "numbers": {"pose_m": 1e-6},
            "limits": {"pose_m": 1e-4}}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    line = run.result_line("r3live_odom.livo", trace, 10.0, _out(trace),
                           "NVIDIA H100 80GB HBM3")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "check"] if trace else ["check"]
    assert list(line) == keys
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 2 ** 30
    assert ("busy_s" in dev) == trace and ("window_s" in dev) == trace
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert line["check"]["pose_m"] == {"value": 1e-6, "limit": 1e-4}
    json.dumps(line, allow_nan=False)


def test_rate_and_tail_over_all_frames():
    line = run.result_line("r3live_odom.livo", False, 10.0, _out(False),
                           "card")
    m = line["metrics"]
    assert m["meas_per_s"]["value"] == pytest.approx(19.9)
    # 200 frames: the 99th percentile is the 198th smallest; the two slow
    # frames lie beyond it
    assert m["frame_ms_p99"]["value"] == pytest.approx(30.0)
    assert m["peak_mem_mib"]["value"] == 1024.0
    lat = list(range(1, 1001))
    assert harness.percentile(lat, 99.0) == 990
    assert harness.percentile(lat, 50.0) == 500
    assert harness.percentile([7.0], 99.0) == 7.0


def test_per_layer_readers_arithmetic():
    line = run.result_line("r3live_odom.livo", True, 10.0, _out(True),
                           "card")
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["lio_step_ms"] == pytest.approx(20.0)
    assert m["host_prep_ms"] == pytest.approx(1.0)
    assert m["iekf_ms"] == 4.0
    assert m["plane_fit.roofline_pct"] == pytest.approx(50.0)
    assert m["device.idle_pct"] == pytest.approx(40.0)
    # vision_frame_ms finds no stage to read and is left out
    assert "vision_frame_ms" not in m


@pytest.fixture(scope="module", params=["livox", "ouster"])
def tiny_traffic(request):
    """The tiny Livox cell's traffic (LiDAR and camera at 10 Hz) or the
    tiny spinning cell's (an Ouster at 20 Hz, the camera at 10 Hz)."""
    from livo_bench.ref.config import load_config
    spec = tiny.spec if request.param == "livox" else tiny.spinning_spec
    wl, config, mix, limits = spec()
    cfg = harness.make_config(config, load_config)
    return traffic.build(mix, cfg.lidar_options, 7, device="cpu"), mix, cfg


def test_lap_replay_stamps_increase(tiny_traffic):
    tr, mix, _ = tiny_traffic
    it = tr.frames()
    frames = [next(it) for _ in range(len(tr.prefix) + 2 * len(tr.lap) + 3)]
    last = {"imu": -1.0, "pts": -1.0, "img": -1.0}
    for f in frames:
        for kind, p in f.events:
            t0 = p[0] if kind != "pts" else p[0, 3]
            t1 = p[0] if kind != "pts" else p[-1, 3]
            assert t0 > last[kind] or (kind == "pts" and t0 >= last[kind])
            if kind == "pts":
                assert np.all(np.diff(p[:, 3]) >= 0)
            last[kind] = t1
    dt = [b.time_image - a.time_image for a, b in zip(frames, frames[1:])]
    assert np.allclose(dt, 0.1)
    # the IMU keeps its 200 Hz grid across the seam
    imu_t = [p[0] for f in frames for k, p in f.events if k == "imu"]
    assert np.allclose(np.diff(imu_t), 1 / 200.0)


def test_lap_seam_is_continuous(tiny_traffic):
    tr, mix, _ = tiny_traffic
    traj = traffic.trajectory(mix["trajectory"])
    t = np.linspace(mix["lap_start_s"], mix["lap_start_s"] + 1.0, 11)
    assert np.allclose(traj.position(t), traj.position(t + tr.lap_s),
                       atol=1e-12)
    for a, b in zip(traj.euler(t), traj.euler(t + tr.lap_s)):
        assert np.allclose(a, b, atol=1e-12)
    # the replayed lap's messages are the lap's, shifted
    it = tr.frames()
    frames = [next(it) for _ in range(len(tr.prefix) + len(tr.lap) + 1)]
    first, again = frames[len(tr.prefix)], frames[-1]
    assert again.time_image == pytest.approx(first.time_image + tr.lap_s)
    for (ka, pa), (kb, pb) in zip(first.events, again.events):
        assert ka == kb
        if ka == "imu":
            assert np.array_equal(pa[1], pb[1])
        if ka == "pts":
            assert np.array_equal(pa[:, :3], pb[:, :3])


def test_seed_changes_noise_not_work(tiny_traffic):
    tr, mix, cfg = tiny_traffic
    other = traffic.build(mix, cfg.lidar_options, 2 ** 31 + 11, device="cpu")
    assert len(other.prefix) == len(tr.prefix)
    assert len(other.lap) == len(tr.lap)
    a = tr.lap[5].events
    b = other.lap[5].events
    assert [k for k, _ in a] == [k for k, _ in b]
    imu_a = [p[1] for k, p in a if k == "imu"]
    imu_b = [p[1] for k, p in b if k == "imu"]
    assert not np.allclose(imu_a, imu_b)


def test_frame_rule_by_hand(tiny_traffic):
    """Frame k holds the LiDAR packets up to and including the first whose
    points pass image k's time, and the IMU samples up to that packet's
    end.  On the Livox cell, whose LiDAR runs at the camera's rate, that
    end is LIDAR_T0 + (k + 2) * lidar_dt: packet k + 1 holds image k."""
    tr, mix, _ = tiny_traffic
    lidar_dt = 1.0 / mix["rates_hz"]["lidar"]
    per_image = round(mix["rates_hz"]["lidar"] / mix["rates_hz"]["camera"])
    frames = tr.prefix + tr.lap
    prev_cut = -1.0
    for k, f in enumerate(frames):
        pkts = [p for kind, p in f.events if kind == "pts"]
        imu_t = [p[0] for kind, p in f.events if kind == "imu"]
        # the packet over image k passes it and ends the frame
        j = int((f.time_image - traffic.LIDAR_T0) / lidar_dt)
        end = traffic.LIDAR_T0 + (j + 1) * lidar_dt
        assert pkts[-1][-1, 3] > f.time_image
        assert all(p[-1, 3] <= f.time_image for p in pkts[:-1])
        assert pkts[-1][0, 3] >= traffic.LIDAR_T0 + j * lidar_dt - 1e-9
        # the IMU is cut 1 ns short of the packet's end (its stamps carry
        # the simulator's summed round-off)
        cut = end - 1e-9
        assert max(imu_t) <= cut and min(imu_t) > prev_cut
        if per_image == 1:
            assert end == pytest.approx(traffic.LIDAR_T0
                                        + (k + 2) * lidar_dt)
        if k:
            # every packet after the previous frame's is handed over
            assert pkts[0][0, 3] >= prev_cut
            assert len(pkts) == per_image
        prev_cut = cut


def test_roofline_pairs_by_entry_within_each_call(monkeypatch):
    """A fake trace: frame 7 calls the step twice, the first call skips the
    retry (one `knn_plane_assoc` traced of the two spied), the second takes
    it; a plane kernel outside the step ranges is left alone; frame 8's
    sampled call finds no step range and is left out; frame 9's search
    mode traces 2 of the 4 `knn_plane_rows` rounds spied."""
    monkeypatch.setattr(harness, "log", lambda msg: None)
    a, r = "void knn_plane_assoc_kernel<20>(...)", "knn_plane_rows_kernel"
    host = [(0.0, 100.0, "livo_bench.frame.7"),
            (1.0, 20.0, harness.STEP_RANGE), (30.0, 60.0, harness.STEP_RANGE),
            (61.0, 90.0, "livo_bench.stage.vision_frame"),
            (100.0, 150.0, "livo_bench.frame.8"),
            (200.0, 300.0, "livo_bench.frame.9"),
            (201.0, 250.0, harness.STEP_RANGE)]
    dev = [(5.0, 7.0, "other"), (8.0, 10.0, a),
           (35.0, 38.0, a), (40.0, 44.0, a), (70.0, 71.0, a),
           (110.0, 111.0, a),
           (210.0, 215.0, r), (220.0, 226.0, r)]
    calls = [(7, [("knn_plane_assoc", 0.1), ("knn_plane_assoc", 0.2)]),
             (7, [("knn_plane_assoc", 0.3), ("knn_plane_assoc", 0.4)]),
             (8, [("knn_plane_assoc", 0.5)]),
             (9, [("knn_plane_rows", 0.6), ("knn_plane_rows", 0.7),
                  ("knn_plane_rows", 0.8), ("knn_plane_rows", 0.9)])]
    got = harness.pair_roofline(calls, dev, host)
    assert got == [(0.1, 2e-3), (0.3, 3e-3), (0.4, 4e-3),
                   (0.6, 5e-3), (0.7, 6e-3)]
    # more kernels traced than spied: the call is left out
    calls[0] = (7, [("knn_plane_assoc", 0.1)])
    host[2] = (1.0, 50.0, harness.STEP_RANGE)
    host[3] = (55.0, 60.0, harness.STEP_RANGE)
    got = harness.pair_roofline(calls[:2], dev, host)
    assert got == []


def test_roofline_bound_hand_count():
    """One occupied voxel of 5 points and one keypoint inside it, no
    neighbour voxels: the bytes are the sectors its probe reads, the
    voxel's key, count and points, and the entry's inputs and outputs."""
    from livo_bench.ref.ops import voxel_map as vm
    vmap = vm.make_map(64, 8)
    pts = torch.tensor([[0.1, 0.2, 0.3], [0.2, 0.3, 0.4], [0.3, 0.1, 0.2],
                        [0.4, 0.4, 0.1], [0.5, 0.2, 0.6]])
    vmap, _ = vm.insert(vmap, pts, torch.ones(5, dtype=torch.bool),
                        voxel_size=1.0, min_distance=0.0, max_probe=8)
    assert int((vmap.sig >= 0).sum()) == 1
    assert int(vmap.counts.max()) == 5
    world = torch.tensor([[0.25, 0.25, 0.25]])
    rows = torch.tensor([True])
    kw = {"max_probe": 8, "max_neighbors": 5, "voxel_size": 1.0,
          "nb_voxels": 0}
    ms, by = roofline.fused_bound_ms(vmap, world, rows, 1, kw,
                                     "knn_plane_assoc")
    # one probe of one slot: one 32-byte sector; one voxel: key 12 + count
    # 4; its 5 points of 12 bytes; inputs q*(12+1)+4, outputs q*32
    nbytes = 32 + 16 + 60 + (13 + 4) + 32
    ops = 5 * (8 + math.log2(5)) + 150
    want = 1e3 * max(nbytes / roofline.PEAK_BYTES_PER_S,
                     ops / roofline.PEAK_F32_OPS_PER_S)
    assert by == "bytes"
    assert ms == pytest.approx(want)


def test_idle_arithmetic_on_a_fake_trace():
    dev = [(10.0, 20.0, "a"), (15.0, 30.0, "b"), (50.0, 60.0, "a"),
           (90.0, 120.0, "c")]
    busy, gaps = gp.busy(dev, 0.0, 100.0)
    assert busy == pytest.approx(20.0 + 10.0 + 10.0)
    assert gaps == [(0.0, 10.0), (30.0, 50.0), (60.0, 90.0)]
    top = gp.top_ops(dev, 0.0, 100.0)
    assert top[0] == ["a", 20e-6] and top[1] == ["b", 15e-6]
    host = [(0.0, 100.0, "livo_bench.frame.0"), (55.0, 95.0, "copy"),
            (61.0, 62.0, "cudaLaunchKernel")]
    named = gp.idle_gaps(host, gaps, n=2)
    assert named == [["copy", 30e-6], ["livo_bench.frame.0", 20e-6]]
