"""CPU tests of the NTU-VIRAL cell `ntu_odom.livo`: its files found by
name, its mix a 16-ring Ouster at twice the camera rate whose every frame
cuts a gap-fill sweep and then the image-aligned one, the colored-map
insert's ranges, and the readers of the insert's two metrics.

    python -m pytest -q livo_bench/tests/test_livo_bench_ntu.py
"""

import copy
import sys
import types

import pytest
import torch

from livo_bench import harness
from livo_bench.gen import traffic
from livo_bench.tests import tiny

CELL = "ntu_odom.livo"
GRAPHS = "sr_livo_tpu_torch.utils.graphs"


def reader(name):
    return harness.load_readers([name])[name]


def test_cell_is_sr_livos_ntu_yaml():
    import yaml
    wl, config, mix, limits = harness.cell_spec(CELL)
    assert wl["config"] == "ntu_odom" and wl["chips"] == 1
    with open(tiny.NTU_YAML) as f:
        assert config["yaml"] == yaml.safe_load(f)
    r3 = harness.cell_spec("r3live_odom.livo")[1]
    assert config["overrides"] == r3["overrides"]
    assert set(config["override_why"]) == set(config["overrides"])
    assert config["reduced"] == []
    assert set(limits) == {"pose_m", "rot_rad", "map_rows", "map_m",
                           "color_rows", "color_m", "track_px", "ate_m"}


def test_mix_is_a_16_ring_ouster_at_twice_the_camera_rate():
    from livo_bench.ref.config import load_config
    _, config, mix, _ = harness.cell_spec(CELL)
    cfg = harness.make_config(config, load_config)
    rates = mix["rates_hz"]
    assert rates["lidar"] == 2 * rates["camera"] == cfg.lidar_options.scan_rate
    assert mix["lidar"] == {"kind": "ouster", "n_az": 512, "n_rings": 16,
                            "ring_stagger": True}
    assert cfg.lidar_options.n_scans == mix["lidar"]["n_rings"]
    assert mix["calib"] == "ntu" and mix["camera"]


def test_every_frame_cuts_a_gap_fill_sweep_then_the_image_aligned_one():
    """A short slice of the mix (its sensor, rates and trajectory; a 0.5 s
    lap, images as stamps only) through the port's sweep cutter, frame by
    frame as the harness hands them over.  On one thread: the ray casting
    would take every core from the tests beside it."""
    from sr_livo_tpu_torch.config import load_config
    from sr_livo_tpu_torch.runtime.measurements import SweepCutter
    _, config, mix, _ = harness.cell_spec(CELL)
    cfg = harness.make_config(config, load_config)
    mix = copy.deepcopy(mix)
    mix.update({"lap_s": 0.5, "lap_start_s": 0.5, "camera": False})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = traffic.build(mix, cfg.lidar_options, 2 ** 31 + 11,
                           device="cpu")
    finally:
        torch.set_num_threads(threads)
    cutter = SweepCutter(cfg.sweep_interval)
    kinds = []
    for f in tr.prefix + tr.lap:
        for kind, payload in f.events:
            if kind == "imu":
                cutter.push_imu(*payload)
            elif kind == "pts":
                cutter.push_points(payload)
            else:
                cutter.push_image(*payload)
        cut = []
        while (m := cutter.get()) is not None:
            cut.append(m)
        kinds.append([m.rendering for m in cut])
        if cut:
            assert cut[-1].time_image == pytest.approx(f.time_image)
    # the first image's frame holds the stream's start
    assert len(kinds) == len(tr.prefix) + len(tr.lap) >= 9
    assert all(k == [False, True] for k in kinds[1:]), kinds


def test_insert_program_marks_gate_claim_write(monkeypatch):
    """In a capture with stage events, the colored-map insert records its
    ranges in order; outside one it records none."""
    from sr_livo_tpu_torch.models.vision import gated_color_insert
    from sr_livo_tpu_torch.ops import color_map as cm
    from sr_livo_tpu_torch.utils import graphs

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass
    monkeypatch.setattr(torch.cuda, "Event", Event)
    cmap = cm.make_color_map(256, 128, 4)
    pts = torch.rand(32, 3) * 4.0
    args = (pts, torch.ones(32, dtype=torch.bool), torch.tensor(True),
            torch.tensor(1.0))
    kw = dict(step=1, voxel_size=0.5, min_distance=0.05, max_probe=8,
              budget=16)
    marks = []
    monkeypatch.setitem(graphs._MARKS, "into", marks)
    gated_color_insert(cmap, *args, **kw)
    assert [name for name, _ in marks] == ["gate", "claim", "write"]
    monkeypatch.setitem(graphs._MARKS, "into", None)
    gated_color_insert(cm.make_color_map(256, 128, 4), *args, **kw)
    assert len(marks) == 3


def window_calls():
    """A warm-up insert, then two frames: a gap-fill sweep's lone insert
    and the rendered sweep's insert inside its vision frame."""
    return [(-1, "color_insert", 0.5), (-1, "vis_insert", 0.5),
            (0, "lio_step", 0.01), (0, "color_insert", 0.002),
            (0, "lio_step", 0.01), (0, "vis_insert", 0.003),
            (1, "lio_step", 0.01), (1, "color_insert", 0.004),
            (1, "lio_step", 0.01), (1, "vis_insert", 0.003)]


def insert_log():
    """Two warm-up replays, then the window's four, with other programs'
    replays between them."""
    ins = [{"gate": 0.1, "claim": c, "write": 0.5} for c in
           (9.0, 9.0, 1.0, 2.0, 3.0, 6.0)]
    vis = ("vision_frame[remapped=True]", {"lk": 4.0})
    step = ("lio_step[steady]", {"iekf": 1.0})
    return [("color_insert", ins[0]), ("color_insert", ins[1]), step,
            ("color_insert", ins[2]), step, ("color_insert", ins[3]), vis,
            step, ("color_insert", ins[4]), step, ("color_insert", ins[5]),
            vis]


def test_color_insert_ms_reads_the_windows_lone_inserts():
    got = reader("color_insert_ms").read(
        harness.Traced(timer_calls=window_calls()))
    assert got == pytest.approx((2.0 + 4.0) / 2)


def test_claim_ms_reads_the_windows_insert_replays(monkeypatch):
    monkeypatch.setitem(sys.modules, GRAPHS, types.SimpleNamespace(
        stage_log=insert_log))
    got = reader("color_insert.claim_ms").read(
        harness.Traced(timer_calls=window_calls()))
    assert got == pytest.approx((1.0 + 2.0 + 3.0 + 6.0) / 4)


@pytest.mark.parametrize("name,graphs,calls", [
    ("color_insert_ms", None, []),                             # untraced
    ("color_insert_ms", None,                                  # no gap-fill
     [(-1, "color_insert", 0.5), (0, "vis_insert", 0.003)]),
    ("color_insert.claim_ms", None, window_calls()),           # not loaded
    ("color_insert.claim_ms", types.SimpleNamespace(), window_calls()),
    ("color_insert.claim_ms",                                  # the CPU
     types.SimpleNamespace(stage_log=lambda: []), window_calls()),
    ("color_insert.claim_ms",                                  # no marks
     types.SimpleNamespace(stage_log=lambda: [("color_insert", {})] * 6),
     window_calls()),
    ("color_insert.claim_ms",                                  # untraced
     types.SimpleNamespace(stage_log=insert_log), [])])
def test_insert_readers_find_nothing(monkeypatch, name, graphs, calls):
    if graphs is None:
        monkeypatch.delitem(sys.modules, GRAPHS, raising=False)
    else:
        monkeypatch.setitem(sys.modules, GRAPHS, graphs)
    assert reader(name).read(harness.Traced(timer_calls=calls)) is None
