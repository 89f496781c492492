"""The port's spans and device counts (sr_livo_tpu_torch.utils.profiling,
sr_livo_tpu_torch.utils.graphs) on the CPU.

  * with spans off, `StageTimers` records no span, makes no CUDA call
    and reports its stages as before;
  * with spans on a (mocked) CUDA device, the only synchronize is the
    clock's anchor when spans are turned on: no stage waits for the
    device, event pairs are read only once complete, and each device time
    is the anchor's host time plus the elapsed time from the anchor event;
  * a small LIVO run on the CPU gives each frame one root `frame` span,
    whose children carry its id, nest inside it in time and have no
    device interval;
  * the IEKF's active-round count: in capture form every round runs and
    the count adds the rounds that did work, the summary's iterations.
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models import eskf, lio
from sr_livo_tpu_torch.models.vision import VisionModule
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.pipeline import LivoPipeline, run_streams
from sr_livo_tpu_torch.runtime import synthetic
from sr_livo_tpu_torch.utils import graphs, profiling
from sr_livo_tpu_torch.utils.profiling import StageTimers
from tests.test_torch_graphs_gpu import ICP
from tests.torch_threads import one_intraop_thread  # noqa: F401


def _calls(timers):
    """The same stages and spans, nested as the pipeline nests them."""
    with timers.frame_span(3, cut_start=time.perf_counter_ns()):
        with timers.stage("prepare_sweep"):
            pass
        with timers.stage("upload"), timers.on_device():
            pass
        with timers.stage("vision_frame"):
            with timers.stage("replay"), timers.on_device():
                pass
    with timers.stage("records"), timers.on_device():
        pass


class FakeCuda:
    """Stands in for torch.cuda: events on a device clock the test sets
    (`now_ms`), completion the test controls (`done`), and a count of
    every call that waits."""

    def __init__(self):
        self.now_ms, self.done, self.waits = 1000.0, True, []
        fake = self

        class Event:
            made = 0

            def __init__(self, enable_timing=False):
                assert enable_timing
                Event.made += 1
                self.t = None

            def record(self, stream=None):
                self.t = fake.now_ms

            def query(self):
                return fake.done

            def synchronize(self):
                fake.waits.append("event")

            def elapsed_time(self, other):
                assert fake.done, "read before it completed"
                return other.t - self.t

        self.Event = Event

    def synchronize(self, device=None):
        self.waits.append("device")

    @staticmethod
    def current_stream(device=None):
        return "stream"


@pytest.fixture
def fake_cuda(monkeypatch):
    fake = FakeCuda()
    for name in ("Event", "synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    return fake


def test_spans_off_records_nothing_and_reports_as_before(fake_cuda):
    timers = StageTimers(device="cuda")
    _calls(timers)
    assert timers.spans is None and timers.read_spans() == []
    assert fake_cuda.Event.made == 0 and fake_cuda.waits == []
    on = StageTimers(device="cpu", spans=True)
    _calls(on)
    off, rep = timers.report(), on.report()
    assert list(off) == list(rep) == ["prepare_sweep", "records", "replay",
                                      "upload", "vision_frame"]
    assert {k: v["count"] for k, v in off.items()} == {
        k: v["count"] for k, v in rep.items()}
    assert set(off["upload"]) == {"total_s", "count", "mean_ms", "max_ms"}


def test_spans_on_never_wait_and_share_the_clock(fake_cuda):
    timers = StageTimers(device="cuda", spans=True)
    # turning spans on: one synchronize, the anchor event and its host time
    assert fake_cuda.waits == ["device", "event"]
    anchor_ev, anchor_ns = timers._anchor
    assert anchor_ev.t == 1000.0
    made = fake_cuda.Event.made
    fake_cuda.done = False
    with timers.frame_span(7):
        fake_cuda.now_ms = 1002.5
        with timers.stage("lio_step"), timers.on_device():
            fake_cuda.now_ms = 1004.0
        with timers.stage("prepare_sweep"):     # host only
            pass
    # incomplete pairs stay unread; nothing waited
    with timers.frame_span(8):
        pass
    step = timers.spans[1]
    assert step.name == "lio_step" and step.device is None
    assert fake_cuda.waits == ["device", "event"]
    fake_cuda.done = True
    with timers.frame_span(9):                  # read as the frame opens
        pass
    assert step.device == (anchor_ns + 2_500_000, anchor_ns + 4_000_000)
    assert timers.spans[2].device is None       # prepare_sweep
    assert fake_cuda.waits == ["device", "event"]
    # the pair went back to the pool: no event was made after turn-on
    with timers.frame_span(10):
        with timers.stage("replay"), timers.on_device():
            pass
    assert fake_cuda.Event.made == made
    # read-out after the run waits once
    spans = timers.read_spans()
    assert fake_cuda.waits == ["device", "event", "device"]
    assert spans[-1].name == "replay" and spans[-1].device is not None
    trace = timers.chrome_trace()
    dev = [e for e in trace["traceEvents"] if e.get("tid") == 1
           and e["ph"] == "X"]
    assert [e["name"] for e in dev] == ["lio_step", "replay"]
    assert dev[0]["ts"] == pytest.approx(2500.0)
    assert dev[0]["dur"] == pytest.approx(1500.0)


def test_spans_open_no_profiler_range(fake_cuda, monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("a span opened a profiler range")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    timers = StageTimers(device="cuda", spans=True)
    _calls(timers)
    assert [s.name for s in timers.read_spans()] == [
        "frame", "cut", "prepare_sweep", "upload", "vision_frame", "replay",
        "records"]


def _cfg():
    cfg = LivoConfig()
    cfg.odometry_options.voxel_size = 0.2
    cfg.odometry_options.init_voxel_size = 0.2
    cfg.odometry_options.sample_voxel_size = 0.8
    cfg.odometry_options.init_sample_voxel_size = 0.8
    cfg.odometry_options.min_distance_points = 0.05
    cfg.icp.size_voxel_map = 0.6
    cfg.icp.min_number_neighbors = 12
    cfg.shapes.max_sweep_points = 2048
    cfg.shapes.max_frame_points = 2048
    cfg.shapes.max_keypoints = 256
    cfg.shapes.max_imu_samples = 48
    cfg.shapes.map_capacity = 1 << 14
    cfg.shapes.color_capacity = 1 << 14
    cfg.shapes.color_registry = 1 << 15
    cfg.shapes.max_render_points = 1 << 11
    cfg.camera_options.image_width = 80
    cfg.camera_options.image_height = 60
    cfg.camera_options.image_scale = 1.0
    cfg.camera_options.camera_intrinsic = [60.0, 0, 40.0, 0, 60.0, 30.0,
                                           0, 0, 1]
    cfg.camera_options.camera_dist_coeffs = [0, 0, 0, 0, 0]
    cfg.extrinsics.extrinsic_R_imu_camera = [0, 0, 1, -1, 0, 0, 0, -1, 0]
    return cfg


@pytest.fixture(scope="module")
def span_run():
    torch.manual_seed(0)
    cfg = _cfg()
    cfg.odometry_options.init_num_frames = 8     # steady steps too
    sim = synthetic.simulate(duration=5.0, n_azimuth=60, n_rings=8, seed=3,
                             image_size=(60, 80),
                             camera=(60.0, 60.0, 40.0, 30.0), device="cpu")
    pipe = LivoPipeline(cfg, vision=VisionModule(cfg, device="cpu"),
                        device="cpu")
    pipe.timers = StageTimers(device="cpu", spans=True)
    counted = (lio.active_rounds.read(), lio.active_rounds.added(),
               lio.counts["iterations"])
    graphs.stage_events(True)       # the CPU's programs count as they run
    try:
        run_streams(pipe, sim)
    finally:
        graphs.stage_events(False)
    n = len(pipe.records)
    pipe.counted = tuple(b - a for a, b in zip(counted, (
        lio.active_rounds.read(), lio.active_rounds.added(),
        lio.counts["iterations"])))
    return pipe, pipe.timers.read_spans(), n


def test_each_frame_one_root_with_its_children_inside(span_run):
    pipe, spans, n_frames = span_run
    roots = [s for s in spans if s.name == "frame"]
    assert len(roots) == n_frames > 5
    assert len({s.frame for s in roots}) == len(roots)
    assert all(s.parent is None for s in roots)
    by_id = {s.id: s for s in spans}
    names = set()
    for s in spans:
        assert s.device is None                 # no device on the CPU
        assert s.end is not None and s.end >= s.start
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert s.frame == p.frame
        assert p.start <= s.start and s.end <= p.end
        top = p
        while top.parent is not None:
            top = by_id[top.parent]
        assert top.name == "frame"
        names.add(s.name)
    assert {"cut", "prepare_sweep", "upload", "lio_step", "vision_frame",
            "vis_insert", "vis_track", "noise", "refill", "replay",
            "vis_host_prep"} <= names
    # the pose read is a root of its own, after the last frame
    (rec,) = [s for s in spans if s.name == "records"]
    assert rec.parent is None and rec.frame == roots[-1].frame
    assert rec.start >= roots[-1].end


def test_cpu_run_counts_the_steady_steps_rounds(span_run):
    pipe, _, _ = span_run
    active, added, run = pipe.counted
    # the eager loop stops at the flag, so each counted round did work;
    # the init phase's rounds ran but are left out
    assert 0 < active == added < run


def test_vision_stages_nest_as_the_pipeline_nests_them(span_run):
    _, spans, _ = span_run
    by_id = {s.id: s for s in spans}

    def parent(name):
        return {by_id[s.parent].name for s in spans if s.name == name}
    assert parent("vis_insert") == parent("vis_track") == {"vis_step"}
    assert parent("noise") == parent("replay") == {"vis_track"}
    assert parent("upload") == {"frame", "vis_host_prep"}
    assert parent("lio_step") == {"frame"}


def _scene(n_key=400):
    rng = np.random.RandomState(23)
    u = rng.uniform(-6, 6, (4000, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(4000)],
        np.c_[np.full(4000, 6.0), u[:, 0], u[:, 1] * 0.5 + 3],
        np.c_[u[:, 0], np.full(4000, 6.0), u[:, 1] * 0.5 + 3],
    ]).astype(np.float32)
    m = vm.make_map(1 << 14, 20)
    pts = torch.as_tensor(world)
    m, _ = vm.insert(m, pts, torch.ones(len(world), dtype=torch.bool), 1.0,
                     0.05, 16)
    keypts = pts[torch.as_tensor(rng.choice(len(world), n_key,
                                            replace=False))]
    return m, keypts, torch.arange(n_key) < 350


def _update(vmap, keypts, valid):
    st = eskf.init_state()._replace(p=torch.tensor([0.1, -0.05, 0.05]),
                                    cov=torch.eye(17) * 1e-2)
    return lio.iekf_update(st, vmap, keypts, valid, torch.zeros(3),
                           torch.eye(3), torch.zeros(3),
                           torch.tensor(1, dtype=torch.int32),
                           cache_association=False, **ICP)


@pytest.mark.parametrize("form", ["capture", "eager"])
def test_iekf_counts_active_rounds(form):
    scene = _scene()
    rounds = ICP["max_iters"] + 1
    active0, run0 = lio.active_rounds.read(), lio.counts["iterations"]
    added0 = lio.active_rounds.added()
    ctx = (graphs.capture_form() if form == "capture"
           else contextlib.nullcontext())
    with ctx, graphs.counting():
        _, summary = _update(*scene)
    iters = int(summary.iterations)
    assert bool(summary.success) and 1 < iters < rounds
    assert lio.active_rounds.read() - active0 == iters
    # every masked round runs in capture form, and the eager loop stops
    # at the flag; the count keeps the ones that did work
    run = rounds if form == "capture" else iters
    assert lio.counts["iterations"] - run0 == run
    assert lio.active_rounds.added() - added0 == run
    with graphs.counting(), graphs.counting(False):     # left out
        _update(*scene)
    assert lio.active_rounds.added() - added0 == run
    # without counting(), nothing is added
    active1 = lio.active_rounds.read()
    with graphs.capture_form():
        _update(*scene)
    assert lio.active_rounds.read() == active1


def test_cpu_program_counts_only_with_stage_events():
    scene = _scene()
    prog = graphs.Program(lambda st, inp: (st, _update(*inp)[1]),
                          torch.zeros(1), scene, name="iekf")
    before = lio.active_rounds.read()
    summary = prog()
    assert lio.active_rounds.read() == before
    graphs.stage_events(True)
    try:
        summary = prog()
    finally:
        graphs.stage_events(False)
    assert lio.active_rounds.read() - before == int(summary.iterations) > 1


def test_device_count_buffer_made_outside_capture():
    count = graphs.DeviceCount()
    assert count.read() == 0
    with graphs.counting():
        count.add(torch.tensor(True))
        count.add(torch.tensor(3, dtype=torch.int32))
    count.add(torch.tensor(5))                  # not counting
    assert count.read() == 4
    assert count.buffer(torch.device("cpu")).dtype == torch.int32


def test_device_intervals_where_the_caller_declares_them(fake_cuda):
    timers = StageTimers(device="cuda")
    assert timers.on_device() is timers.on_device()      # spans off
    with timers.stage("lio_step"), timers.on_device():
        pass
    assert fake_cuda.Event.made == 0
    timers.start_spans()
    made = fake_cuda.Event.made
    with timers.on_device():                    # no stage open: nothing
        pass
    with timers.frame_span(0):
        with timers.stage("vision_frame"):
            with timers.stage("vis_insert"), timers.on_device():
                pass
            with timers.stage("replay"), timers.on_device():
                pass
    spans = timers.read_spans()
    assert [s.name for s in spans if s.device is not None] == [
        "vis_insert", "replay"]
    assert fake_cuda.Event.made == made


def test_a_feeder_threads_roots_carry_its_frame():
    timers = StageTimers(device="cpu", spans=True)

    def feed():
        for frame in (5, 6):
            with timers.for_frame(frame):
                with timers.stage("prepare_sweep"):
                    with timers.stage("upload"):
                        pass
        with timers.stage("prepare_sweep"):     # no frame on this thread
            pass

    with timers.frame_span(4):
        th = threading.Thread(target=feed)
        th.start()
        th.join()
        with timers.stage("lio_step"):
            pass
    got = [(s.name, s.frame, s.parent) for s in timers.read_spans()]
    assert got == [("frame", 4, None), ("prepare_sweep", 5, None),
                   ("upload", 5, 1), ("prepare_sweep", 6, None),
                   ("upload", 6, 3), ("prepare_sweep", None, None),
                   ("lio_step", 4, 0)]


def _span(i, name, frame, start, end, device=None, parent=None):
    return profiling.Span(i, name, frame, parent, start, end, device)


def test_busy_gaps_and_frames_from_the_intervals():
    ms = 1_000_000
    timers = StageTimers(device="cpu", spans=True)
    timers.spans[:] = [
        _span(0, "frame", 0, 0, 10 * ms),
        _span(1, "lio_step", 0, 1 * ms, 2 * ms, (1 * ms, 5 * ms), 0),
        _span(2, "vision_frame", 0, 2 * ms, 9 * ms, None, 0),
        _span(3, "noise", 0, 2 * ms, 8 * ms, (6 * ms, 7 * ms), 2),
        _span(4, "replay", 0, 8 * ms, 9 * ms, (4 * ms, 9 * ms), 2),
        _span(5, "records", 0, 9 * ms, 10 * ms, (9 * ms, 9 * ms)),
        _span(6, "frame", 1, 12 * ms, 20 * ms),
        _span(7, "lio_step", 1, 12 * ms, 13 * ms, (14 * ms, 18 * ms), 6),
        _span(8, "records", 1, 13 * ms, 19 * ms, (18 * ms, 18 * ms), 6)]
    busy, gaps = timers.busy(0, 20 * ms)
    assert busy == 12 * ms
    assert gaps == [(0, 1 * ms), (9 * ms, 14 * ms), (18 * ms, 20 * ms)]
    # a window's edges cut the intervals
    assert timers.busy(3 * ms, 15 * ms) == (
        7 * ms, [(9 * ms, 14 * ms)])
    assert timers.idle_gaps(0, 20 * ms, n=2) == [
        ("between frames", 5.0), ("records", 2.0)]
    assert timers.idle_gaps(0, 20 * ms)[2] == ("frame", 1.0)
    assert timers.per_frame() == {
        0: {"host_ms": 10.0, "wait_ms": 1.0, "device_ms": 8.0},
        1: {"host_ms": 8.0, "wait_ms": 6.0, "device_ms": 4.0}}


class _Mark:
    def __init__(self, t, done):
        self.t, self.done = t, done

    def query(self):
        return self.done[0]

    def elapsed_time(self, other):
        assert self.done[0], "read before it completed"
        return other.t - self.t


def test_stage_log_reads_completed_replays_in_order(monkeypatch):
    monkeypatch.setattr(graphs, "_STAGE_LOG", [])
    monkeypatch.setattr(graphs, "_UNREAD", [])
    first, second = [True], [False]
    graphs._UNREAD += [
        ("a", [("x", _Mark(0.0, first)), ("y", _Mark(1.5, first)),
               ("end", _Mark(2.0, first))]),
        ("b", [("z", _Mark(3.0, second)), ("end", _Mark(7.0, second))])]
    assert graphs.stage_log() == [("a", {"x": 1.5, "y": 0.5})]
    second[0] = True
    assert graphs.stage_log() == [("a", {"x": 1.5, "y": 0.5}),
                                  ("b", {"z": 4.0})]
    assert graphs._UNREAD == []


def test_pipeline_declares_its_device_work_on_leaves(fake_cuda):
    """A small LIVO run on the CPU with the timers on a (mocked) CUDA
    device: the stages that carry a device interval are the ones that
    enqueue device work, and no such stage holds another."""
    torch.manual_seed(0)
    cfg = _cfg()
    cfg.odometry_options.init_num_frames = 4
    sim = synthetic.simulate(duration=4.0, n_azimuth=60, n_rings=8, seed=3,
                             image_size=(60, 80),
                             camera=(60.0, 60.0, 40.0, 30.0), device="cpu")
    pipe = LivoPipeline(cfg, vision=VisionModule(cfg, device="cpu"),
                        device="cpu")
    pipe.timers = StageTimers(device="cuda", spans=True)
    run_streams(pipe, sim)
    assert pipe.records
    spans = pipe.timers.read_spans()
    by_id = {s.id: s for s in spans}
    dev = [s for s in spans if s.device is not None]
    assert {s.name for s in dev} == {"upload", "lio_step", "vis_insert",
                                     "noise", "refill", "replay", "records"}
    for s in dev:
        p = s.parent
        while p is not None:
            assert by_id[p].device is None, (s.name, by_id[p].name)
            p = by_id[p].parent
    assert fake_cuda.waits.count("device") == 2      # anchor and read-out
