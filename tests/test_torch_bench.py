"""The port's throughput bench (sr_livo_tpu_torch.runtime.bench) against
bench.py on the CPU.

- `make_cfg` field by field, and the camera and image size.
- `load_sim` at a small size (3 s, 40 x 8 rays, 30 x 40 images) against
  the JAX package's numpy `synthetic.simulate` at the same arguments:
  IMU, LiDAR chunks and ground truth byte for byte; the uint8 images at
  most one grey level apart, and only where the float render sits within
  1e-6 of a rounding boundary.  The cache holds bench.py's npz keys, a
  second call reads it back identically, and only the given cache
  directory is read or written.
- `run_bench` with the host-mode calibration on a short run (9 s, small
  shapes): every cut measurement processed exactly once, the records
  equal bit for bit to those of the same measurements fed one by one
  through `_process_measurement`, the median the median of the chunk
  rates.
- `main`'s last stdout line carries exactly the keys of bench.py's final
  `json.dumps` (read from bench.py with `ast`), rounded as it rounds.
- Without a card `main` and `run_bench` raise instead of running on the
  CPU.

The short runs use a small configuration (`small_cfg`: bench.py's
budgets on narrow shapes, 30 x 40 images, 40 tracks, a 2-level 9 px LK
pyramid, 3 frames to the steady phase) so that each takes seconds here.
bench.py is loaded with importlib; its `main` and `load_sim` are never
called (they render the 40 s run and write into the repository's root).
"""
import ast
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from sr_livo_tpu.runtime import synthetic as jsyn
from sr_livo_tpu_torch.models.vision import VisionModule
from sr_livo_tpu_torch.pipeline import LivoPipeline
from sr_livo_tpu_torch.runtime import bench, synthetic
from tests.torch_threads import one_intraop_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH_PATH = os.path.join(REPO, "bench.py")
SMALL_SIM = dict(duration=3.0, n_azimuth=40, n_rings=8, image_size=(30, 40))
# the short run of the accounting and output tests
RUN_CAM = (32.0, 32.0, 20.0, 15.0)
RUN_SIZE = (30, 40)
RUN_SECONDS = 9.0
# float64 renders of the two packages agree to 1e-6
# (test_torch_vision.py::test_simulated_streams_match_jax)
RENDER_ATOL = 1e-6


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  JAX_BENCH_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench_tree():
    with open(JAX_BENCH_PATH) as f:
        return ast.parse(f.read())


def _dict_keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys}


def test_make_cfg_matches_jax(jbench):
    assert (dataclasses.asdict(bench.make_cfg())
            == dataclasses.asdict(jbench.make_cfg()))


def test_camera_and_image_size_match_jax(jbench):
    assert bench.CAM == jbench.CAM and bench.SIZE == jbench.SIZE
    assert (bench.make_cfg().extrinsics.extrinsic_R_imu_camera
            == bench.R_IMU_CAMERA)


# ---------------------------------------------------------------------------
# the simulation and its cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """(port's first load_sim: rendered, port's second: from the cache,
    the JAX package's simulate, the cache directory)."""
    cache_dir = str(tmp_path_factory.mktemp("bench_cache"))
    first = bench.load_sim(**SMALL_SIM, cache_dir=cache_dir, device="cpu")
    second = bench.load_sim(**SMALL_SIM, cache_dir=cache_dir, device="cpu")
    jsim = jsyn.simulate(duration=SMALL_SIM["duration"],
                         n_azimuth=SMALL_SIM["n_azimuth"],
                         n_rings=SMALL_SIM["n_rings"], imu_rate=200.0,
                         seed=3, image_size=SMALL_SIM["image_size"],
                         camera=bench.CAM)
    return first, second, jsim, cache_dir


def test_sim_streams_are_the_jax_ones(sims):
    sim, _, jsim, _ = sims
    assert len(sim.imu) == len(jsim.imu) > 500
    for (t, a, g), (jt, ja, jg) in zip(sim.imu, jsim.imu):
        assert t == jt and a.tobytes() == ja.tobytes() \
            and g.tobytes() == jg.tobytes()
    assert len(sim.lidar_chunks) == len(jsim.lidar_chunks) > 20
    for a, b in zip(sim.lidar_chunks, jsim.lidar_chunks):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for k in ("gt_times", "gt_pos", "gt_quat"):
        a, b = getattr(sim, k), getattr(jsim, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_sim_images_are_the_jax_renders_in_uint8(sims):
    sim, _, jsim, _ = sims
    assert [t for t, _ in sim.images] == [t for t, _ in jsim.images]
    assert len(sim.images) > 20
    for (_, a), (_, f) in zip(sim.images, jsim.images):
        assert a.dtype == np.uint8 and a.shape == (30, 40, 3)
        ref = np.clip(np.round(f * 255.0), 0, 255).astype(np.uint8)
        diff = np.abs(a.astype(np.int16) - ref.astype(np.int16))
        assert diff.max() <= 1
        # where they differ, the JAX render sits at a rounding boundary
        x = f.astype(np.float64)[diff > 0] * 255.0
        edge = np.abs(x - np.floor(x) - 0.5)
        assert np.all(edge <= 255.0 * RENDER_ATOL)


def test_cache_holds_the_jax_bench_keys(sims, jax_bench_tree):
    """bench.py's cache layout (its `save` dict plus one `pts<i>` per
    LiDAR chunk), in one file named by the arguments."""
    sim, _, _, cache_dir = sims
    save = next(n.value for n in ast.walk(jax_bench_tree)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "save")
    want = _dict_keys(save) | {f"pts{i}"
                               for i in range(len(sim.lidar_chunks))}
    assert os.listdir(cache_dir) == [os.path.basename(bench.cache_file(
        cache_dir, SMALL_SIM["duration"], SMALL_SIM["n_azimuth"],
        SMALL_SIM["n_rings"], SMALL_SIM["image_size"]))]
    with np.load(os.path.join(cache_dir, os.listdir(cache_dir)[0])) as z:
        assert set(z.files) == want
        assert z["imgs"].dtype == np.uint8
        assert z["imgs"].shape == (len(sim.images), 30, 40, 3)


def test_second_load_reads_the_cache_back(sims):
    first, second, _, _ = sims
    assert len(first.imu) == len(second.imu)
    for (t, a, g), (t2, a2, g2) in zip(first.imu, second.imu):
        assert t == t2
        np.testing.assert_array_equal(a, a2)
        np.testing.assert_array_equal(g, g2)
    assert len(first.lidar_chunks) == len(second.lidar_chunks)
    for a, b in zip(first.lidar_chunks, second.lidar_chunks):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(first.images) == len(second.images)
    for (t, a), (t2, b) in zip(first.images, second.images):
        assert t == t2 and a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    for k in ("gt_times", "gt_pos", "gt_quat"):
        np.testing.assert_array_equal(getattr(first, k), getattr(second, k))


def test_load_sim_reads_only_its_cache(sims, monkeypatch):
    """A cached load opens the one file of `cache_dir` and nothing of the
    JAX bench's (`.bench_livo_sim_v4.npz` in the repository's root)."""
    _, _, _, cache_dir = sims
    opened = []
    real = np.load
    monkeypatch.setattr(np, "load",
                        lambda path, *a, **k: opened.append(str(path))
                        or real(path, *a, **k))
    bench.load_sim(**SMALL_SIM, cache_dir=cache_dir, device="cpu")
    assert len(opened) == 1
    assert os.path.dirname(opened[0]) == cache_dir
    with open(bench.__file__) as f:
        assert "bench_livo_sim_v4" not in f.read()


def test_cache_file_is_named_by_the_arguments():
    names = {bench.cache_file("d", *args) for args in [
        (40.0, 256, 32, (512, 640)), (20.0, 256, 32, (512, 640)),
        (40.0, 128, 32, (512, 640)), (40.0, 256, 16, (512, 640)),
        (40.0, 256, 32, (30, 40))]}
    assert len(names) == 5
    assert all(os.path.dirname(n) == "d" for n in names)
    assert os.path.relpath(bench.CACHE_DIR, REPO).split(os.sep)[0] == "build"


# ---------------------------------------------------------------------------
# the measurement
# ---------------------------------------------------------------------------

def small_cfg():
    """bench.py's budgets on narrow shapes, 30 x 40 images (camera
    RUN_CAM), 40 tracks, a 2-level 9 px LK pyramid of 3 iterations and 3
    frames to the steady phase."""
    cfg = bench.make_cfg()
    s = cfg.shapes
    s.max_sweep_points, s.max_frame_points, s.max_keypoints = 2048, 2048, 256
    s.max_imu_samples = 48
    s.map_capacity, s.color_capacity, s.color_registry = 1 << 14, 1 << 14, \
        1 << 15
    s.max_render_points, s.max_render_voxels = 1 << 11, 512
    s.lk_pyramid_levels, s.lk_window, s.lk_iterations = 2, 9, 3
    co = cfg.camera_options
    co.image_width, co.image_height = RUN_SIZE[1], RUN_SIZE[0]
    co.camera_intrinsic = [RUN_CAM[0], 0, RUN_CAM[2], 0, RUN_CAM[1],
                           RUN_CAM[3], 0, 0, 1]
    co.max_tracked_points = 40
    cfg.odometry_options.init_num_frames = 3
    return cfg


@pytest.fixture(scope="module")
def run_sim():
    sim = synthetic.simulate(duration=RUN_SECONDS, n_azimuth=40, n_rings=8,
                             imu_rate=200.0, seed=3, image_size=RUN_SIZE,
                             camera=RUN_CAM, device="cpu")
    sim.images = [(t, np.clip(np.round(im * 255.0), 0, 255).astype(np.uint8))
                  for (t, im) in sim.images]
    return sim


@pytest.fixture(scope="module")
def calibrated(run_sim):
    """run_bench with the calibration, and the reference run: the same
    measurements one by one through `_process_measurement`."""
    cfg = small_cfg()
    rec, pipe = bench.run_bench(cfg, run_sim, "cpu")
    ref = LivoPipeline(cfg, vision=VisionModule(cfg, device="cpu"),
                       device="cpu")
    meas = bench.cut_all(ref, run_sim)
    for m in meas:
        ref._process_measurement(m)
    return rec, pipe, ref, meas


def test_every_measurement_runs_exactly_once(calibrated):
    rec, pipe, ref, meas = calibrated
    w = rec["workload"]
    assert w["measurements"] == len(meas)
    assert w["warm_up"] + w["calibration"] + sum(w["chunks"]) == len(meas)
    # 6 bursts of max(len(timed) // 12, 8) measurements, then 4 chunks
    timed = len(meas) - w["warm_up"]
    assert w["calibration"] == 6 * max(timed // 12, 8)
    assert len(w["chunks"]) == 4 and all(w["chunks"])
    assert len(pipe.records) == len(ref.records) > 40
    assert pipe.index_frame == ref.index_frame


def test_records_equal_the_serial_run_bit_for_bit(calibrated):
    _, pipe, ref, _ = calibrated
    for a, b in zip(pipe.records, ref.records):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), f.name


def test_calibration_runs_both_modes_and_takes_the_faster(calibrated):
    rec = calibrated[0]
    cal = rec["calibration_rates"]
    assert set(cal) == {"pipelined", "serial"}
    assert all(r > 0 for r in cal.values())
    assert rec["host_mode"] == max(cal, key=cal.get)
    assert rec["measurement"] == ("median of 4 disjoint chunks, host mode "
                                  "A/B-calibrated on interleaved bursts")


def test_headline_is_the_median_of_the_chunks(calibrated):
    rec = calibrated[0]
    rates = rec["chunk_rates"]
    assert len(rates) == 4 and all(r > 0 for r in rates)
    assert rec["value"] == float(np.median(rates))
    assert rec["best"] == max(rates)
    assert rec["vs_baseline"] == rec["value"] / 30.0
    assert rec["device"] == {"type": "cpu"}


def test_runner_wraps_each_burst_and_chunk(run_sim):
    """`runner` sees the 6 calibration bursts and the 4 chunks, in order,
    and their times are what the record's rates are made of."""
    seen = []

    def runner(name, fn):
        seconds = fn()
        seen.append((name, seconds))
        return seconds
    rec, _ = bench.run_bench(small_cfg(), run_sim, "cpu", runner=runner)
    assert [n for n, _ in seen] == [f"burst{i}" for i in range(6)] + [
        f"chunk{i}" for i in range(4)]
    chunk_s = [s for n, s in seen if n.startswith("chunk")]
    assert rec["chunk_rates"] == [n / s for n, s in
                                  zip(rec["workload"]["chunks"], chunk_s)]


def test_host_mode_is_checked(run_sim):
    with pytest.raises(ValueError):
        bench.run_bench(small_cfg(), run_sim, "cpu", host_mode="threads")


# ---------------------------------------------------------------------------
# the output and the device
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_line_keys(jax_bench_tree):
    """The keys of the dict literal that bench.py's main dumps last."""
    main = next(n for n in jax_bench_tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    dumps = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps"]
    assert len(dumps) == 1 and isinstance(dumps[0].args[0], ast.Dict)
    return _dict_keys(dumps[0].args[0])


@pytest.fixture(scope="module")
def main_output(run_sim):
    """stdout and stderr of main(["--device", "cpu", "--serial"]) on the
    short run."""
    import contextlib
    import io
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "load_sim", lambda **kw: run_sim)
    cfg = small_cfg()
    mp.setattr(bench, "make_cfg", lambda: cfg)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(["--device", "cpu", "--serial"])
    finally:
        mp.undo()
    assert rc == 0
    return out.getvalue(), err.getvalue()


def test_last_line_has_exactly_the_jax_keys(main_output, jax_line_keys):
    line = json.loads(main_output[0].strip().splitlines()[-1])
    assert set(line) == jax_line_keys
    assert line["metric"] == "sweeps_images_per_s"
    assert line["unit"] == "sweeps+images/s"
    assert line["host_mode"] == "serial"
    assert line["calibration_rates"] is None
    assert len(line["chunk_rates"]) == 4
    assert line["measurement"] == ("median of 4 disjoint chunks, host mode "
                                   "serial as given")


def test_last_line_rounds_as_bench_py():
    rec = {"metric": "sweeps_images_per_s", "value": 4.123456,
           "unit": "sweeps+images/s", "vs_baseline": 4.123456 / 30.0,
           "best": 5.55555, "chunk_rates": [3.14159, 4.123456],
           "host_mode": "pipelined",
           "calibration_rates": {"pipelined": 4.4444, "serial": 3.3333},
           "measurement": "m", "workload": {}, "device": {}}
    assert bench.result_line(rec) == {
        "metric": "sweeps_images_per_s", "value": 4.12,
        "unit": "sweeps+images/s", "vs_baseline": 0.137, "best": 5.56,
        "chunk_rates": [3.14, 4.12], "host_mode": "pipelined",
        "calibration_rates": {"pipelined": 4.44, "serial": 3.33},
        "measurement": "m"}


def test_stderr_carries_device_sim_chunks_and_stages(main_output):
    err = main_output[1]
    assert "device: cpu" in err
    assert "sim ready in" in err
    assert "mode serial, chunk rates" in err
    assert "stage breakdown (host ms):" in err and "lio_step" in err \
        and "vision_frame" in err
    assert "calibration" not in err


def test_main_without_a_card_raises(monkeypatch):
    """The default device is cuda: without a card main raises before it
    loads anything, and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    monkeypatch.setattr(bench, "load_sim", lambda **kw: pytest.fail(
        "load_sim called without a card"))
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--pipelined", "--sync"])


def test_run_bench_without_a_card_raises(run_sim):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_bench(small_cfg(), run_sim)
