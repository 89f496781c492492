"""The port's accuracy gate (sr_livo_tpu_torch.runtime.accuracy_gate)
against the JAX package's script (scripts/accuracy_gate.py) on the CPU.

- The port's bag writer writes the test fixture's bytes
  (tests/rosbag_writer.py), per serializer and for a whole bag.
- The dropout and JPEG bag builders write the JAX script's bytes from
  the same source bag.
- Each profile's configuration (YAML, shape budget, ablation switches,
  weak-solve retry) equals the JAX script's.
- The profiles, flags and bounds are the JAX script's; `gate_checks`
  flips each check between values just inside and just outside its
  bound, in quick and full mode.
- An 8 s bag of the ntu profile (the Ouster-16's 512 x 16 staggered
  rays at 20 Hz, stamp-only images at 10 Hz) replays through both
  packages: within `tests/lockstep.py`, every JAX LIO step and the
  port's step on the same state, map and sweep run the same IEKF updates
  (neighbourhood, success, residual count) and give the same success,
  residual count and iterations; the closed-loop replays cut the same
  frames (stamps, rendering and gap-fill flags bit for bit) and stay
  below the gate's ATE bound.
- `run_profile` runs that bag on the CPU with the record's fields.
- `--device cuda` raises without a card.
"""
import ast
import dataclasses
import importlib.util
import os
import shutil

import numpy as np
import pytest

from sr_livo_tpu import config as jconfig
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.runtime import drivers as jdrivers
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.runtime import accuracy_gate as tgate
from sr_livo_tpu_torch.runtime import bag_writer as tbw
from sr_livo_tpu_torch.runtime import drivers, tum
from tests import rosbag_writer as jbw
from tests.lockstep import Lockstep, port_updates
from tests.test_torch_pipeline import _copy_cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GATE_PATH = os.path.join(REPO, "scripts", "accuracy_gate.py")


@pytest.fixture(scope="module")
def jgate():
    """scripts/accuracy_gate.py as a module (it imports no JAX at module
    level)."""
    spec = importlib.util.spec_from_file_location("jax_accuracy_gate",
                                                  JAX_GATE_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# (a) the bag writer
# ---------------------------------------------------------------------------

def _serializer_args(name, rng):
    n = 37
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    img = rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)
    return {
        "ser_header": (12.345678901,),
        "ser_imu": (3.005, rng.randn(3), rng.randn(3)),
        "ser_livox_custom": (
            7.1, xyz, rng.randint(0, 4, n).astype(np.uint8),
            (np.arange(n) % 6).astype(np.uint8),
            rng.randint(0, 100_000_000, n).astype(np.uint32)),
        "ser_pointcloud2_ouster": (
            0.05, xyz, rng.randint(0, 50_000_000, n).astype(np.uint32),
            (np.arange(n) % 16).astype(np.uint8)),
        "ser_image_rgb8": (1.135, img),
        "ser_compressed_image": (1.135, img),
    }[name]


@pytest.mark.parametrize("name", [
    "ser_header", "ser_imu", "ser_livox_custom", "ser_pointcloud2_ouster",
    "ser_image_rgb8", "ser_compressed_image"])
def test_serializer_bytes_match_the_fixture(name):
    args = _serializer_args(name, np.random.RandomState(3))
    assert getattr(tbw, name)(*args) == getattr(jbw, name)(*args)


@pytest.mark.parametrize("chunk_target,n_chunks", [(64 << 10, 3),
                                                   (8 << 20, 1)])
def test_whole_bag_bytes_match_the_fixture(tmp_path, chunk_target, n_chunks,
                                           monkeypatch):
    """Three topics, uncompressed, over several chunks (a 64 KiB chunk
    target) or one (the default target)."""
    for mod in (tbw, jbw):
        monkeypatch.setattr(mod.BagWriter, "CHUNK_TARGET", chunk_target)
    paths = []
    for mod in (tbw, jbw):
        rng = np.random.RandomState(5)
        path = str(tmp_path / f"{mod.__name__.split('.')[-1]}.bag")
        w = mod.BagWriter(path)
        msgs = []
        for i in range(40):
            t = 0.1 + 0.05 * i
            msgs.append(("/imu", "sensor_msgs/Imu", t,
                         mod.ser_imu(t, np.full(3, i), np.ones(3))))
            if i % 4 == 0:
                img = np.full((32, 40, 3), i, np.uint8)
                msgs.append(("/cam", "sensor_msgs/Image", t,
                             mod.ser_image_rgb8(t, img)))
            if i % 2 == 0:
                xyz = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
                msgs.append(("/lidar", "livox_ros_driver/CustomMsg", t,
                             mod.ser_livox_custom(
                                 t, xyz, np.zeros(300, np.uint8),
                                 np.zeros(300, np.uint8),
                                 np.zeros(300, np.uint32))))
        for m in msgs:
            w.write_message(*m)
        w.close()
        paths.append(path)
    port, fixture = (open(p, "rb").read() for p in paths)
    assert port.count(b"op=\x05") == n_chunks   # chunk records
    assert port == fixture


# ---------------------------------------------------------------------------
# (b) the dropout and JPEG builders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def source_bag(tmp_path_factory):
    """A small r3live-topic bag (IMU, Livox, 48 x 64 RGB8 images at 10 Hz
    over 3 s) with its ground-truth file, written into two directories."""
    rng = np.random.RandomState(8)
    topics = tgate.R3_TOPICS
    dirs = [tmp_path_factory.mktemp(k) for k in ("jax", "port")]
    src = str(dirs[0] / "src.bag")
    w = tbw.BagWriter(src)
    for i in range(600):
        t = 0.005 + i / 200.0
        w.write_message(topics[1], "sensor_msgs/Imu", t,
                        tbw.ser_imu(t, rng.randn(3), rng.randn(3)))
    for i in range(30):
        t = 0.01 + 0.1 * i
        xyz = rng.uniform(-9, 9, (200, 3)).astype(np.float32)
        w.write_message(topics[0], "livox_ros_driver/CustomMsg", t,
                        tbw.ser_livox_custom(
                            t, xyz, np.zeros(200, np.uint8),
                            (np.arange(200) % 6).astype(np.uint8),
                            np.arange(200, dtype=np.uint32) * 1000))
        img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
        w.write_message(topics[2], "sensor_msgs/Image", t + 0.035,
                        tbw.ser_image_rgb8(t + 0.035, img))
    w.close()
    np.savez(src.replace(".bag", "_gt.npz"), gt_times=np.arange(3.0))
    shutil.copy(src, dirs[1])
    shutil.copy(src.replace(".bag", "_gt.npz"), dirs[1])
    return [str(d / "src.bag") for d in dirs]


@pytest.mark.parametrize("builder", ["dropout", "jpeg"])
def test_builders_write_the_jax_scripts_bytes(jgate, source_bag, builder):
    image_topic = tgate.R3_TOPICS[2]

    def build(mod, src):
        if builder == "dropout":
            return mod.build_dropout_bag(src, image_topic, (1.05, 1.95))
        return mod.build_compressed_bag(src, image_topic)
    jax_bag, port_bag = build(jgate, source_bag[0]), build(tgate,
                                                           source_bag[1])
    assert os.path.basename(jax_bag) == os.path.basename(port_bag)
    data = open(port_bag, "rb").read()
    assert data == open(jax_bag, "rb").read()
    assert data != open(source_bag[1], "rb").read()
    assert os.path.exists(port_bag.replace(".bag", "_gt.npz"))
    # a second call finds the cached bag
    assert build(tgate, source_bag[1]) == port_bag


# ---------------------------------------------------------------------------
# (c) the profile configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("yaml_name", ["r3live.yaml", "ntu.yaml"])
@pytest.mark.parametrize("cache,wire", [(True, True), (True, False),
                                        (False, True)])
def test_profile_config_matches_the_jax_script(jgate, yaml_name, cache,
                                               wire):
    path = os.path.join(REPO, "configs", yaml_name)
    jcfg = jconfig.load_config(path)
    jgate._shape_overrides(jcfg)       # and run_profile's settings:
    jcfg.cache_association = cache
    jcfg.wire_quantization = wire
    jcfg.retry_wider_neighborhood = True
    tcfg = tgate.profile_config(path, cache, wire)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


# ---------------------------------------------------------------------------
# (e) profiles, flags and bounds
# ---------------------------------------------------------------------------

def _flags(path: str) -> set:
    tree = ast.parse(open(path).read())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"}


def test_flags_are_the_jax_scripts_plus_device():
    assert _flags(tgate.__file__) == _flags(JAX_GATE_PATH) | {"--device"}


JAX_PROFILES = ["r3live", "r3live_nowire", "r3live_nocache", "ntu",
                "aggressive", "revisit_backend", "dropout",
                "r3live_compressed"]


@pytest.mark.parametrize("quick", [True, False])
def test_profiles_are_the_jax_scripts(tmp_path, monkeypatch, quick):
    """The profile names in the JAX script's order, with its bags,
    topics and switches (bag rendering stubbed)."""
    built = []

    def fake_build(tag, cache, **kw):
        built.append((tag, kw["duration"], kw["traj_kind"], kw["sensor"],
                      kw["seed"]))
        return os.path.join(cache, f"{tag}_{kw['duration']:g}.bag")
    monkeypatch.setattr(tgate, "build_bag", fake_build)
    monkeypatch.setattr(tgate, "build_dropout_bag",
                        lambda src, topic, win: src + f".drop{win}")
    monkeypatch.setattr(tgate, "build_compressed_bag",
                        lambda src, topic: src + ".jpeg")
    n_seeds = 1 if quick else 3
    duration = 12.0 if quick else 60.0
    plan = tgate.gate_profiles(str(tmp_path), duration, n_seeds, quick,
                               device="cpu")
    names = [name for name, _ in plan]
    want = []
    for k in range(n_seeds):
        sfx = "" if k == 0 else f"_s{k}"
        want += [f"r3live{sfx}", f"r3live_nowire{sfx}",
                 f"r3live_nocache{sfx}"]
    want += ["ntu" + ("" if k == 0 else f"_s{k}") for k in range(n_seeds)]
    want += ["aggressive", "revisit_backend"]
    want += [] if quick else ["revisit_backend_180s"]
    want += ["dropout", "r3live_compressed"]
    assert names == want
    assert set(JAX_PROFILES) <= set(names)
    kw = dict(plan)
    assert kw["r3live_nowire"]["wire_quantization"] is False
    assert kw["r3live_nocache"]["cache_association"] is False
    assert kw["revisit_backend"]["with_backend"] is True
    assert kw["ntu"]["topics"] == tgate.NTU_TOPICS
    assert kw["dropout"]["bag"].endswith(
        f".drop({duration * 0.35}, {duration * 0.45})")
    assert kw["r3live_compressed"]["image_type"] == "Compressed"
    assert kw["r3live_compressed"]["topics"][2] == (
        tgate.R3_TOPICS[2] + "/compressed")
    assert ("r3live_agg", min(duration, 30.0), "aggressive", "livox",
            17) in built
    assert ("ntu", duration, "standard_lowyaw", "ouster", 13) in built
    assert all(v["device"] == "cpu" for v in kw.values())


def _record(**over):
    rec = dict(ate_m=0.02, frames=100, registered=100, registered_pct=1.0,
               rendered=100, gap_fill=0, mean_tracks=200.0,
               track_gate_pct=1.0)
    rec.update(over)
    return rec


def _results(quick: bool, n_seeds: int) -> dict:
    """Records on which every check passes with margin."""
    out = {}
    for k in range(n_seeds):
        sfx = "" if k == 0 else f"_s{k}"
        for name in ("r3live", "r3live_nowire", "r3live_nocache", "ntu"):
            out[name + sfx] = _record()
    out["aggressive"] = _record()
    out["revisit_backend"] = _record(loop_closures=3, feedback_applied=3,
                                     ba_runs=5, map_rebuilds=3)
    if not quick:
        out["revisit_backend_180s"] = _record(
            loop_closures=4, feedback_applied=4, ba_runs=9, map_rebuilds=4)
    out["dropout"] = _record(gap_fill=10, rendered=90)
    out["r3live_compressed"] = _record()
    return out


def _set(results, names, field, value):
    for name in names:
        results[name][field] = value


R3_SEEDS3 = ["r3live", "r3live_s1", "r3live_s2"]

# (check, quick, names, field, value just inside, value just outside)
BOUND_CASES = [
    ("ate_standard_mean", False, R3_SEEDS3, "ate_m", 0.0599, 0.06),
    ("ate_standard_mean", False, ["ntu", "ntu_s1", "ntu_s2"], "ate_m",
     0.0599, 0.06),
    ("ate_standard_mean", True, ["r3live_nowire"], "ate_m", 0.1999, 0.2),
    ("ate_standard_every_seed", False, ["r3live_nocache_s2"], "ate_m",
     0.0799, 0.08),
    ("ate_standard_every_seed", False, ["dropout"], "ate_m", 0.0799, 0.08),
    ("ate_standard_every_seed", False, ["r3live_compressed"], "ate_m",
     0.0799, 0.08),
    ("ate_standard_every_seed", True, ["r3live_nocache"], "ate_m", 0.1999,
     0.2),
    ("ate_hard_motion", False, ["aggressive"], "ate_m", 0.0999, 0.1),
    ("ate_hard_motion", False, ["revisit_backend"], "ate_m", 0.0999, 0.1),
    ("ate_hard_motion", True, ["aggressive"], "ate_m", 0.1999, 0.2),
    ("registration_pct", False, ["ntu_s1"], "registered_pct", 0.95, 0.9499),
    ("registration_pct", True, ["dropout"], "registered_pct", 0.9, 0.8999),
    ("registration_pct", True, ["r3live_compressed"], "registered_pct", 0.9,
     0.8999),
    ("vision_design_point_r3live", False, R3_SEEDS3, "mean_tracks", 150.0,
     149.9),
    ("vision_design_point_r3live", False, R3_SEEDS3, "track_gate_pct", 0.9,
     0.8999),
    ("vision_design_point_r3live", True, ["r3live"], "mean_tracks", 60.0,
     59.9),
    ("vision_engaged_all", False, ["ntu"], "mean_tracks", 60.0, 59.9),
    ("vision_engaged_all", True, ["ntu"], "track_gate_pct", 0.6, 0.5999),
    ("cache_ablation_within_bounds", False,
     ["r3live_nocache", "r3live_nocache_s1", "r3live_nocache_s2"], "ate_m",
     0.0599, 0.06),
    ("loop_closure_fed_back", False, ["revisit_backend"], "loop_closures",
     1, 0),
    ("loop_closure_fed_back", False, ["revisit_backend"],
     "feedback_applied", 1, 0),
    ("long_revisit_consistent", False, ["revisit_backend_180s"], "ate_m",
     0.0999, 0.1),
    ("long_revisit_consistent", False, ["revisit_backend_180s"],
     "loop_closures", 2, 1),
    ("gap_fill_exercised", False, ["dropout"], "gap_fill", 1, 0),
    ("gap_fill_exercised", True, ["dropout"], "gap_fill", 1, 0),
    ("compressed_decode_exercised", True, ["r3live_compressed"], "rendered",
     1, 0),
]


@pytest.mark.parametrize("check,quick,names,field,inside,outside",
                         BOUND_CASES,
                         ids=[f"{c[0]}-{'quick' if c[1] else 'full'}-"
                              f"{c[2][-1]}-{c[3]}" for c in BOUND_CASES])
def test_gate_checks_bounds(check, quick, names, field, inside, outside):
    n_seeds = 1 if quick else 3
    results = _results(quick, n_seeds)
    _set(results, names, field, inside)
    report = tgate.gate_report(results, 12.0 if quick else 60.0, quick,
                               n_seeds)
    assert report["checks"][check] is True
    assert report["all_pass"]
    _set(results, names, field, outside)
    assert tgate.gate_checks(results, quick, n_seeds)[check] is False


@pytest.mark.parametrize("check,names,field,value", [
    ("cache_ablation_within_bounds", ["r3live_nocache"], "ate_m", 0.19),
    ("loop_closure_fed_back", ["revisit_backend"], "loop_closures", 0),
])
def test_quick_mode_waives_steady_state_checks(check, names, field, value):
    results = _results(True, 1)
    _set(results, names, field, value)
    assert tgate.gate_checks(results, True, 1)[check] is True


def test_bounds_are_the_jax_scripts():
    assert tgate.bounds(False) == {"bound_m": 0.08, "bound_mean_m": 0.06,
                                   "bound_hard_m": 0.10,
                                   "min_mean_tracks": 150.0}
    assert tgate.bounds(True) == {"bound_m": 0.2, "bound_mean_m": 0.2,
                                  "bound_hard_m": 0.2,
                                  "min_mean_tracks": 60.0}


def test_constants_are_the_jax_scripts(jgate):
    for name in ("R3_SEEDS", "NTU_SEEDS"):
        assert getattr(tgate, name) == getattr(jgate, name)
    for name in ("R3_CALIB", "NTU_CALIB"):
        t, j = getattr(tgate, name), getattr(jgate, name)
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
    for kind in ("standard", "aggressive", "standard_lowyaw", "revisit"):
        t, j = vars(tgate._traj(kind)), vars(jgate._traj(kind))
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    jw, tw = jgate._world(), tgate._world()
    for a, b in zip(jw.rects, tw.rects):
        for f in ("center", "u", "v", "normal"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(jw.rects) == len(tw.rects) == 142


# ---------------------------------------------------------------------------
# (d) an ntu-profile bag through both packages
# ---------------------------------------------------------------------------

NTU_DURATION = 8.0


@pytest.fixture(scope="module")
def ntu_replays(tmp_path_factory):
    """The ntu profile's first seed, 8 s (the 4.5 s still start and 3.5 s
    of motion), with stamp-only 8 x 8 images, replayed through the JAX
    package in lockstep with the port's step and through the port."""
    path = str(tmp_path_factory.mktemp("ntu") / "ntu.bag")
    sim = tgate.simulate_profile(
        duration=NTU_DURATION, image_rate=10.0, traj_kind="standard_lowyaw",
        sensor="ouster", calib=tgate.NTU_CALIB, seed=tgate.NTU_SEEDS[0],
        device="cpu", images=False)
    tgate.write_bag(path, sim, "ouster")
    np.savez(path.replace(".bag", "_gt.npz"), gt_times=sim.gt_times,
             gt_pos=sim.gt_pos, gt_quat=sim.gt_quat)
    tcfg = tgate.profile_config(tgate.NTU_YAML)
    jcfg = _copy_cfg(jconfig.LivoConfig(), tcfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    with Lockstep(tcfg) as lockstep:
        jp = JPipe(jcfg)
        jdrivers.replay_bag(jp, path, jcfg, *tgate.NTU_TOPICS,
                            image_type="RGB8")
    with port_updates() as steps:
        tp = TPipe(tcfg, device="cpu")
        drivers.replay_bag(tp, path, tcfg, *tgate.NTU_TOPICS,
                           image_type=drivers.IMAGE_TYPE_RGB8)
    return sim, jp, tp, lockstep.frames, steps, path


def test_ntu_steps_match_jax_in_lockstep(ntu_replays):
    _sim, jp, _tp, frames, _steps, _path = ntu_replays
    assert len(frames) == len(jp.records) > 80
    assert [f.port_updates for f in frames] == [f.jax_updates
                                                for f in frames]
    assert [f.port for f in frames] == [f.jax for f in frames]
    assert max(f.position_gap for f in frames) < 1e-5


def test_ntu_replay_cuts_like_jax(ntu_replays):
    """Sweep reconstruction: the Ouster's 20 Hz sweeps re-cut at the
    10 Hz image stamps, a gap-fill sweep between two images."""
    sim, jp, tp, frames, steps, _path = ntu_replays
    jr, tr = jp.records, tp.records
    assert len(tr) == len(jr) == len(steps)
    assert [r.time for r in tr] == [r.time for r in jr]
    assert [r.rendering for r in tr] == [r.rendering for r in jr]
    n_fill = sum(not r.rendering for r in tr)
    assert 0.4 * len(tr) < n_fill < 0.6 * len(tr)
    assert [r.success for r in tr] == [r.success for r in jr]
    for pipe in (tp, jp):
        ts, ps, _ = pipe.trajectory()
        ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
        assert ate < tgate.bounds(False)["bound_m"], f"ATE {ate:.4f} m"


def _record_keys(path: str) -> set:
    """The keys `run_profile` gives its record in a source file: those of
    its `out = dict(...)` and of each `out["..."] =`."""
    fn = next(n for n in ast.walk(ast.parse(open(path).read()))
              if isinstance(n, ast.FunctionDef) and n.name == "run_profile")
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "dict"):
            keys |= {k.arg for k in node.keywords}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx,
                                                          ast.Store):
            keys.add(node.slice.value)
    return keys


EXTRA_FIELDS = {"sweeps_images_per_s", "iekf_updates", "iekf_iterations",
                "launches"}


def test_record_fields_are_the_jax_scripts_plus_the_replays():
    jax_keys = _record_keys(JAX_GATE_PATH)
    assert {"ate_m", "wall_s", "loop_closures", "map_rebuilds"} <= jax_keys
    assert _record_keys(tgate.__file__) == jax_keys | EXTRA_FIELDS


def test_run_profile_on_the_ntu_bag(ntu_replays):
    """`run_profile` on the CPU, re-associating every IEKF iteration with
    the backend attached (VisionModule on the stamp-only images): the
    port's replay's frames, the record's fields, IEKF counts, and no
    kernel launch on the CPU."""
    _sim, _jp, tp, _frames, _steps, path = ntu_replays
    rec = tgate.run_profile(tgate.NTU_YAML, path, tgate.NTU_TOPICS, "RGB8",
                            False, True, with_backend=True, device="cpu")
    assert set(rec) == _record_keys(JAX_GATE_PATH) | EXTRA_FIELDS
    assert rec["frames"] == len(tp.records)
    assert rec["gap_fill"] == sum(not r.rendering for r in tp.records)
    assert rec["registered"] == sum(r.success for r in tp.records)
    assert rec["frames"] <= rec["iekf_updates"] <= 2 * rec["frames"]
    assert rec["iekf_iterations"] >= rec["iekf_updates"]
    assert not any(rec["launches"].values())
    assert rec["ate_m"] < tgate.bounds(False)["bound_m"]
    assert rec["ba_runs"] >= 1


# ---------------------------------------------------------------------------
# (f) no card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--quick"], ["--prebuild", "ntu"],
                                  ["--quick", "--device", "cuda"]])
def test_cuda_raises_without_a_card(tmp_path, monkeypatch, argv):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tgate.main(argv + ["--out", str(tmp_path / "gate.json")])
    with pytest.raises(RuntimeError, match="is_available"):
        tgate.run_gate(quick=True, cache=str(tmp_path), device="cuda")
    assert not os.listdir(tmp_path)
