"""The long-run path's captured programs on the CPU, against their eager
functions and the JAX package.

Six programs, each the counterpart of a jitted JAX function:
`pose_graph.optimize_pose_graph_program` on the dense and on the PCG
solver (one Gauss-Newton iteration replayed `iters` times;
`optimize_pose_graph_dense` / `_pcg`), `ba.windowed_ba_program`
(`windowed_ba`), `loop_closure.verify_closure_program`
(`verify_closure`), `voxel_map.compact_map_program` (`compact_map`) and
`voxel_map.insert_program` (the map rebuild's group insert, `insert`).
On the card each is a CUDA graph replay; on the CPU the same function
runs directly, which is what these tests hold:

  * each program, called in `graphs.capture_form()` (every masked round
    runs, as a capture records it) twice in a row on different inputs of
    one shape (the second through the refilled buffers), gives its eager
    function's bits;
  * each program matches the JAX function on the same inputs at the
    tolerances of tests/test_torch_{pose_graph,ba,loop_closure,eviction,
    backend}.py: poses within 1e-4, the closure against the JAX function
    run op by op within 1e-4 (fitness within one inlier), the compacted
    and the inserted maps exactly;
  * no program's function reads back to the host in capture form
    (tests/test_torch_graphs.py::NoHostReads);
  * `MappingBackend` on a synthetic revisit (keyframes around a room
    twice, odometry drifting): the same edges, closures, optimized
    trajectory, re-anchored state and rebuilt map, bit for bit, run
    plainly and in capture form, with BA runs, verified closures, a
    feedback event and a map rebuild in it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu.parallel import ba as jba
from sr_livo_tpu.parallel import loop_closure as jlc
from sr_livo_tpu.parallel import pose_graph as jpg
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models import eskf as teskf
from sr_livo_tpu_torch.ops import voxel_map as tvm
from sr_livo_tpu_torch.parallel import ba as tba
from sr_livo_tpu_torch.parallel import backend as tbe
from sr_livo_tpu_torch.parallel import loop_closure as tlc
from sr_livo_tpu_torch.parallel import pose_graph as tpg
from sr_livo_tpu_torch.utils import graphs, lie
from tests.test_ba_posegraph import _chain_graph
from tests.test_torch_ba import _window, _world_and_map
from tests.test_torch_graphs import _assert_same_bits, _no_host_reads
from tests.test_torch_loop_closure import _scene
from tests.torch_threads import one_intraop_thread  # noqa: F401

TOL = 1e-4
# the pose-graph cases: a 24-node chain takes the dense solve, a 96-node
# one PCG with 144 CG steps (`optimize_pose_graph`'s front door)
SOLVER_NODES = {"dense": 24, "pcg": 96}


def _gap(t, j) -> float:
    return float(np.abs(t.numpy() - np.asarray(j)).max())


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_program_matches_eager_and_jax(solver):
    n = SOLVER_NODES[solver]
    made = {}
    for seed in (23, 24):
        g = _chain_graph(n=n, drift=0.03, rng=np.random.RandomState(seed))[0]
        tg = convert.pose_graph_from_numpy(g)
        eager = tpg.optimize_pose_graph(tg, iters=4)
        with graphs.capture_form():
            got = tpg.optimize_pose_graph_program(made, tg, iters=4)
        _assert_same_bits(got, eager)
        qj, tj = jpg.optimize_pose_graph(g, iters=4)
        assert _gap(got[0], qj) < TOL and _gap(got[1], tj) < TOL
        # the caller's graph is not the program's buffer
        assert not graphs.same_leaves(got, (tg.q, tg.t))
    (prog,) = made.values()
    assert prog.name == f"pose_graph_{solver}[{n}]"


@pytest.fixture(scope="module")
def ba_scene():
    rng = np.random.RandomState(17)
    world, jmap = _world_and_map(rng)
    return world, jmap, convert.voxel_map_from_numpy(jmap), rng


def test_windowed_ba_program_matches_eager_and_jax(ba_scene):
    world, jmap, tmap, rng = ba_scene
    kw = dict(voxel_size=1.0, min_neighbors=8, iters=2)
    made = {}
    for n_valid in (None, [256, 180, 97, 230]):
        window, q_odo, t_odo, _, _ = _window(world, rng, n_valid=n_valid)
        tw = convert.keyframe_window_from_numpy(window)
        args = (tw, torch.as_tensor(q_odo), torch.as_tensor(t_odo))
        eager = tba.windowed_ba(tmap, *args, **kw)
        with graphs.capture_form():
            got = tba.windowed_ba_program(made, tmap, *args, **kw)
        _assert_same_bits(got, eager)
        qj, tj = jba.windowed_ba(
            jmap, jba.KeyframeWindow(**{k: jnp.asarray(v)
                                        for k, v in window.items()}),
            jnp.asarray(q_odo), jnp.asarray(t_odo), **kw)
        assert _gap(got[0], qj) < TOL and _gap(got[1], tj) < TOL
    (prog,) = made.values()
    # the live map is the program's state, read in place
    assert graphs.same_leaves(prog.state, tmap)


def test_verify_closure_program_matches_eager_and_jax():
    made = {}
    for scene in ("revisit", "wrong_place"):
        args = _scene(scene)
        targs = [torch.as_tensor(np.array(a)) for a in args]
        eager = tlc.verify_closure(*targs)
        with graphs.capture_form():
            got = tlc.verify_closure_program(made, *targs)
        _assert_same_bits(got, eager)
        with jax.disable_jit():
            rj = jlc.verify_closure(*(jnp.asarray(a) for a in args))
        assert _gap(got.q_meas, rj.q_meas) < TOL
        assert _gap(got.t_meas, rj.t_meas) < TOL
        assert abs(float(rj.fitness) - float(got.fitness)) * len(args[2]) \
            <= 1.0
        assert abs(float(rj.t_observability)
                   - float(got.t_observability)) < TOL
        assert abs(float(rj.mean_residual)
                   - float(got.mean_residual)) < TOL
        accepts = (float(got.fitness) >= 0.6
                   and float(got.t_observability) >= 0.15)
        assert accepts == (scene == "revisit")
    assert len(made) == 1


@pytest.fixture(scope="module")
def jax_map():
    """tests/test_torch_eviction.py's map: 3000 voxels of 0.5 m in 2^12
    slots, a load factor of 0.73."""
    rng = np.random.RandomState(8)
    pts = rng.uniform(-12, 12, (6000, 3)).astype(np.float32)
    pts[:, 2] *= 0.05
    m = jvm.make_map(1 << 12, 8)
    m, _ = jvm.insert(m, jnp.asarray(pts), jnp.ones(len(pts), bool),
                      0.5, 0.05, 16)
    return m


def _same_map(tm, jm):
    j = convert.voxel_map_to_numpy(convert.voxel_map_from_numpy(jm))
    t = convert.voxel_map_to_numpy(tm)
    for name in ("keys", "sig", "counts", "point_ids", "points"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)


@pytest.mark.parametrize("distance,max_probe", [(6.0, 16), (100.0, 16),
                                                (100.0, 2)])
def test_compact_map_program_matches_eager_and_jax(jax_map, distance,
                                                   max_probe):
    """In place into the map it is given, twice: at two locations, the
    second map copied into the program's buffers (a map replaced by
    eager code, as a checkpoint load)."""
    made = {}
    for loc in ([2.0, -1.0, 0.3], [-3.0, 4.0, 0.0]):
        loc = np.array(loc, np.float32)
        tm = convert.voxel_map_from_numpy(jax_map)
        eager = tvm.compact_map(tm, torch.as_tensor(loc), distance=distance,
                                max_probe=max_probe)
        with graphs.capture_form():
            got = tvm.compact_map_program(made, tm, torch.as_tensor(loc),
                                          distance=distance,
                                          max_probe=max_probe)
        _assert_same_bits(got, eager)
        j, j_drop = jvm.compact_map_impl(jax_map, jnp.asarray(loc),
                                         distance=distance,
                                         max_probe=max_probe)
        _same_map(got[0], j)
        assert int(got[1]) == int(j_drop)
        if max_probe == 2:
            assert int(got[1]) > 0
    (prog,) = made.values()
    assert graphs.same_leaves(got[0], prog.state)


def test_rebuild_insert_program_matches_eager_and_jax():
    """Two 16-keyframe groups (16 x 256 rows each, padded rows invalid)
    into a 2^12 x 20 map, as `MappingBackend._rebuild_map` inserts them,
    the program's map the one it is given, updated in place."""
    rng = np.random.RandomState(6)
    kw = (0.5, 0.05, 16)           # voxel size, min distance, max probe
    groups = []
    for g in range(2):
        world = rng.uniform(-6, 6, (16 * 256, 3)).astype(np.float32)
        world[:, 2] *= 0.1
        valid = rng.rand(16 * 256) < 0.9
        groups.append((world, valid))
    jm = jvm.make_map(1 << 12, 20)
    eager = tvm.make_map(1 << 12, 20)
    m = tvm.make_map(1 << 12, 20)
    made = {}
    for world, valid in groups:
        jm, _ = jvm.insert(jm, jnp.asarray(world), jnp.asarray(valid), *kw)
        args = (torch.as_tensor(world), torch.as_tensor(valid))
        eager, acc_eager = tvm.insert(eager, *args, *kw)
        with graphs.capture_form():
            got, acc = tvm.insert_program(made, m, *args, *kw)
        _assert_same_bits((got, acc), (eager, acc_eager))
        assert graphs.same_leaves(got, m)
        _same_map(got, jm)
    assert int(tvm.map_size(m)) > 3000


@pytest.fixture(scope="module")
def programs(ba_scene, jax_map):
    """One program of each kind, made on the inputs above, by name."""
    made = {}
    for n in SOLVER_NODES.values():
        g = _chain_graph(n=n, drift=0.03, rng=np.random.RandomState(n))[0]
        tpg.optimize_pose_graph_program(
            made, convert.pose_graph_from_numpy(g), iters=1)
    world, _, tmap, _ = ba_scene
    window, q_odo, t_odo, _, _ = _window(world, np.random.RandomState(2))
    tba.windowed_ba_program(made, tmap,
                            convert.keyframe_window_from_numpy(window),
                            torch.as_tensor(q_odo), torch.as_tensor(t_odo),
                            voxel_size=1.0, iters=2)
    tlc.verify_closure_program(made, *(torch.as_tensor(np.array(a))
                                       for a in _scene("revisit")))
    tm = convert.voxel_map_from_numpy(jax_map)
    tvm.compact_map_program(made, tm, torch.zeros(3), distance=6.0,
                            max_probe=16)
    tvm.insert_program(made, tm, torch.rand(4096, 3) * 8,
                       torch.ones(4096, dtype=torch.bool), 0.5, 0.05, 16)
    return {p.name: p for p in made.values()}


@pytest.mark.parametrize("name", [
    "pose_graph_dense[24]", "pose_graph_pcg[96]", "windowed_ba[4x256]",
    "verify_closure", "compact_map", "map_insert"])
def test_program_reads_nothing_back(name, programs, monkeypatch):
    """Each program's function in capture form, under NoHostReads."""
    _no_host_reads(programs[name], monkeypatch)


# ---------------------------------------------------------------------------
# MappingBackend on a synthetic revisit, plainly and in capture form
# ---------------------------------------------------------------------------

N_KEYFRAMES = 32            # around the room twice: 16 a lap
PAYLOAD = 512


def _room(rng):
    """A floor and four walls of a 12 m room, 3 m high, 170 points a
    square metre."""
    f = rng.uniform(-6, 6, (24000, 2))
    u = rng.uniform(-6, 6, 6000)
    h = rng.uniform(0, 3, 6000)
    return np.concatenate([
        np.c_[f, np.zeros(24000)],
        np.c_[np.full(6000, 6.0), u, h],
        np.c_[np.full(6000, -6.0), u, h],
        np.c_[u, np.full(6000, 6.0), h],
        np.c_[u, np.full(6000, -6.0), h]]).astype(np.float32)


def _revisit_frames():
    """Per keyframe (q, t, world points), the odometry's: true poses on a
    3 m circle (two laps), drifting by 1.5 cm and 0.1 degrees of yaw a
    keyframe; each frame sees 2000 room points within 9 m of it, placed in
    the drifted world."""
    rng = np.random.RandomState(31)
    room = _room(rng)
    frames = []
    for k in range(N_KEYFRAMES):
        a = 2 * np.pi * k / 16
        t_true = np.array([3 * np.cos(a), 3 * np.sin(a), 1.0])
        yaw_drift = np.deg2rad(0.1) * k
        c, s = np.cos(yaw_drift), np.sin(yaw_drift)
        r_d = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        t_d = np.array([0.015 * k, 0.0, 0.0])
        near = np.nonzero(np.linalg.norm(room - t_true, axis=-1) < 9.0)[0]
        seen = room[rng.choice(near, 2000, replace=False)]
        q = lie.exp_so3_quat(torch.tensor([0.0, 0.0, a + np.pi / 2
                                           + yaw_drift])).numpy()
        frames.append((q.astype(np.float32),
                       (r_d @ t_true + t_d).astype(np.float32),
                       (seen @ r_d.T + t_d).astype(np.float32)))
    return frames


class _Pipe:
    """The parts of a pipeline the backend reads: cfg, state, voxel map,
    device."""

    def __init__(self, frames):
        cfg = LivoConfig()
        cfg.shapes.map_capacity = 1 << 14
        cfg.icp.size_voxel_map = 0.6
        self.cfg, self.device = cfg, torch.device("cpu")
        self.state = teskf.init_state()
        self.voxel_map = tvm.make_map(1 << 14, 20)
        for _, _, pts in frames[:16]:
            tvm.insert(self.voxel_map, torch.as_tensor(pts),
                       torch.ones(len(pts), dtype=torch.bool), 0.6, 0.05, 16)


class _Out:
    def __init__(self, q, t, pts):
        self.state = teskf.init_state()._replace(
            q=torch.as_tensor(q), p=torch.as_tensor(t))
        self.summary = type("S", (), {"success": torch.tensor(True)})()
        self.frame_pts_world = torch.as_tensor(pts)
        self.frame_valid = torch.ones(len(pts), dtype=torch.bool)


def _run_backend(frames):
    backend = tbe.MappingBackend(tbe.BackendConfig(
        feedback_to_filter=True, max_keyframe_points=PAYLOAD,
        loop_min_gap=12, loop_check_every_n=4), device="cpu")
    pipe = _Pipe(frames)
    for k, (q, t, pts) in enumerate(frames):
        meas = type("M", (), {"time_image": 0.5 * k})()
        backend.maybe_add_keyframe(pipe, _Out(q, t, pts), meas)
    return backend, pipe


@pytest.fixture(scope="module")
def backend_pair():
    frames = _revisit_frames()
    plain = _run_backend(frames)
    with graphs.capture_form():
        captured = _run_backend(frames)
    return plain, captured


def test_backend_same_with_and_without_capture_form(backend_pair):
    (b0, p0), (b1, p1) = backend_pair
    assert b0.ba_runs == b1.ba_runs >= 4
    assert b0.n_verified == b1.n_verified >= 2
    assert b0.n_loop_closures == b1.n_loop_closures >= 1
    assert b0.n_feedback_applied == b1.n_feedback_applied >= 1
    assert b0.n_map_rebuilds == b1.n_map_rebuilds >= 1
    assert len(b0.edges) == len(b1.edges) > N_KEYFRAMES - 1
    for e0, e1 in zip(b0.edges, b1.edges):
        assert (e0["i"], e0["j"]) == (e1["i"], e1["j"])
        np.testing.assert_array_equal(e0["q"], e1["q"])
        np.testing.assert_array_equal(e0["t"], e1["t"])
    for f0, f1 in zip(b0.keyframes, b1.keyframes):
        np.testing.assert_array_equal(f0.q, f1.q)
        np.testing.assert_array_equal(f0.t, f1.t)
    for a, b in zip(b0.optimized_trajectory(), b1.optimized_trajectory()):
        np.testing.assert_array_equal(a, b)
    _assert_same_bits(p0.state, p1.state)
    _assert_same_bits(p0.voxel_map, p1.voxel_map)
    # every solve ran as a program, the map rebuilt in the pipeline's own
    # buffers
    names = {p.name.split("[")[0] for p in b0.programs.values()}
    assert names == {"windowed_ba", "verify_closure", "pose_graph_dense",
                     "map_insert"}
    for p in b0.programs.values():
        if p.name == "map_insert":
            assert graphs.same_leaves(p.state, p0.voxel_map)
