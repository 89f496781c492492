"""The port's captured programs (sr_livo_tpu_torch.utils.graphs) on the card:
the vision frame program, the LIO step program and the colored-map insert
program as CUDA graph replays.

A CUDA graph exists only on a CUDA device, so these tests skip without
one.  The file imports neither JAX nor the JAX package, so it runs on a
machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_graphs_gpu.py

  * a LIVO run at a small configuration (test_vision_pipeline.py's rig,
    120 x 160 images rendered by the port's simulator on the card) in
    each association mode: every call of each program is replayed, then
    its function run eagerly on clones of the buffers it had; the outputs
    and the state written back are the same bits (no program holds a
    float atomic whose order could differ);
  * the launch counters advance on every replay: `knn_plane_rows`, inside
    the search-mode IEKF update, once per round of its masked loop;
  * a steady sweep's step and colored-map insert make no synchronizing
    call (`torch.cuda.set_sync_debug_mode("error")`);
  * a capture that meets a host read raises, and nothing runs eagerly in
    its place: the state is as it was;
  * a state tensor replaced by eager code is copied into the program's
    buffer before the next replay, a new voxel map (an eviction's
    `compact_map`) among them;
  * the steady step with its IEKF rounds in a WHILE node and its retry in
    an IF node replays to the bits of the masked form and of the eager
    function over sweeps that converge early, run to the bound, take the
    retry and fail, launching only the live rounds; its node bodies hold
    no host, event or allocation node.
"""
import contextlib

import numpy as np
import pytest
import torch

from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models import lio
from sr_livo_tpu_torch.models.odometry import (LioEngine, StepInputs,
                                               WireSweep)
from sr_livo_tpu_torch.models.vision import VisionModule
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.pipeline import LivoPipeline, run_streams
from sr_livo_tpu_torch.runtime import synthetic
from sr_livo_tpu_torch.utils import graphs, lie

pytestmark = pytest.mark.gpu

CAM = (130.0, 130.0, 80.0, 60.0)
SIZE = (120, 160)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def small_cfg(cache_association: bool) -> LivoConfig:
    """test_vision_pipeline.py's configuration."""
    cfg = LivoConfig()
    cfg.odometry_options.voxel_size = 0.2
    cfg.odometry_options.init_voxel_size = 0.2
    cfg.odometry_options.sample_voxel_size = 0.8
    cfg.odometry_options.init_sample_voxel_size = 0.8
    cfg.odometry_options.min_distance_points = 0.05
    cfg.icp.size_voxel_map = 0.6
    cfg.icp.min_number_neighbors = 12
    cfg.shapes.max_sweep_points = 4096
    cfg.shapes.max_frame_points = 4096
    cfg.shapes.max_keypoints = 768
    cfg.shapes.max_imu_samples = 48
    cfg.shapes.map_capacity = 1 << 16
    cfg.shapes.color_capacity = 1 << 16
    cfg.shapes.color_registry = 1 << 17
    cfg.shapes.max_render_points = 1 << 13
    cfg.camera_options.image_width = SIZE[1]
    cfg.camera_options.image_height = SIZE[0]
    cfg.camera_options.image_scale = 1.0
    cfg.camera_options.camera_intrinsic = [
        CAM[0], 0, CAM[2], 0, CAM[1], CAM[3], 0, 0, 1]
    cfg.camera_options.camera_dist_coeffs = [0, 0, 0, 0, 0]
    cfg.map_options.add_point_step = 1
    cfg.extrinsics.extrinsic_R_imu_camera = [0, 0, 1, -1, 0, 0, 0, -1, 0]
    cfg.extrinsics.extrinsic_t_imu_camera = [0.0, 0.0, 0.0]
    cfg.cache_association = cache_association
    return cfg


def _bits(t):
    if t.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return t.contiguous().view(ints[t.element_size()])
    return t


class EveryCall:
    """Within the block, every program call on the card is replayed and
    then its function run eagerly on clones of the buffers it had; the
    calls whose outputs or state differ in any bit go to `differ`."""

    def __init__(self):
        self.calls, self.differ, self.names = 0, [], set()

    def __enter__(self):
        self.orig = graphs.Program.__call__
        check = self

        def call(prog):
            state = graphs.tree_map(torch.clone, prog.state)
            inputs = graphs.tree_map(torch.clone, prog.inputs)
            out = check.orig(prog)
            with graphs.counts_kept():
                new_state, eager_out = prog.fn(state, inputs)
                graphs.refill(state, new_state)
            pairs = zip(graphs.tree_leaves((prog.state, out)),
                        graphs.tree_leaves((state, eager_out)))
            if not all(torch.equal(_bits(a), _bits(b)) for a, b in pairs):
                check.differ.append((prog.name, check.calls))
            check.calls += 1
            check.names.add(prog.name)
            return out
        graphs.Program.__call__ = call
        return self

    def __exit__(self, *exc):
        graphs.Program.__call__ = self.orig


@pytest.fixture(scope="module")
def sim(cuda):
    return synthetic.simulate(duration=6.0, n_azimuth=100, n_rings=12,
                              seed=6, image_size=SIZE, camera=CAM,
                              device="cuda")


@pytest.mark.parametrize("cache", [True, False], ids=["assoc", "search"])
def test_replay_matches_eager_function(cuda, sim, cache):
    cfg = small_cfg(cache)
    vision = VisionModule(cfg, device=cuda)
    plane_fit.reset_launches()
    it0 = lio.counts["iterations"]
    with EveryCall() as check:
        pipe = run_streams(LivoPipeline(cfg, vision=vision, device=cuda),
                           sim)
        torch.cuda.synchronize()
    graphs.settle_counts()
    assert {"vision_frame[remapped=False]", "lio_step[init]",
            "lio_step[steady]", "color_insert"} <= check.names
    assert check.calls > 20 and not check.differ, check.differ
    iterations = lio.counts["iterations"] - it0
    want = ({"knn_plane_assoc": len(pipe.records)} if cache
            else {"knn_plane_rows": iterations})
    assert {k: v for k, v in plane_fit.launches.items() if v} == want
    ts, ps, _ = pipe.trajectory()
    assert np.isfinite(ps).all() and len(vision.stats) > 10


def _scene(cuda, n_key=400):
    """Floor and two walls in a 1 m-voxel map; keypoints drawn from
    them, valid as a prefix."""
    rng = np.random.RandomState(23)
    u = rng.uniform(-6, 6, (4000, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(4000)],
        np.c_[np.full(4000, 6.0), u[:, 0], u[:, 1] * 0.5 + 3],
        np.c_[u[:, 0], np.full(4000, 6.0), u[:, 1] * 0.5 + 3],
    ]).astype(np.float32)
    m = vm.make_map(1 << 14, 20, device=cuda)
    pts = torch.as_tensor(world, device=cuda)
    m, _ = vm.insert(m, pts, torch.ones(len(world), dtype=torch.bool,
                                        device=cuda), 1.0, 0.05, 16)
    keypts = pts[torch.as_tensor(rng.choice(len(world), n_key,
                                            replace=False), device=cuda)]
    valid = torch.arange(n_key, device=cuda) < 350
    return m, keypts, valid


ICP = dict(size_voxel_map=1.0, nb_voxels_visited=1, max_number_neighbors=20,
           min_number_neighbors=12, power_planarity=2.0,
           max_dist_to_plane=0.3, weight_alpha=0.9, weight_neighborhood=0.1,
           max_num_residuals=600, max_probe=16, max_iters=8,
           threshold_translation_norm=1e-3, threshold_orientation_norm=1e-2,
           laser_point_cov=0.001)


def _iekf_program(cuda, vmap, keypts, valid, offset):
    """A program over one whole search-mode IEKF update from a prior at
    `offset`."""
    from sr_livo_tpu_torch.models import eskf
    st = eskf.init_state(device=cuda)
    st = st._replace(p=torch.tensor(offset, device=cuda),
                     cov=torch.eye(17, device=cuda) * 1e-2)
    f = dict(device=cuda)
    inputs = (vmap, keypts, valid, torch.zeros(3, **f), torch.eye(3, **f),
              torch.zeros(3, **f), torch.tensor(1, dtype=torch.int32, **f))

    def fn(prior, inp):
        return prior, lio.iekf_update(prior, *inp, cache_association=False,
                                      **ICP)
    return graphs.Program(fn, st, inputs, name="iekf[search]")


def test_launch_counters_advance_per_replay(cuda):
    vmap, keypts, valid = _scene(cuda)
    prog = _iekf_program(cuda, vmap, keypts, valid, [0.1, -0.05, 0.05])
    rounds = ICP["max_iters"] + 1
    for _ in range(2):
        graphs.settle_counts()
        before = dict(plane_fit.launches), dict(lio.counts)
        _, summary = prog()
        graphs.settle_counts()
        live = int(summary.iterations)
        assert bool(summary.success) and 1 < live < rounds
        # the WHILE node launches the live rounds only, each searching
        # once; the counters count what ran
        assert plane_fit.launches["knn_plane_rows"] - before[0][
            "knn_plane_rows"] == live
        assert lio.counts["iterations"] - before[1]["iterations"] == live
        assert lio.counts["updates"] - before[1]["updates"] == 1
    assert prog.captures == 1 and prog.nodes > 1 and prog.replays == 2


def test_new_map_is_copied_in(cuda, sim):
    """A map that replaces the step program's (an eviction's
    `compact_map`) is copied into the program's buffers; the graph keeps
    its addresses, and the steps go on as on a fresh engine."""
    cfg = small_cfg(True)
    pipe = LivoPipeline(cfg, device=cuda)
    run_streams(pipe, sim)
    (prog,) = [p for k, p in pipe.engine.programs.items()
               if k[0] == "steady"]
    n_captures, keys = prog.captures, pipe.voxel_map.keys
    moved, _ = vm.compact_map(pipe.voxel_map, pipe.state.p, distance=1e4,
                              max_probe=cfg.shapes.map_max_probe)
    assert moved.keys is not keys
    assert torch.equal(moved.counts.sum(), pipe.voxel_map.counts.sum())
    sweep = prog.inputs.sweep
    frame_id = pipe.index_frame
    fresh = LivoPipeline(cfg, device=cuda).engine
    want = fresh.step(graphs.tree_map(torch.clone, pipe.state),
                      graphs.tree_map(torch.clone, moved), sweep, frame_id)
    want = graphs.tree_map(torch.clone, want)
    got = pipe.engine.step(pipe.state, moved, sweep, frame_id)
    assert prog.captures == n_captures and got.voxel_map.keys is keys
    assert torch.equal(got.record, want.record)
    assert torch.equal(got.voxel_map.counts, want.voxel_map.counts)


def test_steady_sweep_makes_no_sync(cuda, sim):
    """A steady sweep's step and its colored-map insert, both captured
    already, under `set_sync_debug_mode("error")`."""
    cfg = small_cfg(True)
    vision = VisionModule(cfg, device=cuda)
    pipe = run_streams(LivoPipeline(cfg, vision=vision, device=cuda), sim)
    (prog,) = [p for k, p in pipe.engine.programs.items()
               if k[0] == "steady"]
    sweep = graphs.tree_map(torch.clone, prog.inputs.sweep)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipe.engine.step(pipe.state, pipe.voxel_map, sweep,
                               pipe.index_frame)
        vision.insert_sweep_points(out.frame_pts_world, out.frame_valid,
                                   out.summary.success, 7.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(out.summary.success)


def test_failed_capture_raises_without_eager_fallback(cuda):
    def fn(state, inputs):
        if bool(state.sum() > 0):            # a host read: not capturable
            return state + inputs, state
        return state - inputs, state
    x = torch.ones(4, device=cuda)
    prog = graphs.Program(fn, x, torch.ones(4, device=cuda), name="bad")
    with pytest.raises(RuntimeError):
        prog()
    torch.cuda.synchronize()
    assert prog.graph is None and prog.replays == 0
    assert x.tolist() == [1.0] * 4          # nothing ran in its place
    # the stream is out of capture mode: the card still works
    assert (x * 2).sum().item() == 8.0


def test_replaced_state_is_copied_before_the_replay(cuda):
    """An eager replacement of a state tensor (a checkpoint load) is
    copied into the buffer; the graph keeps its addresses and replays on
    the new values."""
    def fn(state, inputs):
        return state * 2 + inputs, state.sum()
    buf = torch.ones(3, device=cuda)
    prog = graphs.Program(fn, buf, torch.zeros(3, device=cuda), name="t")
    prog()
    assert buf.tolist() == [2.0] * 3
    replaced = torch.full((3,), 5.0, device=cuda)   # eager code's new tensor
    assert graphs.refill(prog.state, replaced) == 1
    out = prog()
    assert prog.state is buf and prog.captures == 1 and prog.replays == 2
    assert buf.tolist() == [10.0] * 3 and out.item() == 15.0


VISION_RANGES = ["preprocess", "pyramid", "lk", "f_ransac", "pnp_ransac",
                 "vio_esikf", "vio_photometric", "render", "tracks"]
INSERT_RANGES = ["gate", "claim", "write"]


def _livo(cuda, sim, events: bool, timers=None):
    cfg = small_cfg(True)
    graphs.stage_events(events)
    try:
        vision = VisionModule(cfg, device=cuda)
        pipe = LivoPipeline(cfg, vision=vision, device=cuda)
        if timers is not None:
            pipe.timers = timers
        run_streams(pipe, sim)
    finally:
        graphs.stage_events(False)
    return pipe


def test_stage_events_add_only_their_marks(cuda, sim):
    """The vision frame program captured with stage events off holds the
    graph of one captured with them on, less its marks; the latter's
    `stage_ms` names the nine ranges, and `graphs.stage_log` holds them
    for each of its replays.  The step program with them on counts its
    IEKF's active rounds in the steady phase, at most the rounds it
    counted, all of them launched (and no other), fewer than the rounds
    run in both phases.  The colored-map insert program with them on holds
    its three ranges (gate, claim, write) and no other added node."""
    off = _livo(cuda, sim, False)
    n_log = len(graphs.stage_log())
    graphs.settle_counts()
    active0, run0 = lio.active_rounds.read(), lio.counts["iterations"]
    added0, launched0 = lio.active_rounds.added(), lio.launched_rounds.read()
    on = _livo(cuda, sim, True)
    graphs.settle_counts()
    active, added, run = (lio.active_rounds.read() - active0,
                          lio.active_rounds.added() - added0,
                          lio.counts["iterations"] - run0)
    launched = lio.launched_rounds.read() - launched0
    (p_off,) = off.vision.programs.values()
    (p_on,) = on.vision.programs.values()
    assert p_off.marks == [] and p_off.stage_ms() == {}
    assert p_on.nodes - p_off.nodes == len(p_on.marks) == 10
    ms = p_on.stage_ms()
    assert list(ms) == VISION_RANGES and all(v > 0 for v in ms.values())
    log = [d for name, d in graphs.stage_log()[n_log:] if name == p_on.name]
    # a replay still running at its program's next call is left out
    assert 0 < len(log) <= p_on.replays and log[-1] == ms
    assert all(list(d) == VISION_RANGES for d in log)
    assert 0 < active <= added and active == launched < run
    for key, prog in off.engine.programs.items():
        assert on.engine.programs[key].nodes > prog.nodes
    # the colored-map insert program: its three ranges and nothing else
    assert off.vision.insert_programs.keys() == on.vision.insert_programs.keys()
    for key, prog in off.vision.insert_programs.items():
        p = on.vision.insert_programs[key]
        assert prog.marks == [] and p.nodes - prog.nodes == len(p.marks) == 4
        assert list(p.stage_ms()) == INSERT_RANGES
        log = [d for name, d in graphs.stage_log()[n_log:] if name == p.name]
        assert log and all(list(d) == INSERT_RANGES for d in log)


def test_spans_on_the_card(cuda, sim):
    """Spans on the card: the device stages' intervals, on the host's
    clock, start after their host span opened (the anchor's error aside)
    and follow one another on the stream."""
    from sr_livo_tpu_torch.utils.profiling import StageTimers
    timers = StageTimers(device=cuda, spans=True)
    pipe = _livo(cuda, sim, False, timers)
    n = len(pipe.records)
    spans = timers.read_spans()
    assert sum(s.name == "frame" for s in spans) == n
    dev = [s for s in spans if s.device is not None]
    assert {s.name for s in dev} >= {"upload", "lio_step", "vis_insert",
                                     "noise", "replay", "records"}
    busy, gaps = timers.busy(spans[0].start, spans[-1].end)
    per = timers.per_frame()
    assert busy > 0 and sum(p["device_ms"] for p in per.values()) > 0
    assert len(timers.idle_gaps(spans[0].start, spans[-1].end, n=3)) == 3
    for s in dev:
        a, b = s.device
        assert a <= b and a >= s.start - 50_000        # 50 us
    ends = [s.device for s in sorted(dev, key=lambda s: s.start)]
    assert all(x[1] <= y[0] + 50_000 for x, y in zip(ends, ends[1:]))


@contextlib.contextmanager
def _masked_loops():
    """Within the block, `graphs.while_loop` and `graphs.cond` keep masked
    rounds and both branches (what a capture records over a process
    group): for the capture of the masked form the tests compare with."""
    orig_w, orig_c = graphs.while_loop, graphs.cond
    graphs.while_loop = lambda *a, **k: orig_w(*a, **{**k, "masked": True})
    graphs.cond = lambda *a, **k: orig_c(*a, **{**k, "masked": True})
    try:
        yield
    finally:
        graphs.while_loop, graphs.cond = orig_w, orig_c


def _variants(state, sweep):
    """Priors and sweeps around a steady step: the recorded one, its
    prior moved by 0.1-1.6 m or turned by 2-20 degrees (more rounds, up to
    the bound), its points cut to a half down to 4 (weak solves, the
    retry, too few residuals)."""
    out = [(state, sweep)]
    for dx in (0.1, 0.3, 0.6, 1.0, 1.6):
        out.append((state._replace(p=state.p + torch.tensor(
            [dx, -dx / 2, 0.0], device=state.p.device)), sweep))
    for deg in (2.0, 5.0, 10.0, 20.0):
        half = np.radians(deg) / 2
        turn = torch.tensor([np.cos(half), 0.0, 0.0, np.sin(half)],
                            dtype=state.q.dtype, device=state.q.device)
        out.append((state._replace(q=lie.quat_mul(state.q, turn)), sweep))
    wire = isinstance(sweep, WireSweep)
    valid = sweep.pts_q[:, 3] >= 0 if wire else sweep.pt_valid
    n = int(valid.sum())
    for keep in (n // 2, n // 4, n // 8, n // 16, 4):
        if wire:
            pts = sweep.pts_q.clone()
            pts[keep:, 3] = -1                   # padding from row `keep`
            out.append((state, sweep._replace(pts_q=pts)))
        else:
            cut = sweep.pt_valid.clone()
            cut[keep:] = False
            out.append((state, sweep._replace(pt_valid=cut)))
    return out


def test_conditional_step_matches_masked_and_eager(cuda, sim):
    """The steady step in its conditional form (the IEKF rounds a WHILE
    node, the retry an IF node) replays to the bits of the same step
    captured with masked rounds and of its function run eagerly, over
    sweeps that converge early, run to the bound, take the retry and fail
    on too few residuals.  Its node bodies hold no host, event or
    allocation node; it launches only the live rounds
    (`lio.launched_rounds` equals `lio.active_rounds`) and the retry's
    association only where taken, where the masked form launches every
    round up to the bound (`added()`) and both associations; the launch
    counters, settled, say the same."""
    cfg = small_cfg(True)
    cfg.retry_wider_neighborhood = True
    cfg.icp.min_num_residuals = 40              # cut sweeps solve weakly
    pipe = run_streams(LivoPipeline(cfg, device=cuda), sim)
    (prog,) = [p for k, p in pipe.engine.programs.items()
               if k[0] == "steady"]
    frame_id = pipe.index_frame
    base_state = graphs.tree_map(torch.clone, pipe.state)
    vmap = graphs.tree_map(torch.clone, pipe.voxel_map)
    base_sweep = graphs.tree_map(torch.clone, prog.inputs.sweep)
    bound = cfg.icp.num_iters_icp + 1

    engines = {"conditional": LioEngine(cfg, device=cuda),
               "masked": LioEngine(cfg, device=cuda)}
    eager_fn = engines["conditional"].step_fn("steady")
    cases, seen, counted = set(), [], {f: [0] * 6 for f in engines}
    graphs.stage_events(True)
    try:
        for state, sweep in _variants(base_state, base_sweep):
            prev = ((state.q, state.p), (state.q, state.p))
            ups = lio.counts["updates"]
            with graphs.counts_kept():
                (e_state, e_map), e_out = eager_fn(
                    (graphs.tree_map(torch.clone, state),
                     graphs.tree_map(torch.clone, vmap)),
                    StepInputs(sweep, prev if engines["conditional"]
                               .use_cv_init else None))
                retried = lio.counts["updates"] - ups == 2
            want = e_out._replace(state=e_state, voxel_map=e_map)
            it, ok = int(want.summary.iterations), bool(want.summary.success)
            seen.append((it, ok, retried, int(want.summary.num_residuals)))
            cases |= {name for name, hit in (
                ("early", ok and not retried and it < bound),
                ("bound", it == bound), ("retry", retried),
                ("few", not ok)) if hit}
            for form, engine in engines.items():
                graphs.settle_counts()
                before = (lio.launched_rounds.read(),
                          lio.active_rounds.read(),
                          lio.active_rounds.added(),
                          lio.counts["iterations"], lio.counts["updates"],
                          plane_fit.launches["knn_plane_assoc"])
                with (_masked_loops() if form == "masked"
                      else contextlib.nullcontext()):
                    got = engine.step(graphs.tree_map(torch.clone, state),
                                      graphs.tree_map(torch.clone, vmap),
                                      sweep, frame_id)
                torch.cuda.synchronize()
                graphs.settle_counts()
                after = (lio.launched_rounds.read(),
                         lio.active_rounds.read(),
                         lio.active_rounds.added(),
                         lio.counts["iterations"], lio.counts["updates"],
                         plane_fit.launches["knn_plane_assoc"])
                for i in range(6):
                    counted[form][i] += after[i] - before[i]
                pairs = zip(graphs.tree_leaves(got), graphs.tree_leaves(want))
                assert all(torch.equal(_bits(a), _bits(b))
                           for a, b in pairs), (form, it, ok, retried)
    finally:
        graphs.stage_events(False)
    assert cases == {"early", "bound", "retry", "few"}, seen

    # the host's launch counters, settled, count what the device ran: a
    # round launched, an association per update that ran
    launched, active, added, rounds, updates, assoc = counted["conditional"]
    assert 0 < launched == active == rounds < added
    assert len(seen) < updates == assoc < 2 * len(seen)
    m_launched, m_active, m_added, m_rounds, m_updates, m_assoc = counted[
        "masked"]
    assert m_launched == m_added == m_rounds == added and m_active == active
    assert m_updates == m_assoc == 2 * len(seen)

    (cond_prog,) = engines["conditional"].programs.values()
    (masked_prog,) = engines["masked"].programs.values()
    # the first update's loop, the retry, and the retry's loop
    assert len(cond_prog.bodies) == 3 and not masked_prog.bodies
    allowed = {0, 1, 2, 5, 13}   # kernel, memcpy, memset, empty, conditional
    for body in cond_prog.bodies:
        assert set(graphs.node_types(body)) <= allowed
    captured = cond_prog.nodes + sum(graphs.graph_nodes(b)
                                     for b in cond_prog.bodies)
    assert captured < masked_prog.nodes
